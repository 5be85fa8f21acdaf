"""Share of the roofline of the prefill's attention cores (Whisper's encoder
through the flash kernel, and the decoder's prefill), in the cells whose time
to first token is ``ttft_ms.audio`` (`perfbench.readers.prefill_attention_roofline`)."""
from perfbench.readers import prefill_attention_roofline as read  # noqa: F401
