"""Share of the roofline of the prefill's attention cores, in the cells whose
time to first token is ``ttft_ms`` (`perfbench.readers.prefill_attention_roofline`)."""
from perfbench.readers import prefill_attention_roofline as read  # noqa: F401
