"""The prefill's share of the chip's peak (Whisper's encoder and the
decoder's prefill), in the cells whose time to first token is
``ttft_ms.audio`` (`perfbench.readers.prefill_mfu`)."""
from perfbench.readers import prefill_mfu as read  # noqa: F401
