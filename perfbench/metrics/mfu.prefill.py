"""The prefill's share of the chip's peak, in the cells whose time to first
token is ``ttft_ms`` (`perfbench.readers.prefill_mfu`)."""
from perfbench.readers import prefill_mfu as read  # noqa: F401
