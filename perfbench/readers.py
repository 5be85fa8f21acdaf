"""Readings that more than one per-layer metric takes (``metrics/<name>.py``
names one of these as its ``read``)."""
from __future__ import annotations

from .flops import attention_core

ATTN_PREFILL = "perfbench.attn.prefill"


def prefill_attention_roofline(r):
    """Share of the roofline of the prefill's attention cores (the calls of
    ``kernels.ops.flash_attention``, ``attention._naive`` and
    ``attention._blocked`` inside ``transformer.prefill``): the least time the
    chip could take for them, each call's larger of its operations over the
    bfloat16 peak and its bytes (q, k, v and o once) over HBM's bandwidth,
    summed, over the device time of the kernels launched inside their ranges,
    in percent.  None without such calls or kernels."""
    calls = [c for c in r.attn_calls if c.phase == "prefill"]
    if r.trace is None or not calls or not r.peaks:
        return None
    spent = r.trace.device_time_under(ATTN_PREFILL)
    if spent <= 0:
        return None
    bound = 0.0
    for c in calls:
        ops, nbytes = attention_core(c.B, c.Hq, c.Hkv, c.S, c.T, c.D, c.causal, c.q_offset,
                                     c.itemsize)
        bound += max(ops / r.peaks["bf16_flops"], nbytes / r.peaks["hbm_bytes"])
    return 100.0 * bound / spent


def prefill_mfu(r):
    """The prefill's share of the chip's bfloat16 peak: the operations the
    window's prefills need (each prompt through the model, the first token
    sampled; `flops.request_flops` with one token) over the prefill samples'
    seconds times the peak, in percent.  None without prefill samples."""
    if not r.prefill_s or not r.peaks:
        return None
    return 100.0 * r.prefill_flops * len(r.prefill_s) / (sum(r.prefill_s)
                                                          * r.peaks["bf16_flops"])
