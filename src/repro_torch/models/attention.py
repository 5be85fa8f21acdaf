"""MHA / GQA attention with a KV cache and three execution impls
(counterpart of ``repro/models/attention.py``):

* ``naive``   — full logits materialized (small shapes / decode)
* ``blocked`` — online softmax over KV blocks in plain PyTorch (a Python loop
                where the reference scans)
* ``flash``   — the hand-written CUDA kernel (``kernels.ops.flash_attention``)

Cross-attention (whisper) = ``kv_override`` + causal=False.  Decode = S==1
against a preallocated cache written at ``cache["idx"]``, in place: the port
updates the cache tensors where the reference returns updated copies.  On one
card the reference's sharding constraints (``constrain``, ``cache_axes``) are
nothing.

``compute_dtype="bf16"`` (the reference's bf16 operands with float32
accumulation) keeps the reference's roundings: q·kᵀ of the operands as they
come (``_naive``) or rounded to bf16 with the scale folded into q in bf16
(``_blocked``), and the probabilities rounded to v's dtype (``_naive``) or to
bf16 (``_blocked``) before P·v.  The products run on the operands' values in
float32, which a product of two bf16 numbers fits exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels import ops as kops
from .layers import ParamSpec, rms_norm, rope

MASK_VALUE = -1e30


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qk_norm: bool = False
    rope_theta: float = 10000.0
    use_rope: bool = True
    impl: str = "blocked"           # naive | blocked | flash
    bkv: int = 512
    logit_softcap: float = 0.0
    seq_shard: bool = False         # long-context: KV seq axis over 'data'
    unroll: bool = False            # analysis mode: unroll the KV-block scan
    compute_dtype: str = "f32"      # f32 (baseline) | bf16 (bf16 operands,
                                    #   f32 accumulation)


def attn_specs(c: AttnConfig, dtype=torch.float32) -> dict:
    d, H, Hkv, D = c.d_model, c.n_heads, c.n_kv_heads, c.head_dim
    sp = {
        "wq": ParamSpec((d, H, D), ("embed", "heads", "head_dim"), dtype),
        "wk": ParamSpec((d, Hkv, D), ("embed", "kv_heads", "head_dim"), dtype),
        "wv": ParamSpec((d, Hkv, D), ("embed", "kv_heads", "head_dim"), dtype),
        "wo": ParamSpec((H, D, d), ("heads", "head_dim", "embed"), dtype),
    }
    if c.qk_norm:
        sp["q_norm"] = ParamSpec((D,), (None,), dtype, init="ones")
        sp["k_norm"] = ParamSpec((D,), (None,), dtype, init="ones")
    return sp


def init_cache(c: AttnConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None) -> dict:
    shape = (batch, c.n_kv_heads, max_len, c.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device), "idx": 0}


def _project(x, w):
    """(B, S, d) · (d, H, D) → (B, H, S, D)."""
    return torch.einsum("bsd,dhk->bhsk", x, w.to(x.dtype))


def _qkv(params, x, c: AttnConfig, positions):
    q, k, v = (_project(x, params[w]) for w in ("wq", "wk", "wv"))
    if c.qk_norm:
        q = rms_norm(q, params["q_norm"].to(x.dtype))
        k = rms_norm(k, params["k_norm"].to(x.dtype))
    if c.use_rope:
        # rope expects (..., S, D); bring seq before head_dim
        q = rope(q.transpose(1, 2), positions, c.rope_theta).transpose(1, 2)
        k = rope(k.transpose(1, 2), positions, c.rope_theta).transpose(1, 2)
    return q, k, v


def _naive(q, k, v, causal: bool, kv_len, softcap: float, q_offset=None,
           compute_dtype: str = "f32"):
    B, Hq, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    g = Hq // Hkv
    if compute_dtype == "bf16":
        # the operands as they come, f32 accumulation; the GQA group folded
        # into the query rows so K is read once per kv head
        qg = q.reshape(B, Hkv, g * S, D)
        s = (qg.float() @ k.float().transpose(-1, -2)) * (D ** -0.5)   # (B,Hkv,gS,T)
        s = s.reshape(B, Hkv, g, S, T)
    else:
        qg = q.reshape(B, Hkv, g, S, D).float()
        s = torch.einsum("bhgsd,bhtd->bhgst", qg, k.float()) * (D ** -0.5)
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    t_ids = torch.arange(T, device=q.device)
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        off = (T - S) if q_offset is None else q_offset
        mask = mask & (t_ids[None, :] <= (torch.arange(S, device=q.device)[:, None] + off))
    if kv_len is not None:
        mask = mask & (t_ids[None, :] < kv_len)
    s = s.masked_fill(~mask, -torch.inf)
    p = torch.softmax(s, dim=-1)
    if compute_dtype == "bf16":
        pg = p.reshape(B, Hkv, g * S, T).to(v.dtype)
        o = (pg.float() @ v.float()).reshape(B, Hkv, g, S, v.shape[-1])
    else:
        o = torch.einsum("bhgst,bhtd->bhgsd", p, v.float())
    return o.reshape(B, Hq, S, v.shape[-1]).to(q.dtype)


def _blocked(q, k, v, causal: bool, kv_len, bkv: int, softcap: float, q_offset=None,
             compute_dtype: str = "f32"):
    """Online softmax over KV blocks (the flash algorithm in plain PyTorch)."""
    B, Hq, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    if T <= bkv:
        return _naive(q, k, v, causal, kv_len, softcap, q_offset, compute_dtype)
    pad = (-T) % bkv
    if pad:
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))
    g = Hq // Hkv
    Dv = v.shape[-1]
    if compute_dtype == "bf16":
        # the reference's cdt = bf16: operands and probabilities rounded to
        # bf16, the scale applied in bf16, products accumulated in float32
        def cdt(t):
            return t.to(torch.bfloat16).float()
        qg = (q.reshape(B, Hkv, g, S, D).to(torch.bfloat16)
              * torch.tensor(D ** -0.5, dtype=torch.bfloat16)).float()
    else:
        def cdt(t):
            return t.float()
        qg = q.reshape(B, Hkv, g, S, D).float() * (D ** -0.5)
    q_ids = torch.arange(S, device=q.device)[:, None]
    acc = torch.zeros((B, Hkv, g, S, Dv), dtype=torch.float32, device=q.device)
    m = torch.full((B, Hkv, g, S, 1), MASK_VALUE, dtype=torch.float32, device=q.device)
    lse = torch.zeros((B, Hkv, g, S, 1), dtype=torch.float32, device=q.device)
    for t0 in range(0, T + pad, bkv):
        s = torch.einsum("bhgsd,bhtd->bhgst", qg, cdt(k[:, :, t0:t0 + bkv]))
        if softcap > 0:
            s = torch.tanh(s / softcap) * softcap
        t_ids = t0 + torch.arange(bkv, device=q.device)[None, :]
        mask = t_ids < T
        if causal:
            off = (T - S) if q_offset is None else q_offset
            mask = mask & (t_ids <= q_ids + off)
        if kv_len is not None:
            mask = mask & (t_ids < kv_len)
        s = s.masked_fill(~mask, MASK_VALUE)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        acc = acc * alpha + torch.einsum("bhgst,bhtd->bhgsd", cdt(p),
                                         cdt(v[:, :, t0:t0 + bkv]))
        lse = lse * alpha + p.sum(-1, keepdim=True)
        m = m_new
    o = acc / lse.clamp_min(1e-30)
    return o.reshape(B, Hq, S, Dv).to(q.dtype)


def attention(params: dict, x: torch.Tensor, c: AttnConfig, *,
              positions: Optional[torch.Tensor] = None,
              cache: Optional[dict] = None,
              kv_override: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
              causal: bool = True) -> tuple[torch.Tensor, Optional[dict]]:
    """x: (B, S, d).  Returns (out (B, S, d), updated cache or None).
    ``positions`` (B, S) feed RoPE; by default they count on from the cache's
    write index (from 0 without a cache)."""
    B, S, d = x.shape
    if positions is None:
        base = cache["idx"] if cache is not None else 0
        positions = (base + torch.arange(S, device=x.device))[None, :].expand(B, S)
    if kv_override is not None:
        q = _project(x, params["wq"])
        if c.qk_norm:
            q = rms_norm(q, params["q_norm"].to(x.dtype))
        k, v = kv_override
        kv_len = None
        caus = False
        q_off = None
        new_cache = cache
    else:
        q, k, v = _qkv(params, x, c, positions)
        kv_len = None
        caus = causal
        q_off = None
        new_cache = None
        if cache is not None:
            idx = cache["idx"]
            ck, cv = cache["k"], cache["v"]
            ck[:, :, idx:idx + S] = k.to(ck.dtype)
            cv[:, :, idx:idx + S] = v.to(cv.dtype)
            new_cache = {"k": ck, "v": cv, "idx": idx + S}
            k, v = ck.to(x.dtype), cv.to(x.dtype)
            kv_len = idx + S
            q_off = idx  # queries sit at absolute positions idx..idx+S-1

    # the reference's dispatch (attention.py:224-231): the kernel only without
    # a cache and for more than one query; flash with a cache takes _naive
    if c.impl == "flash" and S > 1 and kv_len is None:
        o = kops.flash_attention(q, k, v, caus, True)
    elif c.impl == "blocked":
        o = _blocked(q, k, v, caus, kv_len, c.bkv, c.logit_softcap, q_off,
                     compute_dtype=c.compute_dtype)
    else:
        o = _naive(q, k, v, caus, kv_len, c.logit_softcap, q_off,
                   compute_dtype=c.compute_dtype)
    out = torch.einsum("bhsk,hkd->bsd", o, params["wo"].to(x.dtype))
    return out, new_cache
