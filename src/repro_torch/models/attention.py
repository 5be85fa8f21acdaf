"""MHA / GQA attention with a KV cache and three execution impls
(counterpart of ``repro/models/attention.py``):

* ``naive``   — full logits materialized (small shapes / decode)
* ``blocked`` — online softmax over KV blocks in plain PyTorch (a Python loop
                where the reference scans)
* ``flash``   — the hand-written CUDA kernel (``kernels.ops.flash_attention``)

Cross-attention (whisper) = ``kv_override`` + causal=False.  Decode = S==1
against a preallocated cache written at ``cache["idx"]``, in place: the port
updates the cache tensors where the reference returns updated copies.

On a mesh (`launch.mesh`) each rank computes its block of heads: ``wq`` and
``wo`` hold the rank's ``heads``, ``wk`` and ``wv`` its ``kv_heads`` when the
model axis divides them, else all of them, from which the rank reads the kv
heads its query heads use.  The rank's outputs are added over the model axis
after ``wo``.  The cache holds the rank's batch block and kv heads (the
reference's ``cache_axes`` without ``seq_shard``, which no config sets).

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

from ..core.collectives import copy_to, reduce_from
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
    """K/V of ``batch`` rows and ``c.n_kv_heads`` heads (on a mesh the caller
    passes the rank's block of both: the reference's ``constrain`` of the
    cache by ``cache_axes`` is this allocation)."""
    shape = (batch, c.n_kv_heads, max_len, c.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device), "idx": 0}


def _project(x, w):
    """(B, S, d) · (d, H, D) → (B, H, S, D)."""
    return torch.einsum("bsd,dhk->bhsk", x, w.to(x.dtype))


def _qkv(params, xq, xkv, c: AttnConfig, positions, heads_axis, kv_axis):
    """q from ``xq``, k and v from ``xkv``; a norm weight applied to the
    rank's part of the heads enters through ``copy_to``."""
    q = _project(xq, params["wq"])
    k, v = (_project(xkv, params[w]) for w in ("wk", "wv"))
    if c.qk_norm:
        q = rms_norm(q, copy_to(params["q_norm"], heads_axis).to(xq.dtype))
        k = rms_norm(k, copy_to(params["k_norm"], kv_axis).to(xq.dtype))
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


def _kv_for_heads(k: torch.Tensor, c: AttnConfig, heads_axis) -> torch.Tensor:
    """From all ``c.n_kv_heads`` kv heads (replicated over the model axis),
    the ones the rank's query heads read: a whole number of GQA groups, one
    group's kv head, or, when the rank's heads straddle groups unevenly, one
    kv head per query head.  The kv heads enter through ``copy_to``: each
    rank reads a part of them."""
    Hl = c.n_heads // heads_axis.size
    g = c.n_heads // c.n_kv_heads
    q0 = heads_axis.coord * Hl
    k = copy_to(k, heads_axis)
    if Hl % g == 0:
        return k[:, q0 // g:(q0 + Hl) // g]
    if g % Hl == 0:
        return k[:, q0 // g:q0 // g + 1]
    return k[:, torch.arange(q0, q0 + Hl, device=k.device) // g]


def attention(params: dict, x: torch.Tensor, c: AttnConfig, *,
              positions: Optional[torch.Tensor] = None,
              cache: Optional[dict] = None,
              kv_override: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
              causal: bool = True, heads_axis=None,
              kv_axis=None) -> tuple[torch.Tensor, Optional[dict]]:
    """x: (B, S, d).  Returns (out (B, S, d), updated cache or None).
    ``positions`` (B, S) feed RoPE; by default they count on from the cache's
    write index (from 0 without a cache).

    ``heads_axis`` / ``kv_axis``: the mesh axes ``heads`` / ``kv_heads`` are
    split over (`core.partition.split_axis`; None: whole).  x is
    replicated; ``kv_override`` then holds the rank's kv heads when
    ``kv_axis`` is set, else all of them."""
    B, S, d = x.shape
    if positions is None:
        base = cache["idx"] if cache is not None else 0
        positions = (base + torch.arange(S, device=x.device))[None, :].expand(B, S)
    # x feeds the rank's query heads (and its kv heads when they are split)
    xq = copy_to(x, heads_axis)
    if kv_override is not None:
        q = _project(xq, params["wq"])
        if c.qk_norm:
            q = rms_norm(q, copy_to(params["q_norm"], heads_axis).to(x.dtype))
        k, v = kv_override
        kv_len = None
        caus = False
        q_off = None
        new_cache = cache
    else:
        q, k, v = _qkv(params, xq, xq if kv_axis is not None else x, c, positions,
                       heads_axis, kv_axis)
        kv_len = None
        caus = causal
        q_off = None
        new_cache = None
        if cache is not None:
            idx = cache["idx"]
            ck, cv = cache["k"], cache["v"]
            # the reference's constrain(ck, cache_axes): the cache already
            # holds this rank's batch rows and kv heads; nothing moves
            ck[:, :, idx:idx + S] = k.to(ck.dtype)
            cv[:, :, idx:idx + S] = v.to(cv.dtype)
            new_cache = {"k": ck, "v": cv, "idx": idx + S}
            k, v = ck.to(x.dtype), cv.to(x.dtype)
            kv_len = idx + S
            q_off = idx  # queries sit at absolute positions idx..idx+S-1

    if heads_axis is not None and kv_axis is None:
        k, v = _kv_for_heads(k, c, heads_axis), _kv_for_heads(v, c, heads_axis)
    # the reference's constrain(q / o, ("batch", "heads", "seq", "head_dim")):
    # q and o hold the rank's heads already; nothing moves
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
    return reduce_from(out, heads_axis), new_cache
