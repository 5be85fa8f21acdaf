"""Multi-head Latent Attention, MiniCPM3 / DeepSeek-V2 style (counterpart of
``repro/models/mla.py``).

The KV cache holds only the compressed latent (kv_lora_rank) and the shared
RoPE key: 256 + 32 values a token at MiniCPM3's widths.  ``absorb=True`` runs
attention in that latent space (kv_b's key half folded into q, its value half
into the output); otherwise the latent is expanded to per-head keys and
values.  The reference's dispatch holds: ``impl="naive"`` or one query goes
to ``_naive``, anything else to ``_blocked``, so MLA never reaches the flash
kernel.  The cache is written in place, as the attention cache is.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .attention import _blocked, _naive
from .layers import ParamSpec, rms_norm, rope


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    d_model: int
    n_heads: int
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_dim: int = 64
    qk_rope_dim: int = 32
    v_dim: int = 64
    rope_theta: float = 10000.0
    impl: str = "blocked"
    bkv: int = 512
    unroll: bool = False
    compute_dtype: str = "f32"
    absorb: bool = False            # attention in the compressed latent space


def mla_specs(c: MLAConfig, dtype=torch.float32) -> dict:
    d, H = c.d_model, c.n_heads
    return {
        "q_a": ParamSpec((d, c.q_lora_rank), ("embed", None), dtype),
        "q_a_norm": ParamSpec((c.q_lora_rank,), (None,), dtype, init="ones"),
        "q_b": ParamSpec((c.q_lora_rank, H, c.qk_nope_dim + c.qk_rope_dim),
                         (None, "heads", None), dtype),
        "kv_a": ParamSpec((d, c.kv_lora_rank + c.qk_rope_dim), ("embed", None), dtype),
        "kv_a_norm": ParamSpec((c.kv_lora_rank,), (None,), dtype, init="ones"),
        "kv_b": ParamSpec((c.kv_lora_rank, H, c.qk_nope_dim + c.v_dim),
                          (None, "heads", None), dtype),
        "wo": ParamSpec((H, c.v_dim, d), ("heads", None, "embed"), dtype),
    }


def init_mla_cache(c: MLAConfig, batch: int, max_len: int, dtype=torch.bfloat16,
                   device=None) -> dict:
    return {
        "ckv": torch.zeros((batch, max_len, c.kv_lora_rank), dtype=dtype, device=device),
        "k_rope": torch.zeros((batch, max_len, c.qk_rope_dim), dtype=dtype, device=device),
        "idx": 0,
    }


def mla_apply(params: dict, x: torch.Tensor, c: MLAConfig, *,
              positions: Optional[torch.Tensor] = None,
              cache: Optional[dict] = None) -> tuple[torch.Tensor, Optional[dict]]:
    """x: (B, S, d) -> (out (B, S, d), updated cache or None)."""
    B, S, d = x.shape
    H = c.n_heads
    if positions is None:
        base = cache["idx"] if cache is not None else 0
        positions = (base + torch.arange(S, device=x.device))[None, :].expand(B, S)

    cq = rms_norm(x @ params["q_a"].to(x.dtype), params["q_a_norm"].to(x.dtype))
    q = torch.einsum("bsr,rhk->bshk", cq, params["q_b"].to(x.dtype))
    q_nope, q_rope = q[..., :c.qk_nope_dim], q[..., c.qk_nope_dim:]
    q_rope = rope(q_rope, positions, c.rope_theta)

    ckv_full = x @ params["kv_a"].to(x.dtype)
    ckv = rms_norm(ckv_full[..., :c.kv_lora_rank], params["kv_a_norm"].to(x.dtype))
    k_rope_new = rope(ckv_full[..., c.kv_lora_rank:], positions, c.rope_theta)

    kv_len = q_off = new_cache = None
    if cache is not None:
        idx = cache["idx"]
        cc, cr = cache["ckv"], cache["k_rope"]
        cc[:, idx:idx + S] = ckv.to(cc.dtype)
        cr[:, idx:idx + S] = k_rope_new.to(cr.dtype)
        new_cache = {"ckv": cc, "k_rope": cr, "idx": idx + S}
        ckv_use, kr_use = cc.to(x.dtype), cr.to(x.dtype)
        kv_len = idx + S
        q_off = idx
    else:
        ckv_use, kr_use = ckv, k_rope_new

    T = ckv_use.shape[1]
    plain = c.impl == "naive" or S == 1
    if c.absorb:
        # kv_b's key half folded into q, its value half applied after
        # attention; one latent "kv head" shared by every query head
        kv_b = params["kv_b"].to(x.dtype)                       # (r, H, nope+v)
        kb, vb = kv_b[..., :c.qk_nope_dim], kv_b[..., c.qk_nope_dim:]
        q_lat = torch.einsum("bshk,rhk->bshr", q_nope, kb)      # (B, S, H, r)
        qh = torch.cat([q_lat, q_rope], -1).transpose(1, 2)
        kh = torch.cat([ckv_use, kr_use], -1)[:, None]          # (B, 1, T, r+rope)
        vh = ckv_use[:, None]                                   # (B, 1, T, r)
        # _naive/_blocked scale by sqrt(r+rope), the expanded form by
        # sqrt(nope+rope): pre-scale q by their ratio
        fix = ((c.kv_lora_rank + c.qk_rope_dim) ** 0.5
               / (c.qk_nope_dim + c.qk_rope_dim) ** 0.5)
        qh = qh * torch.tensor(fix, dtype=qh.dtype)
        if plain:
            o_lat = _naive(qh, kh, vh, True, kv_len, 0.0, q_off, "bf16")
        else:
            o_lat = _blocked(qh, kh, vh, True, kv_len, c.bkv, 0.0, q_off,
                             compute_dtype="bf16")
        o = torch.einsum("bhsr,rhv->bhsv", o_lat, vb)
    else:
        kv = torch.einsum("btr,rhk->bthk", ckv_use, params["kv_b"].to(x.dtype))
        k_nope, v = kv[..., :c.qk_nope_dim], kv[..., c.qk_nope_dim:]
        k_rope_b = kr_use[:, :, None, :].expand(B, T, H, c.qk_rope_dim)
        qh = torch.cat([q_nope, q_rope], -1).transpose(1, 2)    # (B, H, S, Dq)
        kh = torch.cat([k_nope, k_rope_b], -1).transpose(1, 2)
        vh = v.transpose(1, 2)                                  # (B, H, T, Dv)
        if plain:
            o = _naive(qh, kh, vh, True, kv_len, 0.0, q_off, c.compute_dtype)
        else:
            o = _blocked(qh, kh, vh, True, kv_len, c.bkv, 0.0, q_off,
                         compute_dtype=c.compute_dtype)
    out = torch.einsum("bhsv,hvd->bsd", o, params["wo"].to(x.dtype))
    return out, new_cache
