"""Flash-attention forward: the Hopper kernel and its plain version.

Replaces ``repro/kernels/flash_attention.py`` ``flash_attention_pallas``.  The
kernel is ``flash_attention_kernel`` in ``csrc/kernels.cu``.
``flash_attention`` takes a CPU tensor to the plain version and launches the
kernel for a CUDA tensor, with no fallback.

Both compute, per query row, softmax(q·kᵀ · D^-0.5) · v over the keys the row
sees, in float32, and cast to q's dtype: GQA reads kv head ``h // (Hq/Hkv)``,
the causal mask is ``t ≤ q + (T − S)`` (the decode offset), masked scores are
-1e30 and the denominator has a 1e-30 floor, as in the Pallas kernel.  A row
that sees no key (causal with S > T) is pinned to zeros.  There ``ref.mha``
gives NaN and the Pallas kernel a finite value that depends on its padding;
compare only rows with at least one visible key against either.
"""
from __future__ import annotations

import torch

from . import _build

MAX_HEAD_DIM = 128
MAX_GRID_YZ = 65535          # CUDA's limit on gridDim.y (heads) and gridDim.z (batch)
MASK_VALUE = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True) -> torch.Tensor:
    """What the kernel computes, with the whole (S, T) score matrix at once."""
    B, Hq, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    g = Hq // Hkv
    qg = q.reshape(B, Hkv, g, S, D).float()
    s = torch.einsum("bhgsd,bhtd->bhgst", qg, k.float()) * D ** -0.5
    if causal:
        t_ids = torch.arange(T, device=q.device)
        visible = t_ids[None, :] <= torch.arange(S, device=q.device)[:, None] + (T - S)
        s = s.masked_fill(~visible, MASK_VALUE)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    if causal:
        p = p.masked_fill(~visible, 0.0)    # a row with no visible key sums nothing
    o = torch.einsum("bhgst,bhtd->bhgsd", p, v.float())
    o = o / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return o.reshape(B, Hq, S, D).to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dtype not in _DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.check_cuda_tensor(name, t, q.dtype, 4, q.device)
    B, Hq, S, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k and v must be (B, Hkv, T, D) = ({B}, Hkv, T, {D}), got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    Hkv, T = k.shape[1], k.shape[2]
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"query heads {Hq} must be a multiple of kv heads {Hkv}")
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"head dim must be in [1, {MAX_HEAD_DIM}], got {D}")
    if T == 0:
        raise ValueError("attention over zero keys")
    if Hq > MAX_GRID_YZ or B > MAX_GRID_YZ:
        raise ValueError(f"at most {MAX_GRID_YZ} heads and batch rows, got {Hq} and {B}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Kernel wrapper: q (B, Hq, S, D), k/v (B, Hkv, T, D), float32 or
    bfloat16, contiguous → (B, Hq, S, D) in q's dtype."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal)
    _check(q, k, v)
    out = torch.empty_like(q)
    B, Hq, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    if out.numel():
        _build.launch("flash_attention_launch", q.device, q.data_ptr(), k.data_ptr(),
                      v.data_ptr(), out.data_ptr(), B, Hq, Hkv, S, T, D, int(causal),
                      _DTYPES[q.dtype])
        flash_attention.launches += 1
    return out


flash_attention.launches = 0
