"""Flash-attention forward: the Hopper kernels and their plain versions.

Replaces ``repro/kernels/flash_attention.py`` ``flash_attention_pallas``.  The
kernels are in ``csrc/kernels.cu``: ``flash_attention_tc_kernel`` (bf16 and
fp16, on the tensor cores, with ``flash_attention_combine_kernel`` when the
keys are split) and ``flash_attention_f32_kernel`` (float32, on the CUDA
cores).  ``flash_attention`` takes a CPU tensor to the plain version and
launches a kernel for a CUDA tensor, with no fallback.  Head dims up to
``MAX_HEAD_DIM`` = 256; a larger one raises ``ValueError`` (no registered
config has one).

All compute, per query row, softmax(q·kᵀ · D^-0.5) · v over the keys the row
sees, with float32 scores and sums, and cast to q's dtype: GQA reads kv head
``h // (Hq/Hkv)``, the causal mask is ``t ≤ q + (T − S)`` (the decode offset),
masked scores are -1e30 and the denominator has a 1e-30 floor, as in the
Pallas kernel.  A row that sees no key (causal with S > T) is pinned to zeros.
There ``ref.mha`` gives NaN and the Pallas kernel a finite value that depends
on its padding; compare only rows with at least one visible key against
either.  The tensor-core kernel rounds the probabilities P to the input type
before P·V (the reference multiplies in float32).

Short queries split the keys: ``num_splits`` picks n contiguous ranges of key
tiles (``key_ranges``), a block of the kernel writes the float32 partials
(m, l, acc) of one range (``flash_attention_partial_plain`` is their plain
version), and the combine kernel merges them (``flash_attention_combine_plain``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build

MAX_HEAD_DIM = 256
MAX_GRID_YZ = 65535          # CUDA's limit on gridDim.y (heads) and gridDim.z (batch)
MASK_VALUE = -1e30
ROWS_PER_BLOCK = 128         # query rows of one tensor-core block (two warpgroups)
KEY_TILE = 64                # keys per K/V tile of the tensor-core kernel
MAX_SPLITS = 16
BLOCKS_PER_SM = 2            # blocks of the tensor-core kernel one SM holds at once (DP = 64)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


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


def flash_attention_partial_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                  causal: bool, t_lo: int, t_hi: int):
    """The float32 partials of keys ``t_lo <= t < t_hi``: per row, m = the
    largest visible scaled score (-1e30 if none), l = Σ exp(s − m) and
    acc = Σ exp(s − m) v over the visible keys; (m, l) are (B, Hq, S) and
    acc (B, Hq, S, D)."""
    B, Hq, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    g = Hq // Hkv
    kr, vr = k[:, :, t_lo:t_hi].float(), v[:, :, t_lo:t_hi].float()
    qg = q.reshape(B, Hkv, g, S, D).float()
    s = torch.einsum("bhgsd,bhtd->bhgst", qg, kr) * D ** -0.5
    t_ids = torch.arange(t_lo, t_lo + kr.shape[2], device=q.device)
    visible = (t_ids < T)[None, :].expand(S, -1)
    if causal:
        visible = visible & (t_ids[None, :]
                              <= torch.arange(S, device=q.device)[:, None] + (T - S))
    m = s.new_full(s.shape[:-1], MASK_VALUE)
    if s.shape[-1]:
        m = torch.maximum(m, s.masked_fill(~visible, MASK_VALUE).amax(-1))
    p = torch.exp(s - m[..., None]).masked_fill(~visible, 0.0)
    acc = torch.einsum("bhgst,bhtd->bhgsd", p, vr)
    return m.reshape(B, Hq, S), p.sum(-1).reshape(B, Hq, S), acc.reshape(B, Hq, S, D)


def flash_attention_combine_plain(m: torch.Tensor, l: torch.Tensor,
                                  acc: torch.Tensor) -> torch.Tensor:
    """Merge n splits' partials, m and l (n, ...), acc (n, ..., D):
    Σ exp(m_s − M) acc_s / max(Σ exp(m_s − M) l_s, 1e-30), M = max_s m_s,
    in float32."""
    w = torch.exp(m - m.amax(0))
    den = (w * l).sum(0).clamp_min(1e-30)
    return (w[..., None] * acc).sum(0) / den[..., None]


def key_ranges(T: int, n_split: int) -> list[tuple[int, int]]:
    """The keys each split of the tensor-core kernel takes: contiguous runs of
    whole ``KEY_TILE`` tiles, ceil(tiles / n_split) each; a split past the
    last tile gets an empty range."""
    tiles = -(-T // KEY_TILE)
    per = -(-tiles // n_split)
    return [(min(i * per * KEY_TILE, T), min((i + 1) * per * KEY_TILE, T))
            for i in range(n_split)]


def instance(dtype: torch.dtype, D: int) -> str:
    """The kernel instance a call takes, by shape alone: ``tc<DP>`` (bf16 and
    fp16, the tensor-core kernel at head dim padded to DP = 64, 128 or 256)
    or ``f32_g<G>`` (float32, the CUDA-core kernel with G = 1, 2, 4 or 8 lanes
    a query row, for D up to 32, 64, 128 or 256)."""
    if dtype == torch.float32:
        return f"f32_g{next(g for g in (1, 2, 4, 8) if D <= 32 * g)}"
    return f"tc{next(dp for dp in (64, 128, 256) if D <= dp)}"


def num_splits(B: int, Hq: int, S: int, T: int, sm_count: int, head_dim: int = 64) -> int:
    """Splits of the keys for the tensor-core kernel: as many as keep the
    B · Hq · ceil(S / 128) blocks within one wave of the blocks the card's
    ``sm_count`` SMs hold at once (``BLOCKS_PER_SM`` at DP = 64, one at the
    wider instances, whose shared memory fills an SM; 1 split when the blocks
    alone fill it), at most the number of key tiles and ``MAX_SPLITS``, with
    no split left empty.  ``scripts/flash_splits.py`` times every count."""
    blocks = B * Hq * -(-S // ROWS_PER_BLOCK)
    tiles = -(-T // KEY_TILE)
    per_sm = BLOCKS_PER_SM if head_dim <= 64 else 1
    n = max(1, min(per_sm * sm_count // blocks, tiles, MAX_SPLITS))
    return -(-tiles // -(-tiles // n))


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dtype not in _DTYPES:
        raise TypeError(f"q must be float32, bfloat16 or float16, got {q.dtype}")
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


def _tma_ready(t: torch.Tensor) -> torch.Tensor:
    """TMA reads rows whose byte stride is a multiple of 16 from a 16-byte
    aligned base: pad the head dim with zeros to a multiple of 8 (an explicit
    copy; no config of the repo needs it) and copy a misaligned view."""
    pad = -t.shape[-1] % 8
    if pad:
        return F.pad(t, (0, pad))
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch_tc(q, k, v, causal, n_split, out, scratch=None) -> None:
    """Launch the tensor-core kernel; with n_split > 1 it writes the partials
    into ``scratch`` (float32: m and l (n, B, Hq, S), then acc (n, B, Hq,
    S, D)) and, unless ``out`` is None, the combine kernel merges them into
    ``out``."""
    B, Hq, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    qp, kp, vp = (_tma_ready(t) for t in (q, k, v))
    m = l = acc = None
    if scratch is not None:
        rows = n_split * B * Hq * S
        m = scratch.data_ptr()
        l, acc = m + 4 * rows, m + 8 * rows
    _build.launch("flash_attention_tc_launch", q.device, qp.data_ptr(), kp.data_ptr(),
                  vp.data_ptr(), None if out is None else out.data_ptr(), m, l, acc, B, Hq,
                  Hkv, S, T, D, qp.shape[-1], int(causal), n_split, _DTYPES[q.dtype])


def _scratch(q: torch.Tensor, n_split: int) -> torch.Tensor:
    B, Hq, S, D = q.shape
    return torch.empty(n_split * B * Hq * S * (D + 2), dtype=torch.float32, device=q.device)


def flash_attention_partials(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             causal: bool, n_split: int):
    """Launch the tensor-core kernel in split mode alone, on bf16 or fp16
    CUDA tensors: the float32 partials (m, l, acc) of the
    ``key_ranges(T, n_split)``, shaped (n, B, Hq, S) twice and (n, B, Hq, S, D)."""
    _check(q, k, v)
    if q.dtype == torch.float32:
        raise TypeError("the split path is the bf16/fp16 tensor-core kernel's")
    B, Hq, S, D = q.shape
    scratch = _scratch(q, n_split)
    _launch_tc(q, k, v, causal, n_split, None, scratch)
    rows = n_split * B * Hq * S
    return (scratch[:rows].view(n_split, B, Hq, S), scratch[rows:2 * rows].view(n_split, B, Hq, S),
            scratch[2 * rows:].view(n_split, B, Hq, S, D))


def flash_attention_combine(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
                            dtype: torch.dtype) -> torch.Tensor:
    """Combine kernel wrapper: partials m, l (n, ...) and acc (n, ..., D),
    float32 CUDA tensors → (..., D) in ``dtype`` (float32, bf16 or fp16)."""
    if dtype not in _DTYPES:
        raise TypeError(f"dtype must be float32, bfloat16 or float16, got {dtype}")
    _build.check_cuda_tensor("acc", acc, torch.float32, acc.ndim)
    for name, t in (("m", m), ("l", l)):
        _build.check_cuda_tensor(name, t, torch.float32, acc.ndim - 1, acc.device)
        if t.shape != acc.shape[:-1]:
            raise ValueError(f"{name} must be {tuple(acc.shape[:-1])}, got {tuple(t.shape)}")
    n, D = acc.shape[0], acc.shape[-1]
    out = torch.empty(acc.shape[1:], dtype=dtype, device=acc.device)
    if out.numel():
        _build.launch("flash_attention_combine_launch", acc.device, m.data_ptr(), l.data_ptr(),
                      acc.data_ptr(), out.data_ptr(), n, out.numel() // D, D, _DTYPES[dtype])
        flash_attention.combine_launches += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Kernel wrapper: q (B, Hq, S, D), k/v (B, Hkv, T, D), float32, bfloat16
    or float16, contiguous, D ≤ 256 → (B, Hq, S, D) in q's dtype.

    The instance is chosen by dtype and D alone (`instance`), never by a
    failure: bf16/fp16 take the tensor-core kernel at DP = 64 (D ≤ 64), 128
    (D ≤ 128) or 256 (D ≤ 256), and the combine kernel when ``num_splits`` >
    1; float32 takes the CUDA-core kernel with 1, 2, 4 or 8 lanes a query row
    (D ≤ 32, 64, 128, 256).  Each launch is counted in
    ``flash_attention.launches`` and, by instance, in
    ``flash_attention.instance_launches``."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal)
    _check(q, k, v)
    B, Hq, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if q.dtype == torch.float32:
        _build.launch("flash_attention_f32_launch", q.device, q.data_ptr(), k.data_ptr(),
                      v.data_ptr(), out.data_ptr(), B, Hq, Hkv, S, T, D, int(causal))
    else:
        # with more than one split, one call launches the split kernel and then
        # the combine kernel
        n_split = num_splits(B, Hq, S, T, _build.sm_count(q.device), D)
        _launch_tc(q, k, v, causal, n_split, out, _scratch(q, n_split) if n_split > 1 else None)
        if n_split > 1:
            flash_attention.combine_launches += 1
    flash_attention.launches += 1
    key = instance(q.dtype, D)
    flash_attention.instance_launches[key] = flash_attention.instance_launches.get(key, 0) + 1
    return out


flash_attention.launches = 0
flash_attention.combine_launches = 0
flash_attention.instance_launches = {}
