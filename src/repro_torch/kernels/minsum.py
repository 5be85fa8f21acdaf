"""LDPC min-sum check-node update (paper §IV, Fig. 7): the Hopper kernel and
its plain version.

Replaces ``repro/kernels/minsum.py`` ``minsum_check_pallas``.  The kernel is
``minsum_check_kernel`` in ``csrc/kernels.cu``, with float32, bf16 and fp16
instances, as the Pallas kernel works in ``u.dtype``.  ``minsum_check`` takes
a CPU tensor to the plain version and launches the kernel for a CUDA tensor,
with no fallback.
"""
from __future__ import annotations

import torch

from . import _build, ref

ROWS = 128                      # check rows of one block (kMinsumThreads)
SMEM_PER_BLOCK = 227 * 1024     # dynamic shared memory one block may use
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def max_degree(dtype: torch.dtype) -> int:
    """The largest check degree the kernel takes: one row of it, padded by
    one element, fills a block's shared memory (58111 in float32, 116223 in
    bf16/fp16)."""
    return SMEM_PER_BLOCK // dtype.itemsize - 1


def minsum_check_plain(u: torch.Tensor) -> torch.Tensor:
    """u (n_checks, deg) → check-to-bit messages of the same shape."""
    return ref.minsum_check(u)


def launch_shape(n: int, deg: int, dtype: torch.dtype) -> tuple[int, int, int, int]:
    """(rows, pitch, blocks, smem_bytes): a block copies ``rows`` check rows
    into shared memory, 128 or as many as fit in a block, one thread a row,
    rows ``pitch`` elements apart: ``deg``, or ``deg + 1`` where a row would
    be a whole number of 8-byte words (every thread of a warp on one bank)."""
    pitch = deg + 1 if deg * dtype.itemsize % 8 == 0 else deg
    rows = min(ROWS, SMEM_PER_BLOCK // (pitch * dtype.itemsize))
    return rows, pitch, -(-n // rows), rows * pitch * dtype.itemsize


def _check(u: torch.Tensor) -> None:
    if u.dtype not in _DTYPES:
        raise TypeError(f"u must be float32, bfloat16 or float16, got {u.dtype}")
    _build.check_cuda_tensor("u", u, u.dtype, 2)
    if not 1 <= u.shape[1] <= max_degree(u.dtype):
        raise ValueError(f"check degree must be in [1, {max_degree(u.dtype)}] (one row in a "
                         f"block's {SMEM_PER_BLOCK} bytes of shared memory), got {u.shape[1]}")


def minsum_check(u: torch.Tensor) -> torch.Tensor:
    """Kernel wrapper: float32, bf16 or fp16 (n_checks, deg) → (n_checks, deg)
    in u's dtype, bit-exact against the plain version in every dtype."""
    if u.device.type == "cpu":
        return minsum_check_plain(u)
    _check(u)
    out = torch.empty_like(u)
    n, deg = u.shape
    if n:
        rows, pitch, _, _ = launch_shape(n, deg, u.dtype)
        _build.launch("minsum_check_launch", u.device, u.data_ptr(), out.data_ptr(), n, deg,
                      rows, pitch, _DTYPES[u.dtype])
        minsum_check.launches += 1
    return out


minsum_check.launches = 0
