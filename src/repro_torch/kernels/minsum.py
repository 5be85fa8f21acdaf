"""LDPC min-sum check-node update (paper §IV, Fig. 7): the Hopper kernel and
its plain version.

Replaces ``repro/kernels/minsum.py`` ``minsum_check_pallas``.  The kernel is
``minsum_check_kernel`` in ``csrc/kernels.cu``.  ``minsum_check`` takes a CPU
tensor to the plain version and launches the kernel for a CUDA tensor, with no
fallback.
"""
from __future__ import annotations

import torch

from . import _build, ref

MAX_DEG = 32


def minsum_check_plain(u: torch.Tensor) -> torch.Tensor:
    """u (n_checks, deg) → check-to-bit messages of the same shape."""
    return ref.minsum_check(u)


def _check(u: torch.Tensor) -> None:
    _build.check_cuda_tensor("u", u, torch.float32, 2)
    if not 1 <= u.shape[1] <= MAX_DEG:
        raise ValueError(f"check degree must be in [1, {MAX_DEG}], got {u.shape[1]}")


def minsum_check(u: torch.Tensor) -> torch.Tensor:
    """Kernel wrapper: float32 (n_checks, deg) → (n_checks, deg)."""
    if u.device.type == "cpu":
        return minsum_check_plain(u)
    _check(u)
    out = torch.empty_like(u)
    n, deg = u.shape
    if n:
        _build.launch("minsum_check_launch", u.device, u.data_ptr(), out.data_ptr(), n, deg)
        minsum_check.launches += 1
    return out


minsum_check.launches = 0
