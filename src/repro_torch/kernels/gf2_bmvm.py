"""Williams' sub-quadratic GF(2) BMVM (paper §VI): the Hopper kernel and its
plain version.

Replaces ``repro/kernels/gf2_bmvm.py`` ``gf2_bmvm_pallas``.  The kernel is
``gf2_bmvm_kernel`` in ``csrc/kernels.cu`` (its note gives the bound and the
design).  ``gf2_bmvm`` takes a CPU tensor to the plain version and launches the
kernel for a CUDA tensor, with no fallback.
"""
from __future__ import annotations

import torch

from . import _build, ref

_MAX_SHARED = 48 * 1024   # static-launch shared-memory limit (v row staging)


def gf2_bmvm_plain(lut: torch.Tensor, v_words: torch.Tensor) -> torch.Tensor:
    """out[m, r] = XOR_c lut[c, v_words[m, c], r]; (C, P, R), (M, C) → (M, R)."""
    return ref.gf2_bmvm(lut, v_words)


def _check(lut: torch.Tensor, v_words: torch.Tensor) -> None:
    _build.check_cuda_tensor("lut", lut, torch.int32, 3)
    _build.check_cuda_tensor("v_words", v_words, torch.int32, 2, device=lut.device)
    C, P, R = lut.shape
    if v_words.shape[1] != C:
        raise ValueError(f"v_words {tuple(v_words.shape)} does not match LUT columns C={C}")
    if C < 1 or P < 1 or P & (P - 1) or P > 2 ** 16:
        raise ValueError(f"LUT must be (C>=1, 2^k with k<=16, R), got {tuple(lut.shape)}")
    if C * 4 > _MAX_SHARED:
        raise ValueError(f"C={C} words of v do not fit the kernel's shared-memory row")


def gf2_bmvm(lut: torch.Tensor, v_words: torch.Tensor) -> torch.Tensor:
    """Kernel wrapper: int32 LUT (C, 2^k, R) and int32 words (M, C) → (M, R)."""
    if lut.device.type == "cpu":
        return gf2_bmvm_plain(lut, v_words)
    _check(lut, v_words)
    C, P, R = lut.shape
    M = v_words.shape[0]
    out = torch.empty((M, R), dtype=torch.int32, device=lut.device)
    if M and R:
        _build.launch("gf2_bmvm_launch", lut.device, lut.data_ptr(),
                      v_words.data_ptr(), out.data_ptr(), C, P, R, M)
        gf2_bmvm.launches += 1
    return out


gf2_bmvm.launches = 0
