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

THREADS = 128            # threads of one block, 4 output words each (kBmvmThreads)
R_TILE = 4 * THREADS     # output words of one block (kBmvmTile)
MAX_CHUNKS = 8           # chunks of C: one cluster, portable size (kBmvmMaxCluster)
MIN_CHUNK = 8            # one unrolled batch of LUT-row loads (kBmvmUnroll)
BLOCKS_PER_SM = 8        # what the chunks aim at: 8 blocks of 128 threads an SM
MAX_GRID_Z = 65535


def gf2_bmvm_plain(lut: torch.Tensor, v_words: torch.Tensor) -> torch.Tensor:
    """out[m, r] = XOR_c lut[c, v_words[m, c], r]; (C, P, R), (M, C) → (M, R)."""
    return ref.gf2_bmvm(lut, v_words)


def launch_shape(M: int, C: int, R: int, sm_count: int) -> tuple[int, int]:
    """(chunk, n_chunks): the kernel's grid is (M, n_chunks, ceil(R / R_TILE))
    and block (m, i, ·) XORs columns [i · chunk, (i + 1) · chunk) of C; the
    n_chunks blocks of one (m, R tile) are one cluster.  As many chunks as
    bring the grid to ``BLOCKS_PER_SM`` blocks on each of the card's
    ``sm_count`` SMs, at most ``MAX_CHUNKS``, with a chunk a multiple of
    ``MIN_CHUNK`` (the unrolled loads) and no chunk left empty."""
    r_tiles = -(-R // R_TILE)
    want = -(-BLOCKS_PER_SM * sm_count // (M * r_tiles))
    n = max(1, min(want, MAX_CHUNKS, -(-C // MIN_CHUNK)))
    per = -(-C // n)
    chunk = -(-per // MIN_CHUNK) * MIN_CHUNK
    return chunk, -(-C // chunk)


def _check(lut: torch.Tensor, v_words: torch.Tensor) -> None:
    _build.check_cuda_tensor("lut", lut, torch.int32, 3)
    _build.check_cuda_tensor("v_words", v_words, torch.int32, 2, device=lut.device)
    C, P, R = lut.shape
    if v_words.shape[1] != C:
        raise ValueError(f"v_words {tuple(v_words.shape)} does not match LUT columns C={C}")
    if C < 1 or P < 1 or P & (P - 1) or P > 2 ** 16:
        raise ValueError(f"LUT must be (C>=1, 2^k with k<=16, R), got {tuple(lut.shape)}")
    if -(-R // R_TILE) > MAX_GRID_Z:
        raise ValueError(f"R={R} exceeds the kernel's grid ({MAX_GRID_Z} tiles of {R_TILE})")


def gf2_bmvm(lut: torch.Tensor, v_words: torch.Tensor) -> torch.Tensor:
    """Kernel wrapper: int32 LUT (C, 2^k, R) and int32 words (M, C) → (M, R)."""
    if lut.device.type == "cpu":
        return gf2_bmvm_plain(lut, v_words)
    _check(lut, v_words)
    C, P, R = lut.shape
    M = v_words.shape[0]
    out = torch.empty((M, R), dtype=torch.int32, device=lut.device)
    if M and R:
        chunk, _ = launch_shape(M, C, R, _build.sm_count(lut.device))
        _build.launch("gf2_bmvm_launch", lut.device, lut.data_ptr(),
                      v_words.data_ptr(), out.data_ptr(), C, P, R, M, chunk)
        gf2_bmvm.launches += 1
    return out


gf2_bmvm.launches = 0
