"""Particle-filter weighted histogram + fused Bhattacharyya (paper §V, Fig. 11):
the Hopper kernel and its plain version.

Replaces ``repro/kernels/histogram.py`` ``particle_histogram_pallas``.  The
kernel is ``particle_histogram_kernel`` in ``csrc/kernels.cu`` (its note gives
the bound and the design).  ``particle_histogram`` takes a CPU tensor to the
plain version and launches the kernel for a CUDA tensor, with no fallback.
"""
from __future__ import annotations

import torch

from . import _build, ref

WARPS = 8                       # most warps of one block, one particle each at a time (kHistWarps)
MAX_STAGED_W = 96 * 1024        # w is staged in shared memory up to this many bytes
SMEM_PER_SM = 228 * 1024        # shared memory of one H100 SM
SMEM_PER_BLOCK = 227 * 1024     # dynamic shared memory one block may use
SMEM_PER_BLOCK_RESERVED = 1024  # what the runtime keeps of the SM's for each block
MIN_BLOCKS_PER_SM = 4           # __launch_bounds__ minimum: at most 64 registers a thread
COLUMN_BYTES = 32 * 4           # one bin of a warp's per-lane columns
MAX_BINS = SMEM_PER_BLOCK // COLUMN_BYTES   # 1816: one warp's columns fill a block


def particle_histogram_plain(bins: torch.Tensor, weights: torch.Tensor,
                             ref_hist: torch.Tensor, n_bins: int):
    """bins (N, px), weights (px,), ref_hist (n_bins,) → (hist (N, n_bins), bc (N,))."""
    hist = ref.weighted_histogram(bins, weights, n_bins)
    return hist, ref.bhattacharyya(hist, ref_hist)


def launch_shape(N: int, px: int, n_bins: int, sm_count: int) -> tuple[int, int, int, bool]:
    """(blocks, warps, smem_bytes, stage_w) of the kernel's launch.  Each
    block holds ``warps`` per-lane histograms of ``n_bins`` × 32 floats (up
    to ``WARPS``, fewer when ``n_bins`` is large: as many as fit in a block)
    and, when they fit in ``MAX_STAGED_W`` bytes and beside the histograms,
    the px weights.  One warp per particle, as many blocks as that takes, but
    no more than fit on the card at once (by registers and by shared memory):
    past that the warps walk several particles."""
    cols = n_bins * COLUMN_BYTES
    warps = max(1, min(WARPS, SMEM_PER_BLOCK // cols))
    stage_w = px * 4 <= MAX_STAGED_W and warps * cols + px * 4 <= SMEM_PER_BLOCK
    smem = warps * cols + (px * 4 if stage_w else 0)
    per_sm = min(MIN_BLOCKS_PER_SM, SMEM_PER_SM // (smem + SMEM_PER_BLOCK_RESERVED))
    return min(-(-N // warps), max(per_sm, 1) * sm_count), warps, smem, stage_w


def _check(bins, weights, ref_hist, n_bins: int) -> None:
    _build.check_cuda_tensor("bins", bins, torch.int32, 2)
    _build.check_cuda_tensor("weights", weights, torch.float32, 1, device=bins.device)
    _build.check_cuda_tensor("ref_hist", ref_hist, torch.float32, 1, device=bins.device)
    if weights.shape[0] != bins.shape[1]:
        raise ValueError(f"weights {tuple(weights.shape)} do not match bins {tuple(bins.shape)}")
    if ref_hist.shape[0] != n_bins or not 1 <= n_bins <= MAX_BINS:
        raise ValueError(f"need ref_hist of shape (n_bins,) with 1 <= n_bins <= {MAX_BINS} "
                         f"(one warp's per-lane columns in a block's {SMEM_PER_BLOCK} bytes of "
                         f"shared memory); got {tuple(ref_hist.shape)}, n_bins={n_bins}")


def particle_histogram(bins: torch.Tensor, weights: torch.Tensor,
                       ref_hist: torch.Tensor, n_bins: int):
    """Kernel wrapper: int32 bins (N, px), float32 weights (px,) and ref_hist
    (n_bins,) → (hist (N, n_bins), bc (N,)) float32.  ``n_bins`` up to
    ``MAX_BINS``; more raises ``ValueError`` (the reference takes any)."""
    if bins.device.type == "cpu":
        return particle_histogram_plain(bins, weights, ref_hist, n_bins)
    _check(bins, weights, ref_hist, n_bins)
    N, px = bins.shape
    hist = torch.empty((N, n_bins), dtype=torch.float32, device=bins.device)
    bc = torch.empty((N,), dtype=torch.float32, device=bins.device)
    if N:
        blocks, warps, smem, stage_w = launch_shape(N, px, n_bins,
                                                    _build.sm_count(bins.device))
        _build.launch("particle_histogram_launch", bins.device, bins.data_ptr(),
                      weights.data_ptr(), ref_hist.data_ptr(), hist.data_ptr(),
                      bc.data_ptr(), N, px, n_bins, blocks, warps, smem, int(stage_w))
        particle_histogram.launches += 1
    return hist, bc


particle_histogram.launches = 0
