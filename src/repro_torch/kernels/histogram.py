"""Particle-filter weighted histogram + fused Bhattacharyya (paper §V, Fig. 11):
the Hopper kernel and its plain version.

Replaces ``repro/kernels/histogram.py`` ``particle_histogram_pallas``.  The
kernel is ``particle_histogram_kernel`` in ``csrc/kernels.cu``.
``particle_histogram`` takes a CPU tensor to the plain version and launches the
kernel for a CUDA tensor, with no fallback.
"""
from __future__ import annotations

import torch

from . import _build, ref

MAX_BINS = 32


def particle_histogram_plain(bins: torch.Tensor, weights: torch.Tensor,
                             ref_hist: torch.Tensor, n_bins: int):
    """bins (N, px), weights (px,), ref_hist (n_bins,) → (hist (N, n_bins), bc (N,))."""
    hist = ref.weighted_histogram(bins, weights, n_bins)
    return hist, ref.bhattacharyya(hist, ref_hist)


def _check(bins, weights, ref_hist, n_bins: int) -> None:
    _build.check_cuda_tensor("bins", bins, torch.int32, 2)
    _build.check_cuda_tensor("weights", weights, torch.float32, 1, device=bins.device)
    _build.check_cuda_tensor("ref_hist", ref_hist, torch.float32, 1, device=bins.device)
    if weights.shape[0] != bins.shape[1]:
        raise ValueError(f"weights {tuple(weights.shape)} do not match bins {tuple(bins.shape)}")
    if ref_hist.shape[0] != n_bins or not 1 <= n_bins <= MAX_BINS:
        raise ValueError(f"need ref_hist of shape (n_bins,) with 1 <= n_bins <= {MAX_BINS}; "
                         f"got {tuple(ref_hist.shape)}, n_bins={n_bins}")


def particle_histogram(bins: torch.Tensor, weights: torch.Tensor,
                       ref_hist: torch.Tensor, n_bins: int):
    """Kernel wrapper: int32 bins (N, px), float32 weights (px,) and ref_hist
    (n_bins,) → (hist (N, n_bins), bc (N,)) float32."""
    if bins.device.type == "cpu":
        return particle_histogram_plain(bins, weights, ref_hist, n_bins)
    _check(bins, weights, ref_hist, n_bins)
    N, px = bins.shape
    hist = torch.empty((N, n_bins), dtype=torch.float32, device=bins.device)
    bc = torch.empty((N,), dtype=torch.float32, device=bins.device)
    if N:
        _build.launch("particle_histogram_launch", bins.device, bins.data_ptr(),
                      weights.data_ptr(), ref_hist.data_ptr(), hist.data_ptr(),
                      bc.data_ptr(), N, px, n_bins)
        particle_histogram.launches += 1
    return hist, bc


particle_histogram.launches = 0
