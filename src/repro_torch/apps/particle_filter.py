"""Case study II: particle-filter object tracking (paper §V).

SIS particle filter over synthetic video: reference histogram from frame 1,
then per frame — sample N particles around the previous estimate, compute
distance-weighted candidate histograms + Bhattacharyya weights (the paper's
Fig. 11 PE, here the fused CUDA histogram kernel), and a weighted-mean center
update (the paper's Node-0 root PE, Fig. 12).  ``track_on_noc`` places the
particle-group PEs and the root on a NoC.

Motion noise: the reference draws it with ``jax.random``, whose stream torch
cannot reproduce, so ``step`` takes the standard-normal draws as an input and
``track``/``track_on_noc`` take an optional per-frame ``noise`` sequence.
Without one they draw from a ``torch.Generator`` seeded with ``cfg.seed``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from .._device import resolve_device
from ..core import PE, Port, TaskGraph, make_topology
from ..kernels import ops as kops
from ..kernels import ref as kref
from . import noc_executor


@dataclasses.dataclass(frozen=True)
class PFConfig:
    img: int = 64           # square frames
    roi: int = 16           # square region of interest
    n_bins: int = 16
    n_particles: int = 64
    sigma_motion: float = 3.0
    sigma_bc: float = 0.1
    seed: int = 0


def synth_video(cfg: PFConfig, n_frames: int, rng) -> tuple[np.ndarray, np.ndarray]:
    """Moving bright blob on noise.  Returns (frames (F,H,W), centers (F,2))."""
    H = W = cfg.img
    centers = np.zeros((n_frames, 2))
    c = np.array([H / 2, W / 2])
    vel = rng.normal(0, 1.2, 2)
    frames = np.zeros((n_frames, H, W), np.float32)
    yy, xx = np.mgrid[0:H, 0:W]
    for f in range(n_frames):
        vel = 0.9 * vel + rng.normal(0, 0.4, 2)
        c = np.clip(c + vel, cfg.roi, cfg.img - cfg.roi - 1)
        centers[f] = c
        blob = np.exp(-(((yy - c[0]) ** 2 + (xx - c[1]) ** 2) / (2 * (cfg.roi / 3) ** 2)))
        frames[f] = 0.75 * blob + 0.25 * rng.uniform(0, 1, (H, W))
    return frames, centers


def _roi_bins(frame: torch.Tensor, centers: torch.Tensor, cfg: PFConfig) -> torch.Tensor:
    """Per-particle ROI pixel bin indices (N, roi²) int32.  centers: (N, 2)
    float; float→int truncates toward zero, as the reference's ``astype``."""
    r = cfg.roi
    y = (centers[:, 0].to(torch.int32) - r // 2).clamp(0, cfg.img - r)
    x = (centers[:, 1].to(torch.int32) - r // 2).clamp(0, cfg.img - r)
    ar = torch.arange(r, device=frame.device)
    patch = frame[(y[:, None] + ar)[:, :, None], (x[:, None] + ar)[:, None, :]]  # (N, r, r)
    bins = (patch * cfg.n_bins).to(torch.int32).clamp(0, cfg.n_bins - 1)
    return bins.reshape(centers.shape[0], r * r)


def distance_weights(cfg: PFConfig, device="cuda") -> torch.Tensor:
    """Epanechnikov kernel over the ROI (the paper's 'distance weighted')."""
    r = cfg.roi
    ar = torch.arange(r, device=resolve_device(device))
    yy, xx = torch.meshgrid(ar, ar, indexing="ij")
    d2 = ((yy - r / 2 + 0.5) ** 2 + (xx - r / 2 + 0.5) ** 2) / ((r / 2) ** 2)
    return (1 - d2).clamp_min(0).to(torch.float32).reshape(-1)


def reference_histogram(frame: torch.Tensor, center: torch.Tensor, cfg: PFConfig) -> torch.Tensor:
    bins = _roi_bins(frame, center[None], cfg)
    w = distance_weights(cfg, frame.device)
    return kref.weighted_histogram(bins, w, cfg.n_bins)[0]


def step(frame: torch.Tensor, prev_center: torch.Tensor, ref_hist: torch.Tensor,
         cfg: PFConfig, noise: torch.Tensor, use_kernel: bool = True):
    """One SIS update; ``noise`` is (n_particles, 2) standard-normal draws.
    Returns (new_center, particle weights, particles)."""
    parts = prev_center[None, :] + noise * cfg.sigma_motion
    parts = parts.clamp(cfg.roi // 2, cfg.img - cfg.roi // 2 - 1)
    bins = _roi_bins(frame, parts, cfg)
    dw = distance_weights(cfg, frame.device)
    _, bc = kops.particle_histogram(bins, dw, ref_hist, n_bins=cfg.n_bins,
                                    use_kernel=use_kernel)
    w = torch.exp((bc - 1.0) / (cfg.sigma_bc ** 2))
    w = w / w.sum().clamp_min(1e-12)
    new_center = (w[:, None] * parts).sum(0)
    return new_center, w, parts


def _motion_noise(cfg: PFConfig, n_steps: int, noise: Optional[Sequence],
                  device: torch.device) -> list[torch.Tensor]:
    """The per-frame (n_particles, 2) standard-normal draws: ``noise`` as
    given, or drawn from a generator seeded with ``cfg.seed``."""
    shape = (cfg.n_particles, 2)
    if noise is None:
        g = torch.Generator(device=device).manual_seed(cfg.seed)
        return [torch.randn(shape, generator=g, device=device) for _ in range(n_steps)]
    out = [x.to(device, torch.float32) if isinstance(x, torch.Tensor)
           else torch.as_tensor(np.array(x, np.float32), device=device) for x in noise]
    if len(out) != n_steps or any(tuple(x.shape) != shape for x in out):
        raise ValueError(f"noise must be {n_steps} arrays of shape {shape}")
    return out


def _first_center(frame0: torch.Tensor) -> torch.Tensor:
    """Initialize on the true blob: intensity argmax of frame 0 (first index)."""
    i = torch.argmax(frame0.reshape(-1))
    return torch.stack([i // frame0.shape[1], i % frame0.shape[1]]).to(torch.float32)


def track(frames: np.ndarray, cfg: PFConfig, use_kernel: bool = True,
          noise: Optional[Sequence] = None, device="cuda") -> np.ndarray:
    """Full tracking run; returns estimated centers (F, 2)."""
    dev = resolve_device(device)
    frames_t = torch.as_tensor(frames, device=dev)
    draws = _motion_noise(cfg, frames.shape[0] - 1, noise, dev)
    c = _first_center(frames_t[0])
    ref = reference_histogram(frames_t[0], c, cfg)
    centers = [c]
    for f in range(1, frames.shape[0]):
        c, _, _ = step(frames_t[f], c, ref, cfg, draws[f - 1], use_kernel)
        centers.append(c)
    return torch.stack(centers).cpu().numpy()


# ---------------------------------------------------------------------------
# NoC realization (paper Figs. 10 & 12): particle-group PEs + root PE
# ---------------------------------------------------------------------------

def build_pf_graph(cfg: PFConfig, n_pe: int) -> TaskGraph:
    if cfg.n_particles % n_pe:
        raise ValueError(f"n_pe={n_pe} does not divide n_particles={cfg.n_particles}")
    per = cfg.n_particles // n_pe
    g = TaskGraph("particle_filter")
    r2 = cfg.roi * cfg.roi

    def pe_fn(**kw):
        bins, ref, parts = kw["bins"], kw["ref"], kw["parts"]
        dw = distance_weights(cfg, bins.device)
        hist = kref.weighted_histogram(bins, dw, cfg.n_bins)
        bc = kref.bhattacharyya(hist, ref)
        w = torch.exp((bc - 1.0) / (cfg.sigma_bc ** 2))
        return {"wsum": w.sum()[None], "wc": (w[:, None] * parts).sum(0)}

    def root_fn(**kw):
        wsum = sum(kw[f"wsum{i}"] for i in range(n_pe))
        wc = sum(kw[f"wc{i}"] for i in range(n_pe))
        return {"center": wc / wsum.clamp_min(1e-12)}

    for i in range(n_pe):
        g.add(PE(f"pe{i}", pe_fn,
                 (Port("bins", (per, r2), np.int32), Port("ref", (cfg.n_bins,)),
                  Port("parts", (per, 2))),
                 (Port("wsum", (1,)), Port("wc", (2,)))))
    g.add(PE("root", root_fn,
             tuple(Port(f"wsum{i}", (1,)) for i in range(n_pe))
             + tuple(Port(f"wc{i}", (2,)) for i in range(n_pe)),
             (Port("center", (2,)),)))
    for i in range(n_pe):
        g.connect(f"pe{i}.wsum", f"root.wsum{i}")
        g.connect(f"pe{i}.wc", f"root.wc{i}")
    return g


def track_on_noc(frames: np.ndarray, cfg: PFConfig, n_pe: int = 4,
                 topology: str = "mesh", n_nodes: int = 8,
                 placement="rr", mode: str = "sim",
                 pods: Optional[list[int]] = None, serdes_cfg=None,
                 tracer=None, noise: Optional[Sequence] = None, device="cuda"):
    """Paper-faithful NoC execution; returns (centers (F, 2), total NoCStats).

    ``placement``: 'rr' | 'greedy' | 'opt' or an explicit PE→node mapping.
    ``mode``: 'sim', 'spmd' (each frame's messages move over a device mesh,
    one NoC node per rank; every rank calls it alike), 'buffered' (the
    wormhole switch: same tracks, ``rounds`` are switch cycles and the
    ``switch_*`` counters fill), 'sim_python' or 'direct'.  ``noise`` as in
    `track`.  ``pods`` (node→pod) runs the tracker partitioned: cut links go
    through quasi-SERDES bridges (``serdes_cfg``) with identical tracks and
    ``bridge_*`` counters in the stats (analytic ones in 'buffered', which
    routes uncut).  The executor verifies itself
    (``verify="strict"``).  ``tracer``: a `telemetry.Tracer` to record the
    run's events into (``NoCExecutor(trace=)``)."""
    dev = resolve_device(device)
    g = build_pf_graph(cfg, n_pe)
    topo = make_topology(topology, n_nodes)
    ex = noc_executor(g, topo, placement, pods, serdes_cfg, tracer, dev)
    frames_t = torch.as_tensor(frames, device=dev)
    draws = _motion_noise(cfg, frames.shape[0] - 1, noise, dev)
    c = _first_center(frames_t[0])
    ref = reference_histogram(frames_t[0], c, cfg)
    per = cfg.n_particles // n_pe
    centers = [c]
    total_stats = None
    for f in range(1, frames.shape[0]):
        parts = (c[None] + draws[f - 1] * cfg.sigma_motion).clamp(
            cfg.roi // 2, cfg.img - cfg.roi // 2 - 1)
        bins = _roi_bins(frames_t[f], parts, cfg)
        inputs = {}
        for i in range(n_pe):
            inputs[f"pe{i}.bins"] = bins[i * per:(i + 1) * per]
            inputs[f"pe{i}.ref"] = ref
            inputs[f"pe{i}.parts"] = parts[i * per:(i + 1) * per]
        outs, stats = ex.run(inputs, mode=mode)
        c = outs["root.center"]
        centers.append(c)
        if total_stats is None:
            total_stats = stats
        else:
            total_stats.add(stats)   # peak counters merge by max, flows sum
    return torch.stack(centers).cpu().numpy(), total_stats
