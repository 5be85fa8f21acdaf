"""Case study II (paper §V): particle-filter object tracking over the NoC, on
the PyTorch/CUDA port.

    PYTHONPATH=src python examples/particle_tracking_torch.py [--device cpu]

``track`` runs the hand-written ``particle_histogram`` CUDA kernel once a
frame after the first (19 launches on the card).  The motion noise comes from
a ``torch.Generator`` seeded with ``cfg.seed`` on the run's device; the
reference draws it with ``jax.random``, so the estimates differ from the
reference's, and the card's from the CPU's.  Runs on the GPU unless
``--device cpu`` is given.
"""
import argparse

import numpy as np

from repro_torch import resolve_device
from repro_torch.apps import particle_filter as pf
from repro_torch.core import NoCConfig, wrapper_overhead


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rng = np.random.default_rng(0)
    cfg = pf.PFConfig(img=64, roi=16, n_particles=64, n_bins=16, seed=0)
    frames, truth = pf.synth_video(cfg, 20, rng)
    print(f"synthetic video: {frames.shape[0]} frames {frames.shape[1]}x{frames.shape[2]}, "
          f"{cfg.n_particles} particles, {cfg.n_bins}-bin histograms")

    # direct (kernel) tracking
    est = pf.track(frames, cfg, device=dev)
    err = np.linalg.norm(est - truth, axis=1)
    print(f"kernel path:   mean err {err.mean():.2f}px  max {err.max():.2f}px")

    # NoC realization: 4 particle-group PEs + root orchestrator (Figs. 10-12)
    est2, stats = pf.track_on_noc(frames, cfg, n_pe=4, topology="mesh", n_nodes=8,
                                  device=dev)
    err2 = np.linalg.norm(est2 - truth, axis=1)
    print(f"NoC (4 PEs):   mean err {err2.mean():.2f}px  "
          f"(flits={stats.flits}, rounds={stats.rounds})")
    assert np.abs(est - est2).max() < 1e-2

    # Table-III analog
    g = pf.build_pf_graph(cfg, 4)
    rows = wrapper_overhead(g, NoCConfig())
    print("\nTable-III analog (per-PE bytes, wrapper = collector+distributor FIFOs):")
    for r in rows:
        print(f"  {r['pe']:6s} raw={r['wo_wrapper_bytes']:6d}B "
              f"wrapped={r['with_wrapper_bytes']:6d}B")
    print("\nper-frame estimates vs truth (first 5):")
    for f in range(5):
        print(f"  frame {f}: est=({est[f][0]:5.1f},{est[f][1]:5.1f}) "
              f"truth=({truth[f][0]:5.1f},{truth[f][1]:5.1f})")


if __name__ == "__main__":
    main()
