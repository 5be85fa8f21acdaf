"""Traced case-study runs: ``python -m repro_torch.telemetry``.

Runs any of the three paper apps (BMVM / LDPC / particle filter) on any
topology in any simulated mode with a tracer attached, checks the
trace↔stats parity contract, and dumps the Perfetto JSON timeline plus the
link-utilization report.

    python -m repro_torch.telemetry --app bmvm --topology mesh --out trace.json
    python -m repro_torch.telemetry --app ldpc --topology torus --mode buffered
    python -m repro_torch.telemetry --app pf --pods --csv --device cpu
    python -m repro_torch.telemetry --app bmvm --mode buffered --profile

``--profile`` additionally runs the latency profiler (exact per-packet
decomposition + critical path + gap attribution; `telemetry.profile`) and
prints the bottleneck report; with ``--metrics`` the per-flow
``noc.latency.*`` histograms land in the snapshot too.  ``--device`` picks
where the apps run (default ``cuda``; with no GPU that raises, pass
``--device cpu``).  The particle filter's motion noise is drawn from the
run's numpy seed and passed in, so the card and the CPU track alike.
"""
from __future__ import annotations

import argparse
import json

import numpy as np


def _pods(n_nodes: int) -> list[int]:
    return [0] * (n_nodes // 2) + [1] * (n_nodes - n_nodes // 2)


def _run_app(app: str, topology: str, mode: str, iters: int, pods: bool,
             tracer, device):
    rng = np.random.default_rng(0)
    if app == "bmvm":
        from ..apps import bmvm
        cfg = bmvm.BMVMConfig(n=64, k=8, fold=2)
        A = rng.integers(0, 2, (64, 64)).astype(np.uint8)
        v = rng.integers(0, 2, (64,)).astype(np.uint8)
        lut = bmvm.preprocess(A, cfg, device=device)
        n = 2 * cfg.n_pe
        _, stats = bmvm.iterate_noc_sim(
            lut, v, cfg, iters, topology=topology, mode=mode,
            pods=_pods(n) if pods else None, tracer=tracer, device=device)
    elif app == "ldpc":
        from ..apps import ldpc
        H = ldpc.fano_plane_H()
        llr = ldpc.awgn_llr(np.zeros(7, np.int8), 4.0, rng)
        _, _, stats = ldpc.decode_on_noc(
            H, llr, iters, topology=topology, n_nodes=16, mode=mode,
            pods=_pods(16) if pods else None, tracer=tracer, device=device)
    else:   # pf
        from ..apps import particle_filter as pf
        cfg = pf.PFConfig(img=48, roi=12, n_particles=32, n_bins=12)
        frames, _ = pf.synth_video(cfg, iters + 1, rng)
        noise = [rng.normal(size=(cfg.n_particles, 2)).astype(np.float32)
                 for _ in range(iters)]
        _, stats = pf.track_on_noc(
            frames, cfg, n_pe=4, topology=topology, n_nodes=8, mode=mode,
            pods=_pods(8) if pods else None, tracer=tracer, noise=noise,
            device=device)
    return stats


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.telemetry",
        description="traced case-study run -> Perfetto JSON + link report")
    ap.add_argument("--app", choices=("bmvm", "ldpc", "pf"), default="bmvm")
    ap.add_argument("--topology",
                    choices=("ring", "mesh", "torus", "fattree"),
                    default="mesh")
    ap.add_argument("--mode", choices=("sim", "sim_python", "buffered"),
                    default="sim")
    ap.add_argument("--iters", type=int, default=3,
                    help="iterations (bmvm/ldpc) or tracked frames (pf)")
    ap.add_argument("--pods", action="store_true",
                    help="partition over 2 pods (quasi-SERDES bridges)")
    ap.add_argument("--capacity", type=int, default=1 << 20,
                    help="tracer ring-buffer capacity (events)")
    ap.add_argument("--detail", choices=("cycles", "flits"),
                    default="cycles",
                    help="'flits' records every switch flit move")
    ap.add_argument("--out", default=None,
                    help="write the Perfetto/Chrome trace JSON here")
    ap.add_argument("--csv", action="store_true",
                    help="emit the link report as CSV instead of a matrix")
    ap.add_argument("--metrics", default=None,
                    help="enable the metrics registry; write snapshot here")
    ap.add_argument("--profile", action="store_true",
                    help="print the latency profiler's bottleneck report "
                         "(and publish noc.latency.* when --metrics)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the app runs (default cuda)")
    args = ap.parse_args(argv)

    from .export import (chrome_trace, heatmap, link_utilization,
                         write_chrome_trace)
    from .metrics import disable_metrics, enable_metrics
    from .profile import profile_trace
    from .tracer import Tracer, trace_stats

    reg = enable_metrics() if args.metrics else None
    tr = Tracer(capacity=args.capacity, detail=args.detail)
    stats = _run_app(args.app, args.topology, args.mode, args.iters,
                     args.pods, tr, args.device)
    agg = trace_stats(tr)
    ok = agg.as_dict() == stats.as_dict()
    print(f"{args.app} on {args.topology} ({args.mode}"
          f"{', 2 pods' if args.pods else ''}): {len(tr.events())} events, "
          f"parity {'OK (bit-exact)' if ok else 'FAILED'}")
    if not ok:
        raise SystemExit("trace does not reproduce NoCStats:\n"
                         f"  engine: {stats.as_dict()}\n"
                         f"  trace:  {agg.as_dict()}")
    for k, v in stats.as_dict().items():
        if v:
            print(f"  {k:>24} {v}")
    if args.out:
        doc = chrome_trace(tr)
        write_chrome_trace(args.out, doc)
        print(f"Perfetto trace -> {args.out} ({len(doc['traceEvents'])} "
              f"events; load in ui.perfetto.dev)")
    print()
    print(heatmap(link_utilization(tr), csv=args.csv))
    if args.profile:
        prof = profile_trace(tr).check_exact()
        if reg is not None:
            prof.publish(reg, app=args.app, topology=args.topology,
                         mode=args.mode)
        print()
        print(prof.report())
    if reg is not None:
        with open(args.metrics, "w") as fh:
            json.dump(reg.snapshot(), fh, indent=1, sort_keys=True)
            fh.write("\n")
        print(f"metrics snapshot -> {args.metrics}")
        disable_metrics()


if __name__ == "__main__":
    main()
