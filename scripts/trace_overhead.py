#!/usr/bin/env python3
"""Host wall of the BMVM n=1024 NoC with tracing off and on, on one GPU.

    python3 scripts/trace_overhead.py [--src DIR] [--label L] [--reps N]

BMVM n=1024 fold=4 (32 + 32 PEs) on the 8×8 mesh, r=2, the size
``chip_smoke.py`` phases 7 and 8 drive: ``mode="buffered"`` uncut and cut
into 2 pods, and ``mode="sim"`` uncut.  Each path runs once to warm up, then
``--reps`` times untraced; where the package under ``--src`` has telemetry,
``--reps`` times traced at ``detail="cycles"`` and at ``detail="flits"`` too.
Every run ends in ``torch.cuda.synchronize()``.  Prints one JSON line: the
card and its power limit, each path's walls in ms, their medians, and the
traced / untraced ratios.

``--src`` points at another checkout's ``src`` (default: this one's), so two
versions can be timed in turns in one chip call (parent, change, change,
parent) — host walls differ between calls far more than within one.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=os.path.join(HERE, "src"))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("trace_overhead: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.apps import bmvm
    try:
        from repro_torch import telemetry
    except ImportError:          # a tree from before the telemetry slice
        telemetry = None

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    rng = np.random.default_rng(0)
    cfg = bmvm.BMVMConfig(n=1024, k=8, fold=4)
    A = rng.integers(0, 2, (1024, 1024)).astype(np.uint8)
    v = rng.integers(0, 2, (1024,)).astype(np.uint8)
    lut = bmvm.preprocess(A, cfg)

    def once(mode, pods, detail=None):
        kw = {} if detail is None else {"tracer": telemetry.Tracer(detail=detail)}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bmvm.iterate_noc_sim(lut, v, cfg, 2, topology="mesh", n_nodes=64, pods=pods,
                             mode=mode, **kw)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    out = {"label": args.label, "src": os.path.relpath(os.path.abspath(args.src), HERE),
           "device": smi, "reps": args.reps, "paths": {}}
    for name, mode, pods in (("buffered_uncut", "buffered", None),
                             ("buffered_2pods", "buffered", [0] * 32 + [1] * 32),
                             ("sim_uncut", "sim", None)):
        once(mode, pods)
        row = {"untraced_ms": [once(mode, pods) for _ in range(args.reps)]}
        if telemetry is not None:
            for detail in ("cycles", "flits"):
                row[f"traced_{detail}_ms"] = [once(mode, pods, detail) for _ in range(args.reps)]
        for key in list(row):
            row[key.replace("_ms", "_median_ms")] = statistics.median(row[key])
        for detail in ("cycles", "flits"):
            if f"traced_{detail}_median_ms" in row:
                row[f"{detail}_over_untraced"] = (row[f"traced_{detail}_median_ms"]
                                                  / row["untraced_median_ms"])
        out["paths"][name] = row
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
