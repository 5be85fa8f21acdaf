#!/usr/bin/env python3
"""The benchmark of ``repro_torch``'s serve path: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds ``src/repro_torch``.  It needs as
many CUDA devices as the cell asks for, and prints one JSON object as the last
line of its standard output: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device``, with ``--trace 1`` a ``breakdown``, and last
``compared``: each number the correctness check compared, beside its limit,
which it also prints as the last lines of standard error.  See README.md.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HOME = Path(__file__).resolve().parent
ROOT = HOME.parent


def _cache_dirs() -> None:
    """Every build and kernel cache at a fixed place inside the checkout (the
    port's nvcc library already lands in ``src/repro_torch/kernels/build``)."""
    cache = ROOT / "build" / "perfbench-cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("USE_FLAX", "0")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"perfbench: no src/repro_torch under {ROOT}: the program is missing",
              file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    _cache_dirs()
    from perfbench.harness import forbidden_modules, run_cell
    from perfbench.spec import Spec

    bad = forbidden_modules()
    if bad:
        print(f"perfbench: forbidden modules loaded at start: {bad}", file=sys.stderr)
        return 3
    chips = Spec(ROOT).cell(args.workload).chips
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: the cell needs {chips} CUDA device(s), found {n}", file=sys.stderr)
        return 4
    result = run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                      t_start=T_START)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: forbidden modules loaded by the run: {bad}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
