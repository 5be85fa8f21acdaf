"""The dry run's roofline table and reports over saved telemetry traces
(counterpart of ``repro/launch/report.py``).

    PYTHONPATH=src python -m repro_torch.launch.report results/dryrun [--md]
    PYTHONPATH=src python -m repro_torch.launch.report --trace trace.json [--csv]
    PYTHONPATH=src python -m repro_torch.launch.report --profile trace.json

The positional mode reads a directory of dry-run records (`launch.dryrun`,
or the reference's: the keys are the same), adds the algorithm-ideal terms
the records cannot know, rewrites each record in place and prints the table
(CSV, or Markdown with ``--md``):

  ideal_compute_s = MODEL_FLOPS/chips / PEAK_FLOPS
  ideal_memory_s  = MODEL_BYTES/chips / HBM_BW   (params + cache traffic floor)
  roofline_fraction = max(ideal terms) / achieved step time

with `launch.roofline`'s constants (the H100's).

``--trace`` renders the link-utilization heatmap of a recorded Perfetto/
Chrome trace (see ``python -m repro_torch.telemetry``); ``--profile`` runs the
latency profiler over the same saved trace (``events_from_chrome`` →
``profile_trace``) and prints the bottleneck report: exact per-packet latency
decomposition, critical path and the gap attribution against the analytic
bounds.  Both read a trace written by either package: the event schema is
shared.  All three are host bookkeeping: nothing here touches a device.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

import torch

from .._tree import leaves
from ..configs import SHAPES, get_config
from ..telemetry import (events_from_chrome, heatmap, link_utilization,
                         profile_trace)
from . import roofline as RL


def cache_bytes(cfg, shape) -> int:
    """The decode cache's global bytes at ``seq_len``, as the reference
    counts them: its tensors, plus the int32 words the reference keeps
    beside them (a write index per period of each attention or MLA
    sub-layer, and the position), which the port keeps as host integers."""
    from .steps import cache_struct
    tensors = sum(t.numel() * t.element_size()
                  for t in leaves(cache_struct(cfg, shape.global_batch, shape.seq_len))
                  if isinstance(t, torch.Tensor))
    n_idx = cfg.n_periods * sum(m in ("attn", "mla") for m, _ in cfg.pattern)
    return tensors + 4 * (n_idx + 1)


def model_bytes(cfg, shape) -> float:
    """Algorithm-minimum HBM traffic per step (global bytes).

    train:   read+write params/m/v in f32 (24 B/param) + bf16 cast reads (2)
    prefill: param reads (2 B active) + cache writes
    decode:  param reads (2 B active) + full cache read
    """
    n = cfg.param_count()
    n_act = cfg.active_param_count()
    if shape.kind == "train":
        return 24.0 * n + 2.0 * n_act
    cb = cache_bytes(cfg, shape)
    if shape.kind == "prefill":
        return 2.0 * n_act + cb
    return 2.0 * n_act + cb  # decode: read the whole cache once


def enrich(rec: dict) -> dict:
    cfg = get_config(rec["arch"])
    if rec["shape"] == "long_500k":
        cfg = cfg.replace(seq_shard_kv=True)
    shape = SHAPES[rec["shape"]]
    n_chips = 512 if rec["mesh"] == "2x16x16" else 256
    rc = rec.get("roofline_corrected") or {}
    if rec["status"] != "ok" or "error" in rc:
        return rec
    mb = model_bytes(cfg, shape)
    ideal_c = rc["model_flops_global"] / n_chips / RL.PEAK_FLOPS
    ideal_m = mb / n_chips / RL.HBM_BW
    achieved = max(rc["compute_s"], rc["memory_s"], rc["collective_s"])
    rc["ideal_compute_s"] = ideal_c
    rc["ideal_memory_s"] = ideal_m
    rc["model_bytes_global"] = mb
    rc["roofline_fraction"] = max(ideal_c, ideal_m) / achieved if achieved else 0.0
    rec["roofline_corrected"] = rc
    return rec


def table(directory: str, md: bool = False) -> str:
    """Enrich every record of ``directory`` in place and return the table."""
    rows = []
    for f in sorted(glob.glob(os.path.join(directory, "*.json"))):
        with open(f) as fh:
            rec = enrich(json.load(fh))
        with open(f, "w") as fh:
            json.dump(rec, fh, indent=1)
        rows.append(rec)
    hdr = ("arch", "shape", "mesh", "status", "dom", "compute_s", "memory_s",
           "collective_s", "ideal_c", "ideal_m", "roofline_frac")
    lines = []
    if md:
        lines.append("| " + " | ".join(hdr) + " |")
        lines.append("|" + "---|" * len(hdr))
    else:
        lines.append(",".join(hdr))
    for r in rows:
        rc = r.get("roofline_corrected") or {}
        if r["status"] == "ok" and "error" not in rc:
            vals = (r["arch"], r["shape"], r["mesh"], "ok", rc["dominant"],
                    f"{rc['compute_s']:.4f}", f"{rc['memory_s']:.4f}",
                    f"{rc['collective_s']:.4f}", f"{rc['ideal_compute_s']:.4f}",
                    f"{rc['ideal_memory_s']:.4f}", f"{rc['roofline_fraction']:.3f}")
        else:
            vals = (r["arch"], r["shape"], r["mesh"], r["status"],
                    str(r.get("reason") or r.get("error", ""))[:60], "", "", "", "", "", "")
        lines.append("| " + " | ".join(vals) + " |" if md else ",".join(vals))
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.report")
    ap.add_argument("dir", nargs="?", default=None,
                    help="dry-run results directory (roofline table)")
    ap.add_argument("--md", action="store_true")
    ap.add_argument("--trace", default=None, metavar="TRACE_JSON",
                    help="render the link-utilization heatmap of a "
                         "telemetry trace")
    ap.add_argument("--csv", action="store_true",
                    help="with --trace: CSV rows instead of the matrix")
    ap.add_argument("--profile", default=None, metavar="TRACE_JSON",
                    help="print the latency profiler's bottleneck report "
                         "for a saved telemetry trace")
    args = ap.parse_args(argv)
    if args.profile is not None:
        with open(args.profile) as fh:
            doc = json.load(fh)
        print(profile_trace(events_from_chrome(doc)).check_exact().report())
        return
    if args.trace is not None:
        with open(args.trace) as fh:
            doc = json.load(fh)
        print(heatmap(link_utilization(doc), csv=args.csv))
        return
    if args.dir is None:
        ap.error("either a results dir or --trace is required")
    print(table(args.dir, md=args.md))


if __name__ == "__main__":
    main()
