#!/usr/bin/env python3
"""Readings that the correctness limits of a cell are set from, on the chip.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,... [--control-seeds 1,2,3]

For each seed, in one process: the weights and the inputs of that seed, the
cell's ``check.batches`` batches served by the program at the cell's own
sizes (``serve_batch``, as the window drives it, its logits captured as the
window captures them), and every number `check` can compare, against the
float32 reference (the lower reading).  For each control seed also the
control's numbers, the reference in fp8 put in the program's place (the
upper reading).  One JSON line a seed; the benchmark's own runs do
not run this.  ``--set`` and ``--override`` make a witness run at another
size or precision (say the program in float32 at 8 layers), which the
reference must then match.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None, root=ROOT, device="cuda", out=sys.stdout) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=JSON",
                    help="a witness run: change KEY of the configuration file (and, for a "
                         "size, the matching --override); not a setting of the cell")
    ap.add_argument("--override", action="append", default=[], metavar="FIELD=JSON",
                    help="a witness run: set a field of the port's ModelConfig")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(root), str(root / "src")]
    import torch

    from perfbench import check, weights
    from perfbench.harness import _traffic, port_config
    from perfbench.probes import Capture, Recorder
    from perfbench.spec import Spec
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T

    spec = Spec(root)
    cell = spec.cell(args.workload)
    cfg_file = spec.config(cell.config)
    for kv in args.set:
        k, v = kv.split("=", 1)
        cfg_file[k] = json.loads(v)
    for kv in args.override:
        k, v = kv.split("=", 1)
        cfg_file.setdefault("overrides", {})[k] = json.loads(v)
    n_batches = int(spec.workload(args.workload)["check"]["batches"])
    cfg = port_config(cfg_file)
    dev = torch.device(device)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    lines = []
    for seed in [int(s) for s in args.seeds.split(",")]:
        params = weights.make_params(T.abstract_params(cfg), cfg.cdtype, seed, dev)
        traffic = _traffic(spec, cell, cfg, seed, dev)
        batches = [traffic.batch(i) for i in range(n_batches)]
        served, logits = [], []
        with Capture() as cap:
            for b in batches:
                served.append(serve.serve_batch(params, cfg, b.prompts, traffic.mix.gen,
                                                frames=b.frames, device=dev, reg=Recorder()))
                logits.append(cap.take())
        t0 = time.perf_counter()
        prog, ctrl = check.compare(params, cfg_file, batches, served, logits, dev,
                                   control=seed in controls)
        line = {"workload": args.workload, "seed": seed, "program": check.summarize(prog),
                "reference_s": time.perf_counter() - t0, "set": args.set,
                "override": args.override}
        if ctrl is not None:
            line["control"] = check.summarize(ctrl)
        print(json.dumps(line), file=out, flush=True)
        lines.append(line)
        del params, traffic, batches, served, logits, prog, ctrl
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return lines


if __name__ == "__main__":
    main()
