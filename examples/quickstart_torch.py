"""Quickstart: the whole framework in ~60 lines, on the PyTorch/CUDA port.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

1. Express an app as a message-passing TaskGraph (phase-1).
2. Map it onto a packet-switched NoC topology and run it (phase-2, single pod).
3. Cut the NoC across two pods with quasi-SERDES endpoints — same results.
4. Trace a run: the event timeline aggregates back to the same NoCStats
   bit-exactly, and exports a Perfetto-loadable JSON.
5. Train a (reduced) llama3.2-1b for 100 steps with the LM generalization.

Runs on the GPU unless ``--device cpu`` is given (with no GPU it raises).
"""
import argparse

import torch

from repro_torch import resolve_device
from repro_torch.core import (NoCExecutor, PE, Port, TaskGraph, cut, make_topology,
                              place_greedy, QuasiSerdesConfig)
from repro_torch.launch.train import run
from repro_torch.telemetry import Tracer, chrome_trace, trace_stats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # --- 1. phase-1: the application as communicating processing elements -------
    g = TaskGraph("pipeline")
    g.add(PE("scale", lambda x: {"y": x * 2.0}, (Port("x", (8,)),), (Port("y", (8,)),)))
    g.add(PE("shift", lambda y: {"z": y + 1.0}, (Port("y", (8,)),), (Port("z", (8,)),)))
    g.add(PE("square", lambda z: {"o": z * z}, (Port("z", (8,)),), (Port("o", (8,)),)))
    g.connect("scale.y", "shift.y")
    g.connect("shift.z", "square.z")
    inputs = {"scale.x": torch.arange(8.0, device=dev)}

    # --- 2. map onto a 2x2 mesh NoC and execute ---------------------------------
    topo = make_topology("mesh", 4)
    placement = place_greedy(g, topo)
    ex = NoCExecutor(g, topo, placement=placement, device=dev)
    out, stats = ex.run(inputs)
    print("single-pod NoC result:", out["square.o"].cpu().numpy()[:4], "...")
    print("  network stats:", stats.as_dict())

    # --- 3. cut across two pods (quasi-SERDES on the cut links) -----------------
    plan = cut(g, placement, pod_of_node=[0, 0, 1, 1],
               serdes_cfg=QuasiSerdesConfig(wire_bits=16, lanes=8, compress="bf16"))
    ex2 = NoCExecutor(g, topo, placement=placement, plan=plan, device=dev)
    out2, stats2 = ex2.run(inputs)
    assert torch.allclose(out["square.o"], out2["square.o"], atol=1e-2)
    print("2-pod partition identical; cross-pod msgs:", stats2.cross_pod_msgs,
          "wire bytes:", stats2.cross_pod_wire_bytes)

    # --- 4. observe a run: tracing is opt-in and proof-carrying ------------------
    tr = Tracer()                       # bounded ring buffer of structured events
    ex3 = NoCExecutor(g, topo, placement=placement, trace=tr, device=dev)
    out3, stats3 = ex3.run(inputs)
    assert trace_stats(tr).as_dict() == stats3.as_dict()   # bit-exact round trip
    doc = chrome_trace(tr)              # load traceEvents in ui.perfetto.dev
    print("traced run:", len(tr), "events ->", len(doc["traceEvents"]),
          "Perfetto events; trace aggregation reproduces NoCStats bit-exactly")

    # --- 5. the LM generalization: train a reduced llama for 100 steps ----------
    print("\ntraining reduced llama3.2-1b (same framework, LM substrate):")
    losses = run(["--arch", "llama3.2-1b", "--smoke", "--steps", "100",
                  "--batch", "8", "--seq", "32", "--lr", "2e-3", "--log-every", "25",
                  "--device", args.device])
    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f}  (decreasing => learning)")


if __name__ == "__main__":
    main()
