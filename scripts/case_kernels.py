#!/usr/bin/env python3
"""Time the three case-study kernels at the main path's shapes, on one GPU.

    python3 scripts/case_kernels.py [--src DIR] [--label NAME] [--flush write|read] [--trace]

Builds the inputs that ``chip_smoke.py`` gives ``gf2_bmvm`` (BMVM n=4096, k=8,
M=64: LUT (512, 256, 512) int32), ``minsum_check`` (LDPC 7168 bits × 512
codewords: (3670016, 3)) and ``particle_histogram`` (4096 particles of a
64×64 ROI, 16 bins) from the same seeds, checks each kernel against its plain
version and against a second launch, and times it as ``chip_smoke.py`` does:
median of 25 launches bracketed by CUDA events, the L2 overwritten and the
card held in a spin before each start.  One JSON line per kernel, with the
bound that ``chip_smoke.py`` computes for it.

- ``--src`` imports ``repro_torch`` from another checkout's ``src`` (an
  unpacked older commit, say), so that two versions of the kernels are timed
  in turns in one call on one card.
- ``--flush read`` overwrites the L2 by reading a 256 MiB buffer instead of
  writing one (``chip_smoke.py``'s way), so that no dirty line of the flush
  is written back to memory while the kernel runs.
- ``--trace`` also prints the device activities of one cold call
  (``torch.profiler``).
"""
import argparse
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class ReadFlush:
    """Stands in for the flush buffer of ``chip_smoke.timed``: its ``zero_``
    reads the buffer, leaving the L2 full of clean lines."""

    def __init__(self, buf):
        self.buf = buf

    def zero_(self):
        self.buf.max()


def trace(torch, fn, flush):
    """(name, device µs) of each device activity of one call of ``fn``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    flush.zero_()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.name[:60], e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == DeviceType.CUDA]


def main():
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(HERE, "src"))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--flush", choices=("write", "read"), default="write")
    ap.add_argument("--trace", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("case_kernels: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.abspath(args.src))
    import chip_smoke as cs
    from repro_torch.apps import bmvm, ldpc
    from repro_torch.apps import particle_filter as pf
    from repro_torch.kernels import _build, ops, ref

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    lib = _build.library()
    print(f"{args.label}: {smi}; kernels from {os.path.relpath(lib.path, HERE)} "
          f"built in {lib.build_seconds:.2f} s")
    for kname, info in cs.ptxas_report(lib.log).items():
        if not kname.startswith("flash"):
            print(f"  ptxas: {kname}: {info}")

    g = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(0)
    bcfg = bmvm.BMVMConfig(n=4096, k=8, fold=1)
    A = torch.randint(0, 2, (bcfg.n, bcfg.n), generator=g, device=dev, dtype=torch.uint8)
    V = torch.randint(0, 2, (64, bcfg.n), generator=g, device=dev, dtype=torch.uint8)
    lut = bmvm.preprocess(A, bcfg)
    vw = ref.gf2_pack_vector(V, bcfg.k)
    H = ldpc.pg_ldpc_H(copies=1024)
    idx = ldpc.build_edge_index(H)
    llr = torch.as_tensor(ldpc.awgn_llr(np.zeros((512, H.shape[1]), np.int8), 3.0, rng),
                          device=dev)
    u = llr[:, torch.as_tensor(idx.edge_bit, device=dev)].reshape(-1, 3).contiguous()
    pcfg = pf.PFConfig(img=512, roi=64, n_particles=4096, n_bins=16, seed=0)
    frames, _ = pf.synth_video(pcfg, 16, rng)
    frames_t = torch.as_tensor(frames, device=dev)
    c0 = pf._first_center(frames_t[0])
    ref_hist = pf.reference_histogram(frames_t[0], c0, pcfg)
    parts = (c0[None] + torch.randn((pcfg.n_particles, 2), generator=g, device=dev)
             * pcfg.sigma_motion).clamp(pcfg.roi // 2, pcfg.img - pcfg.roi // 2 - 1)
    bins = pf._roi_bins(frames_t[1], parts, pcfg)
    dw = pf.distance_weights(pcfg)

    hbm = cs.hbm_rate(name)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    if args.flush == "read":
        flush = ReadFlush(flush.zero_())
    C, P, R = lut.shape
    M = vw.shape[0]
    rows = torch.unique(torch.arange(C, device=dev)[None, :] * P + vw).numel()
    N, px = bins.shape
    nb = pcfg.n_bins
    n_chk, deg = u.shape
    cases = [
        ("gf2_bmvm", lambda: ops.gf2_bmvm(lut, vw),
         lambda: ops.gf2_bmvm(lut, vw, use_kernel=False),
         rows * R * 4 + M * C * 4 + M * R * 4, M * C * R / cs.INT32_OPS_PER_S),
        ("minsum_check", lambda: ops.minsum_check(u),
         lambda: ops.minsum_check(u, use_kernel=False),
         2 * n_chk * deg * 4, 8 * n_chk * deg / cs.FP32_OPS_PER_S),
        ("particle_histogram", lambda: ops.particle_histogram(bins, dw, ref_hist),
         lambda: ops.particle_histogram(bins, dw, ref_hist, use_kernel=False),
         N * px * 4 + px * 4 + nb * 4 + N * nb * 4 + N * 4,
         (N * px + 4 * N * nb) / cs.FP32_OPS_PER_S),
    ]
    def outputs(fn):
        out = fn()
        return (out,) if torch.is_tensor(out) else out

    for kname, kfn, pfn, nbytes, t_ops in cases:
        got, want, again = outputs(kfn), outputs(pfn), outputs(kfn)
        err = max((a.double() - b.double()).abs().max().item() for a, b in zip(got, want))
        repeat = all(torch.equal(a, b) for a, b in zip(got, again))
        ms = cs.timed(torch, kfn, flush=flush)
        bound_ms = max(nbytes / hbm, t_ops) * 1e3
        activities = trace(torch, kfn, flush) if args.trace else None
        print(json.dumps(dict(label=args.label, kernel=kname, flush=args.flush, ms=ms,
                              bound_ms=bound_ms, activities=activities,
                              share_of_bound=bound_ms / ms, max_abs_err=err, repeats=repeat,
                              device=name, power_limit=smi.split(", ")[-1])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
