#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``
with ``nvcc``, then runs twelve phases and raises on any failure:

1. environment — the card, its power limit, torch/CUDA versions, build time,
                 ptxas's registers, spills and shared memory of each kernel;
2. kernels     — each kernel against its plain PyTorch version on the card, at
                 the shape sweeps of tests/test_kernels.py, the bf16 grid of
                 tests/test_torch_cuda.py for the tensor-core flash kernel,
                 and the shapes the main path gives it, timed with CUDA
                 events (the flash combine kernel alone too);
3. case studies at full size through the apps' entry points — BMVM n=4096,
   LDPC 7168-bit code × 512 codewords, particle filter 512² video × 4096
   particles — with the kernels' launch counters reset just before and read
   just after;
4. the ``sim`` NoC engine on the card — golden NoCStats, BMVM on four
   topologies, the particle-filter NoC graph, and a 64-node BMVM NoC;
5. whisper-large-v3 at full width (32 + 32 layers, d_model 1280, vocab
   51866, 1500 encoder frames) with ``attn_impl="flash"``, random weights from
   a seed: 16 requests served at batch 4 (prompt 32, 16 generated tokens)
   through ``launch.serve.serve_batch`` with the launch counters reset just
   before and read just after (64 flash calls and 32 combines per prefill,
   none per decode step); then every flash call of a prefill held to the
   plain version on its own inputs, the end-to-end gap to the plain path
   (``attn_impl="naive"``) printed, and the SMOKE config held to the CPU;
6. partitioned execution on the card — the BMVM NoC cut into 2 and 4 pods over
   quasi-SERDES bridges (table 8's gates: every wire width x compression,
   outputs and non-bridge NoCStats equal to the uncut run, analytic bridge
   stats equal to the simulator, every counter equal to the CPU run), the
   64-node BMVM n=1024 NoC cut in 2 and 4 pods, the LDPC and particle-filter
   NoCs cut, the seed loop ``sim_python`` against ``sim``, the placement
   search and pod-cut co-optimizer, and the serdes endpoints on the card;
7. the buffered wormhole switch and the static verifier on the card — golden
   buffered NoCStats (Fano LDPC, BMVM n=64), the 64-node BMVM n=1024 NoC
   uncut and cut into 2 pods equal to ``software_ref``, the ``sim`` run and
   the reference's counters, its one NOC005 warning, ``run_batch`` and the
   particle-filter NoC in ``mode="buffered"``, payloads delivered on the
   card, both deadlock paths of the 8-node ring at one VC, and the
   ``python -m repro_torch.analysis`` CLI;
8. telemetry on the card — the traced app grid (BMVM, LDPC, PF x sim,
   buffered, bridged on the mesh, and ``sim_python`` uncut and cut) with
   ``trace_stats`` equal to NoCStats and every event equal to the port's CPU
   run; the 64-node BMVM n=1024 buffered NoC traced uncut and in 2 pods
   (``trace_stats`` equal to the reference's counters, the latency profile
   exact, the Perfetto export valid and round-tripping, one ``flit`` event
   per link move under ``detail="flits"``, nothing allocated when untraced,
   traced and untraced walls); the ``python -m repro_torch.telemetry`` CLI;
   the engine's ``noc.*`` metrics; and ``serve_batch`` with a metrics
   registry at whisper-large-v3 FULL on phase 5's traffic (launch counters
   reset just before, tokens equal to phase 5's, samples against the synced
   wall), then ``launch.serve --smoke --metrics``;
9. the dense family on the card — llama3.2-1b and gemma-7b SMOKE with
   ``attn_impl="flash"`` held to the CPU (logits and three train steps'
   losses); llama3.2-1b FULL (16 layers, d_model 2048, 32:8 heads of 64,
   vocab 128256; random weights from a seed) served from a bf16 copy, 16
   requests at batch 4 (prompt 32, 16 tokens) with no flash launch (a cache
   takes the plain path); trained 6 steps at batch 8 x seq 128 through
   ``launch.steps.make_train_step`` with flash launched 6 x 16 x 2 times
   (remat), every flash call of a training forward held to the plain
   version; checkpoint and restart through ``launch.train.run``; and the
   train and serve CLIs with their default arch;
10. the MoE, MLA and vlm families on the card — phi3.5-moe and qwen3-moe (the
   MoE layer on the one-rank gather engine at flit buffer depth 2),
   minicpm3-4b and internvl2-1b at SMOKE held to the CPU (forward logits and
   MoE stats, serve tokens, three train steps); at full width with random
   weights from a seed, each served 16 requests at batch 4 (prompt 32, 16
   tokens) from bf16: phi3.5-moe at 16 of 32 layers, qwen3-moe (128 experts
   top-8) at 4 of 94, minicpm3-4b and internvl2-1b (256-patch prefix) uncut;
   and trained 6 steps at batch 8 x seq 128: phi3.5-moe at 2 layers,
   minicpm3-4b at 31 of 62, internvl2-1b uncut (flash over 384 positions),
   with every flash call of a training forward held to the plain version.
   Phase 2 times flash at these families' GQA ratios (4, 16, 7) beside SDPA;
11. the hybrid and xlstm families on the card — jamba-v0.1-52b and xlstm-350m
   at SMOKE held to the CPU (forward logits, serve tokens, three train
   steps); the Mamba, mLSTM and sLSTM mixers alone at full width (batch 4 x
   seq 128, chunked and one decode step) held to the CPU; jamba at full width
   served at 16 of 32 layers from bf16 (two whole periods, 26.05 B params)
   and trained 6 steps at batch 8 x seq 128 on the 2-layer cut of one Mamba
   and one attention layer (flash launched 6 x 1 x 2 times, every call of a
   training forward held to the plain version); xlstm-350m served and
   trained uncut (no attention, no flash).  Phase 2's flash row at (8, 32:8,
   128, 128, 128) is jamba's training shape too;
12. device-mesh execution on the card — 8 ranks started with ``spawn``, joined
   over gloo through a ``FileStore``, every rank computing on the card (they
   share it; gloo's transfers are staged through the host): the route
   programs on their own axes and linearized, the handwritten schedules and
   the bridged programs (2-pod, 4-pod, interleaved cuts) on a seeded (8, 8,
   4096) cube equal to the transpose on the four topologies;
   ``NoCExecutor(mode="spmd")`` equal to ``sim`` in outputs and every
   ``NoCStats`` field (BMVM n=64 on the four topologies and cut into 2 and 4
   pods, its golden stats, ``run_batch``, the PF NoC), and the golden Fano
   LDPC run in a world of 16 ranks (its 16-node mesh); ``bmvm.iterate_spmd``
   at phase 3's BMVM size (n=4096, M=64, r=4) on the four topologies equal
   to the direct GF(2) product iterated, with the ``gf2_bmvm`` kernel held to
   its plain version at the shard's shape and launched in every rank (counts
   reset just before and read just after), the walls of the call and of its
   transport, and the bytes staged through the host per iteration.

Prints the ``nvidia-smi`` name/power-limit line, one ``{"kernels": [...]}``
JSON line and, last, ``{"ok": true, "device": {...}}``.  Exits non-zero with
no result when no CUDA device is present or the port is not beside it.
"""
import datetime
import json
import os
import pickle
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = "src/repro_torch/kernels/csrc/kernels.cu"

# Published H100 peaks (NVIDIA data sheet; dense, at the 700 W limit).  Memory
# rate by variant; int32 ALU rate = 132 SMs x 64 INT32 lanes x 1.98 GHz boost.
HBM_BYTES_PER_S = {"PCIe": 2.0e12, "NVL": 3.9e12, "default": 3.35e12}
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
CASE_STUDY_KERNELS = ("gf2_bmvm", "minsum_check", "particle_histogram")   # phase 3
INT32_OPS_PER_S = 132 * 64 * 1.98e9

GOLDEN_LDPC_FANO = dict(
    waves=20, rounds=60, link_bytes=92160, payload_bytes=840, flits=420,
    cross_pod_msgs=0, cross_pod_wire_bytes=0, cross_pod_beats=0,
    bridge_beats=0, bridge_wire_bytes=0, bridge_stall_rounds=0,
    bridge_peak_fifo=0, switch_cycles=0, switch_stall_cycles=0,
    switch_arb_losses=0, switch_max_queue=0, switch_peak_link_flits=0)
GOLDEN_BMVM_64 = dict(
    waves=4, rounds=8, link_bytes=5632, payload_bytes=256, flits=128,
    cross_pod_msgs=0, cross_pod_wire_bytes=0, cross_pod_beats=0,
    bridge_beats=0, bridge_wire_bytes=0, bridge_stall_rounds=0,
    bridge_peak_fifo=0, switch_cycles=0, switch_stall_cycles=0,
    switch_arb_losses=0, switch_max_queue=0, switch_peak_link_flits=0)
# mode="buffered": tests/test_noc_engine.py's golden dicts, and the reference's
# counters of BMVM n=1024 fold=4 on the 8x8 mesh, r=2 (they depend on the
# layout only), uncut and cut into 2 pods
GOLDEN_LDPC_FANO_BUFFERED = dict(
    GOLDEN_LDPC_FANO, rounds=190, link_bytes=2600, switch_cycles=190,
    switch_stall_cycles=520, switch_arb_losses=40, switch_max_queue=2,
    switch_peak_link_flits=13)
GOLDEN_BMVM_64_BUFFERED = dict(
    GOLDEN_BMVM_64, rounds=90, link_bytes=640, switch_cycles=90,
    switch_stall_cycles=304, switch_arb_losses=28, switch_max_queue=4,
    switch_peak_link_flits=6)
BMVM_N1024_BUFFERED = dict(
    GOLDEN_BMVM_64, rounds=3206, link_bytes=217088, payload_bytes=32768, flits=16384,
    switch_cycles=3206, switch_stall_cycles=123576, switch_arb_losses=2344,
    switch_max_queue=4, switch_peak_link_flits=58)
BMVM_N1024_BUFFERED_2PODS = dict(
    BMVM_N1024_BUFFERED, cross_pod_msgs=2048, cross_pod_wire_bytes=32768,
    cross_pod_beats=16384, bridge_beats=14336, bridge_wire_bytes=229376,
    bridge_stall_rounds=882, bridge_peak_fifo=64)
NOC005_N1024 = ("NOC005 warning [NoCConfig.switch_buffer_depth]: wave 0: input FIFO "
                "(24->32 vc0) takes 1024 flits against depth 4 — credit stalls predicted "
                "(correctness unaffected)")


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def hbm_rate(name):
    for key, rate in HBM_BYTES_PER_S.items():
        if key in name:
            return rate
    return HBM_BYTES_PER_S["default"]


def timed(torch, fn, reps=25, warmup=3, flush=None):
    """Median milliseconds of ``fn`` over ``reps`` launches, each bracketed by
    CUDA events, with the L2 cache overwritten before each (cold inputs).
    A spin of about 1 ms on the card precedes each start event, so the host
    has queued all of ``fn``'s launches before the card reaches it: the
    events time the device's work, not the host's Python around it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def ptxas_report(log):
    """Kernel (with its template arguments) -> ptxas's registers, spills and
    static shared memory, from ``nvcc -Xptxas -v`` output."""
    names = {"13__nv_bfloat16": "bf16", "6__half": "fp16", "f": "float"}
    report, current = {}, None
    for line in log.splitlines():
        found = re.search(r"Compiling entry function '.*?((?:gf2_bmvm|minsum_check|particle_"
                          r"histogram|flash_attention_(?:f32|tc|combine))_kernel)(I.*?E)?E", line)
        if found:
            args = re.findall(r"Li(\d+)E|Lb([01])E|(13__nv_bfloat16|6__half|f)(?=E|L)",
                              found.group(2) or "")
            targs = ", ".join(n or ("false", "true")[int(b)] if n or b else names[t]
                              for n, b, t in args)
            current = found.group(1) + (f"<{targs}>" if targs else "")
            report[current] = ""
        elif current and ("spill" in line or "Used" in line):
            report[current] = (report[current] + "; " + line.split(":", 1)[-1].strip()
                               ).strip("; ")
    return report


def wall(torch, fn):
    """(result, host seconds) of ``fn`` ending in a device synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.apps import bmvm, ldpc
    from repro_torch.apps import particle_filter as pf
    import torch.nn.functional as F
    from repro_torch.kernels import _build, flash_attention, histogram, ops, ref

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)

    # -- phase 1: environment -------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
          f"{sys.version.split()[0]}, device {name}, count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off for matmul and cuDNN: float32 products run in full float32")
    hbm = hbm_rate(name)
    lib = _build.library()
    print(f"kernels built in {lib.build_seconds:.2f} s -> {os.path.relpath(lib.path, HERE)}")
    for kname, info in ptxas_report(lib.log).items():
        dyn = ""
        if kname.startswith("flash_attention_tc_kernel"):
            dp = int(kname.rstrip(">").split(", ")[-1])
            dyn = f", {lib.cdll.flash_attention_tc_smem_bytes(dp)} bytes dynamic shared memory"
        print(f"  ptxas: {kname}: {info}{dyn}")

    # -- inputs of the main path, made from seeds --------------------------------
    g = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(0)
    bcfg = bmvm.BMVMConfig(n=4096, k=8, fold=1)
    A = torch.randint(0, 2, (bcfg.n, bcfg.n), generator=g, device=dev, dtype=torch.uint8)
    V = torch.randint(0, 2, (64, bcfg.n), generator=g, device=dev, dtype=torch.uint8)
    lut, secs = wall(torch, lambda: bmvm.preprocess(A, bcfg))
    print(f"BMVM LUT {tuple(lut.shape)} int32 ({lut.numel() * 4 / 2**20:.0f} MiB) "
          f"built in {secs:.3f} s")
    H = ldpc.pg_ldpc_H(copies=1024)
    idx = ldpc.build_edge_index(H)
    llr = ldpc.awgn_llr(np.zeros((512, H.shape[1]), np.int8), 3.0, rng)
    pcfg = pf.PFConfig(img=512, roi=64, n_particles=4096, n_bins=16, seed=0)
    frames, truth = pf.synth_video(pcfg, 16, rng)

    # kernel-shaped inputs as the main path builds them
    vw = ref.gf2_pack_vector(V, bcfg.k)
    llr_t = torch.as_tensor(llr, device=dev)
    u_main = llr_t[:, torch.as_tensor(idx.edge_bit, device=dev)].reshape(-1, 3).contiguous()
    frames_t = torch.as_tensor(frames, device=dev)
    c0 = pf._first_center(frames_t[0])
    ref_hist = pf.reference_histogram(frames_t[0], c0, pcfg)
    parts = (c0[None] + torch.randn((pcfg.n_particles, 2), generator=g, device=dev)
             * pcfg.sigma_motion).clamp(pcfg.roi // 2, pcfg.img - pcfg.roi // 2 - 1)
    bins_main = pf._roi_bins(frames_t[1], parts, pcfg)
    dw = pf.distance_weights(pcfg)

    # -- phase 2: kernels against their plain versions ----------------------------
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    for n, k, m in [(16, 4, 1), (32, 4, 3), (64, 8, 5), (128, 4, 2), (128, 8, 8)]:
        a = torch.randint(0, 2, (n, n), generator=g, device=dev, dtype=torch.uint8)
        lt = ref.gf2_preprocess(a, k)
        w = ref.gf2_pack_vector(torch.randint(0, 2, (m, n), generator=g, device=dev,
                                              dtype=torch.uint8), k)
        check(torch.equal(ops.gf2_bmvm(lt, w), ops.gf2_bmvm(lt, w, use_kernel=False)),
              f"gf2_bmvm differs at n={n} k={k} m={m}")
    for shape in [(1, 3), (7, 3), (64, 6), (200, 4), (1000, 8)]:
        u = torch.randn(shape, generator=g, device=dev) * 4
        err = (ops.minsum_check(u) - ops.minsum_check(u, use_kernel=False)).abs().max().item()
        check(err <= 1e-6, f"minsum_check differs by {err} at {shape}")
    # degrees past 32 and the bf16/fp16 instances: bit for bit in every dtype
    for shape in [(100, 33), (513, 64), (20, 1000), (3, 20000)]:
        for dt in (torch.float32, torch.bfloat16, torch.float16):
            u = (torch.randn(shape, generator=g, device=dev) * 4).to(dt)
            out = ops.minsum_check(u)
            check(out.dtype == dt and torch.equal(out, ops.minsum_check(u, use_kernel=False)),
                  f"minsum_check {dt} differs from its plain version at {shape}")
    # gf2_bmvm on random int32 LUTs (its contract): C not a multiple of the
    # chunk, R not a multiple of 4, and a LUT 4 bytes past a 16-byte boundary
    for m, c, r in [(m, c, r) for m in (1, 64) for c in (37, 300, 1001) for r in (1, 3, 5, 512)]:
        lt = torch.randint(-2**31, 2**31 - 1, (c * 16 * r + 1,), generator=g, device=dev,
                           dtype=torch.int32)
        w = torch.randint(0, 16, (m, c), generator=g, device=dev, dtype=torch.int32)
        for lt_ in (lt[:-1].view(c, 16, r), lt[1:].view(c, 16, r)):
            check(torch.equal(ops.gf2_bmvm(lt_, w), ops.gf2_bmvm(lt_, w, use_kernel=False)),
                  f"gf2_bmvm differs on a random LUT at M={m} C={c} R={r} "
                  f"(base offset {lt_.data_ptr() % 16} bytes)")
    for N, px, B in [(1, 64, 8), (10, 300, 16), (33, 517, 12), (8, 1024, 32)]:
        b = torch.randint(0, B, (N, px), generator=g, device=dev, dtype=torch.int32)
        w = torch.rand(px, generator=g, device=dev) * 0.9 + 0.1
        rh = torch.rand(B, generator=g, device=dev)
        rh = rh / rh.sum()
        hk, bk = ops.particle_histogram(b, w, rh)
        hp, bp = ops.particle_histogram(b, w, rh, use_kernel=False)
        err = max((hk - hp).abs().max().item(), (bk - bp).abs().max().item())
        check(err <= 1e-5, f"particle_histogram differs by {err} at {(N, px, B)}")
    # particle_histogram over bin counts, rows that do not start on 16 bytes
    # (px % 4 != 0), one to 4096 particles, bins outside [0, n_bins), and bins
    # and weights 4 bytes past a 16-byte boundary; each repeated bit for bit
    for N, px, B in [(N, px, B) for N in (1, 5, 4096) for px in (1, 3, 517, 4096)
                     for B in (1, 7, 16, 32)]:
        flat = torch.randint(-2, B + 2, (N * px + 1,), generator=g, device=dev, dtype=torch.int32)
        wf = torch.rand(px + 1, generator=g, device=dev) * 0.9 + 0.1
        rh = torch.rand(B, generator=g, device=dev)
        rh = rh / rh.sum()
        views = [(flat[:-1].view(N, px), wf[:-1])]
        if B == 16:
            views.append((flat[1:].view(N, px), wf[1:]))
        for b, w in views:
            hk, bk = ops.particle_histogram(b, w, rh)
            hp, bp = ops.particle_histogram(b, w, rh, use_kernel=False)
            err = max((hk - hp).abs().max().item(), (bk - bp).abs().max().item())
            h2, b2 = ops.particle_histogram(b, w, rh)
            check(err <= 1e-5 and torch.equal(hk, h2) and torch.equal(bk, b2),
                  f"particle_histogram differs by {err} (or does not repeat) at {(N, px, B)} "
                  f"(base offsets {b.data_ptr() % 16}, {w.data_ptr() % 16} bytes)")
    # more bins than lanes: a warp's columns take 1 KB a bin, so a block holds
    # fewer warps (down to one at 1816 bins) and the weights may stay unstaged
    for N, px, B in [(5, 517, 33), (4096, 517, 64), (64, 4096, 100), (33, 517, 256),
                     (7, 4096, 1816)]:
        b = torch.randint(-2, B + 2, (N, px), generator=g, device=dev, dtype=torch.int32)
        w = torch.rand(px, generator=g, device=dev) * 0.9 + 0.1
        rh = torch.rand(B, generator=g, device=dev)
        rh = rh / rh.sum()
        hk, bk = ops.particle_histogram(b, w, rh)
        hp, bp = ops.particle_histogram(b, w, rh, use_kernel=False)
        err = max((hk - hp).abs().max().item(), (bk - bp).abs().max().item())
        h2, b2 = ops.particle_histogram(b, w, rh)
        check(err <= 1e-5 and torch.equal(hk, h2) and torch.equal(bk, b2),
              f"particle_histogram differs by {err} (or does not repeat) at {(N, px, B)}")
    print("kernel sweeps of tests/test_kernels.py and the edge cases of tests/test_torch_cuda.py "
          "(random gf2 LUTs, unaligned bases, 1-1816 bins, ragged rows, min-sum degrees up to "
          "20000 in float32/bf16/fp16): the three case-study kernels agree with their plain "
          "versions")

    kernels = []

    def measure(kname, err, tol, kfn, pfn, nbytes, nops, ops_rate, lfn=None):
        check(err <= tol, f"{kname} differs by {err} (tolerance {tol}) at the main-path shape")
        ms, plain_ms = timed(torch, kfn, flush=flush), timed(torch, pfn, flush=flush)
        library_ms = None if lfn is None else timed(torch, lfn, flush=flush)
        t_bytes, t_ops = nbytes / hbm * 1e3, nops / ops_rate * 1e3
        lib_txt = "" if library_ms is None else f", library {library_ms:.4f} ms"
        print(f"{kname}: max_abs_err {err:g} (tol {tol:g}), kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms{lib_txt}, bound {max(t_bytes, t_ops) * 1e3:.2f} us "
              f"({nbytes / 2**20:.1f} MiB, {nops:.3g} ops)")
        return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                    bound_by="bytes" if t_bytes >= t_ops else "operations",
                    library_ms=library_ms, bytes=nbytes, ops=nops, tolerance=tol)

    def report(kname, replaces, *args, **kw):
        kernels.append(dict(name=kname, route="cuda", source=SOURCE, replaces=replaces,
                            launches=None, **measure(kname, *args, **kw)))

    C, P, R = lut.shape
    M = vw.shape[0]
    rows = torch.unique(torch.arange(C, device=dev)[None, :] * P + vw).numel()
    out_k, out_p = ops.gf2_bmvm(lut, vw), ops.gf2_bmvm(lut, vw, use_kernel=False)
    err = (out_k.long() - out_p.long()).abs().max().item()
    report("gf2_bmvm", "src/repro/kernels/gf2_bmvm.py:42", err, 0,
           lambda: ops.gf2_bmvm(lut, vw), lambda: ops.gf2_bmvm(lut, vw, use_kernel=False),
           rows * R * 4 + M * C * 4 + M * R * 4, M * C * R, INT32_OPS_PER_S)

    n_chk, deg = u_main.shape
    err = (ops.minsum_check(u_main) - ops.minsum_check(u_main, use_kernel=False)).abs().max().item()
    report("minsum_check", "src/repro/kernels/minsum.py:31", err, 1e-6,
           lambda: ops.minsum_check(u_main), lambda: ops.minsum_check(u_main, use_kernel=False),
           2 * n_chk * deg * 4, 8 * n_chk * deg, FP32_OPS_PER_S)
    # the same elements at degree 64, and the main shape in bf16
    minsum_rows = []
    for shape, dt in (((n_chk * deg // 64, 64), torch.float32), ((n_chk, deg), torch.bfloat16)):
        u_x = u_main.reshape(shape).to(dt)
        err = (ops.minsum_check(u_x).float() - ops.minsum_check(u_x, use_kernel=False).float()
               ).abs().max().item()
        row = measure(f"minsum_check {shape} {dt}", err, 1e-6 if dt == torch.float32 else 0,
                      lambda: ops.minsum_check(u_x),
                      lambda: ops.minsum_check(u_x, use_kernel=False),
                      2 * u_x.numel() * u_x.element_size(), 8 * u_x.numel(), FP32_OPS_PER_S)
        minsum_rows.append(dict(row, shape=list(shape), dtype=str(dt).split(".")[-1]))
    kernels[-1]["other_shapes"] = minsum_rows

    N, px = bins_main.shape
    nb = pcfg.n_bins
    hk, bk = ops.particle_histogram(bins_main, dw, ref_hist)
    hp, bp = ops.particle_histogram(bins_main, dw, ref_hist, use_kernel=False)
    err = max((hk - hp).abs().max().item(), (bk - bp).abs().max().item())
    h2, b2 = ops.particle_histogram(bins_main, dw, ref_hist)
    check(torch.equal(hk, h2) and torch.equal(bk, b2),
          "particle_histogram does not repeat bit for bit at the main-path shape")
    check(torch.equal(out_k, ops.gf2_bmvm(lut, vw)),
          "gf2_bmvm does not repeat bit for bit at the main-path shape")
    print(f"particle_histogram {tuple(bins_main.shape)} and gf2_bmvm {tuple(lut.shape)}: a second "
          "launch repeats the first bit for bit")
    report("particle_histogram", "src/repro/kernels/histogram.py:48", err, 1e-5,
           lambda: ops.particle_histogram(bins_main, dw, ref_hist),
           lambda: ops.particle_histogram(bins_main, dw, ref_hist, use_kernel=False),
           N * px * 4 + px * 4 + nb * 4 + N * nb * 4 + N * 4, N * px + 4 * N * nb,
           FP32_OPS_PER_S)
    # the main shape's bin map at 64 and 256 bins (fewer warps a block, w
    # unstaged at 256)
    hist_rows = []
    for nb_x in (64, 256):
        b_x = torch.randint(0, nb_x, (N, px), generator=g, device=dev, dtype=torch.int32)
        r_x = torch.rand(nb_x, generator=g, device=dev)
        r_x = r_x / r_x.sum()
        hk, bk = ops.particle_histogram(b_x, dw, r_x)
        hp, bp = ops.particle_histogram(b_x, dw, r_x, use_kernel=False)
        err = max((hk - hp).abs().max().item(), (bk - bp).abs().max().item())
        del hp, bp
        row = measure(f"particle_histogram {(N, px)} {nb_x} bins", err, 1e-5,
                      lambda: ops.particle_histogram(b_x, dw, r_x),
                      lambda: ops.particle_histogram(b_x, dw, r_x, use_kernel=False),
                      N * px * 4 + px * 4 + nb_x * 4 + N * nb_x * 4 + N * 4,
                      N * px + 4 * N * nb_x, FP32_OPS_PER_S)
        hist_rows.append(dict(row, shape=[N, px], n_bins=nb_x,
                              launch_shape=list(histogram.launch_shape(N, px, nb_x,
                                                                  _build.sm_count(dev)))))
    kernels[-1]["other_shapes"] = hist_rows

    # flash attention: the sweep of tests/test_kernels.py (f32, both masks), a
    # bf16 case, then whisper's two shapes in bf16 (non-causal): the encoder's
    # self-attention and the decoder's cross-attention at prompt length 32
    def qkv(B, Hq, Hkv, S, T, D, dtype):
        return [torch.randn(shape, generator=g, device=dev).to(dtype)
                for shape in ((B, Hq, S, D), (B, Hkv, T, D), (B, Hkv, T, D))]

    def flash_err(q, k, v, causal):
        out = ops.flash_attention(q, k, v, causal, True)
        plain = flash_attention.flash_attention_plain(q, k, v, causal)
        return (out.float() - plain.float()).abs().max().item()

    for shape in [(1, 4, 2, 64, 64, 32), (2, 2, 2, 37, 37, 16), (1, 8, 2, 16, 128, 32),
                  (1, 2, 1, 128, 256, 64), (2, 4, 4, 100, 100, 8)]:
        for causal in (True, False):
            err = flash_err(*qkv(*shape, torch.float32), causal)
            check(err <= 3e-5, f"flash_attention differs by {err} at {shape} causal={causal}")
    err = flash_err(*qkv(1, 2, 2, 32, 32, 16, torch.bfloat16), True)
    check(err <= 3e-2, f"flash_attention bf16 differs by {err}")
    print("flash_attention sweep of tests/test_kernels.py (f32 CUDA-core kernel, atol 3e-5) "
          "and bf16 case (atol 3e-2): the kernels agree with their plain version")
    # the tensor-core kernel over the grid of tests/test_torch_cuda.py: head
    # dims of both widths and two that take the wrapper's padding, lengths from
    # 1 to 1500, GQA (4 query heads on 2), both masks; blind rows exactly zero
    worst, n_cases = 0.0, 0
    for D_ in (16, 40, 64, 100, 128):
        for S_ in (1, 37, 64, 1500):
            for T_ in (1, 37, 64, 1500):
                q, k, v = qkv(1, 4, 2, S_, T_, D_, torch.bfloat16)
                for causal in (True, False):
                    out = ops.flash_attention(q, k, v, causal, True)
                    plain = flash_attention.flash_attention_plain(q, k, v, causal)
                    err = (out.float() - plain.float()).abs().max().item()
                    blind = max(S_ - T_, 0) if causal else 0
                    check(err <= 3e-2 and not out[:, :, :blind].any(),
                          f"flash_attention bf16 differs by {err} at D={D_} S={S_} T={T_} "
                          f"causal={causal} (or a blind row is not zero)")
                    worst, n_cases = max(worst, err), n_cases + 1
    q, k, v = qkv(2, 8, 2, 150, 300, 64, torch.float16)
    err16 = max(flash_err(q, k, v, c) for c in (True, False))
    check(err16 <= 3e-2, f"flash_attention fp16 differs by {err16}")
    # head dims past 128: the f32 kernel's 8-lane instance (3e-5) and the
    # tensor-core kernel's DP = 256 instance (3e-2), each counted as such
    wide = {}
    for D_ in (160, 192, 256):
        for dt, tol, inst in ((torch.float32, 3e-5, "f32_g8"), (torch.bfloat16, 3e-2, "tc256")):
            for S_, T_ in ((37, 64), (130, 129), (1, 1500)):
                for causal in (True, False):
                    before = flash_attention.flash_attention.instance_launches.get(inst, 0)
                    err = flash_err(*qkv(1, 4, 2, S_, T_, D_, dt), causal)
                    check(err <= tol and flash_attention.flash_attention.instance_launches[inst]
                          == before + 1, f"flash_attention {dt} differs by {err} at D={D_} "
                          f"S={S_} T={T_} causal={causal} (or did not take {inst})")
                    wide[(D_, str(dt))] = max(wide.get((D_, str(dt)), 0.0), err)
    print("flash_attention at D = 160/192/256 (f32 8-lane instance, atol 3e-5; bf16 DP = 256 "
          "tensor-core instance, atol 3e-2): worst max_abs_err " +
          ", ".join(f"D={d} {t.split('.')[-1]} {e:.2e}" for (d, t), e in sorted(wide.items())))
    print(f"flash_attention bf16 grid ({n_cases} cases, D in 16/40/64/100/128, S and T in "
          f"1/37/64/1500, GQA 4:2, both masks): worst max_abs_err {worst:.3e} (atol 3e-2), "
          f"blind rows exactly zero; fp16 (2, 8:2, 150, 300, 64): {err16:.3e}")
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    flash_rows = []
    for B_, H_, S_, T_ in [(4, 20, 1500, 1500), (4, 20, 32, 1500)]:
        q, k, v = qkv(B_, H_, H_, S_, T_, 64, torch.bfloat16)
        shape = (B_, H_, S_, T_, 64)
        n_split = flash_attention.num_splits(B_, H_, S_, T_, sm)
        print(f"flash_attention {shape} bf16: n_split {n_split} on {sm} SMs")
        row = measure(f"flash_attention {shape} bf16", flash_err(q, k, v, False), 3e-2,
                      lambda: ops.flash_attention(q, k, v, False, True),
                      lambda: flash_attention.flash_attention_plain(q, k, v, False),
                      2 * (q.numel() + k.numel()) * 2,     # q, out, k, v in bf16
                      4 * B_ * H_ * S_ * T_ * 64, BF16_OPS_PER_S,
                      lambda: F.scaled_dot_product_attention(q, k, v))
        flash_rows.append(dict(row, shape=list(shape), dtype="bfloat16", causal=False,
                               n_split=n_split))
    # gemma-7b's head dim (D = 256, causal), the DP = 256 instance unsplit
    B_, H_, S_, D_ = 1, 16, 1024, 256
    qg, kg, vg = qkv(B_, H_, H_, S_, S_, D_, torch.bfloat16)
    row = measure(f"flash_attention {(B_, H_, S_, S_, D_)} bf16 causal",
                  flash_err(qg, kg, vg, True), 3e-2,
                  lambda: ops.flash_attention(qg, kg, vg, True, True),
                  lambda: flash_attention.flash_attention_plain(qg, kg, vg, True),
                  2 * (qg.numel() + kg.numel()) * 2,
                  4 * B_ * H_ * D_ * S_ * (S_ + 1) // 2, BF16_OPS_PER_S,
                  lambda: F.scaled_dot_product_attention(qg, kg, vg, is_causal=True))
    flash_rows.append(dict(row, shape=[B_, H_, S_, S_, D_], dtype="bfloat16", causal=True,
                           n_split=flash_attention.num_splits(B_, H_, S_, S_, sm, D_)))
    del qg, kg, vg
    # llama3.2-1b's training shape (phase 9): batch 8, 32 query heads on 8 kv
    # heads, 128 tokens, D = 64, causal; one call a layer a forward
    B_, H_, Hk_, S_, D_ = 8, 32, 8, 128, 64
    qt, kt, vt = qkv(B_, H_, Hk_, S_, S_, D_, torch.bfloat16)
    row = measure(f"flash_attention {(B_, H_, Hk_, S_, S_, D_)} bf16 causal (training)",
                  flash_err(qt, kt, vt, True), 3e-2,
                  lambda: ops.flash_attention(qt, kt, vt, True, True),
                  lambda: flash_attention.flash_attention_plain(qt, kt, vt, True),
                  2 * (qt.numel() + kt.numel()) * 2,
                  4 * B_ * H_ * D_ * S_ * (S_ + 1) // 2, BF16_OPS_PER_S,
                  lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                         enable_gqa=True))
    flash_rows.append(dict(row, shape=[B_, H_, Hk_, S_, S_, D_], dtype="bfloat16", causal=True,
                           n_split=flash_attention.num_splits(B_, H_, S_, S_, sm, D_)))
    del qt, kt, vt
    # the GQA ratios of phase 10's families at their training shape, batch 8:
    # phi3.5-moe 32:8 (4) and qwen3-moe 64:4 (16) at D = 128 over 128 tokens,
    # internvl2-1b 14:2 (7) at D = 64 over its 256 patches + 128 tokens
    for arch, (B_, H_, Hk_, S_, D_) in (("phi3.5-moe", (8, 32, 8, 128, 128)),
                                        ("qwen3-moe", (8, 64, 4, 128, 128)),
                                        ("internvl2-1b", (8, 14, 2, 384, 64))):
        qt, kt, vt = qkv(B_, H_, Hk_, S_, S_, D_, torch.bfloat16)
        row = measure(f"flash_attention {(B_, H_, Hk_, S_, S_, D_)} bf16 causal ({arch}, GQA "
                      f"{H_ // Hk_})", flash_err(qt, kt, vt, True), 3e-2,
                      lambda: ops.flash_attention(qt, kt, vt, True, True),
                      lambda: flash_attention.flash_attention_plain(qt, kt, vt, True),
                      2 * (qt.numel() + kt.numel()) * 2,
                      4 * B_ * H_ * D_ * S_ * (S_ + 1) // 2, BF16_OPS_PER_S,
                      lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                             enable_gqa=True))
        flash_rows.append(dict(row, shape=[B_, H_, Hk_, S_, S_, D_], dtype="bfloat16",
                               causal=True, arch=arch,
                               n_split=flash_attention.num_splits(B_, H_, S_, S_, sm, D_)))
        del qt, kt, vt
    # the combine kernel alone, on the cross shape's partials (bf16 out, as on
    # the main path); checked in float32 against its plain version
    m, l, acc = flash_attention.flash_attention_partials(q, k, v, False, n_split)
    got = flash_attention.flash_attention_combine(m, l, acc, torch.float32)
    err = (got - flash_attention.flash_attention_combine_plain(m, l, acc)).abs().max().item()
    combine = dict(name="flash_attention_combine", route="cuda", source=SOURCE,
                   replaces="src/repro/kernels/flash_attention.py:64", launches=None,
                   **measure(f"flash_attention_combine n_split={n_split} {tuple(acc.shape)}",
                             err, 1e-6,
                             lambda: flash_attention.flash_attention_combine(
                                 m, l, acc, torch.bfloat16),
                             lambda: flash_attention.flash_attention_combine_plain(
                                 m, l, acc).bfloat16(),
                             (m.numel() + l.numel() + acc.numel()) * 4 + got.numel() * 2,
                             (3 * m.numel() + 2 * acc.numel()), FP32_OPS_PER_S))
    kernels.append(dict(name="flash_attention", route="cuda", source=SOURCE,
                        replaces="src/repro/kernels/flash_attention.py:68", launches=None,
                        **flash_rows[0], other_shapes=flash_rows[1:], combine=combine))
    del flush

    # -- phase 3: the case studies at full size, counted --------------------------
    ops.reset_launch_counts()
    r = 4
    out, secs = wall(torch, lambda: bmvm.iterate_kernel(lut, V, bcfg, r))
    expect = V
    for _ in range(r):
        expect = ref.gf2_matmul_oracle(A, expect)
    check(torch.equal(out, expect), "BMVM iterate_kernel differs from the direct GF(2) product")
    print(f"BMVM n={bcfg.n} k={bcfg.k} M={V.shape[0]} r={r}: iterate_kernel {secs * 1e3:.3f} ms, "
          "equal to gf2_matmul_oracle iterated")

    (dec, post), secs = wall(torch, lambda: ldpc.decode_minsum(idx, llr, 10))
    (_, post_p), secs_p = wall(torch, lambda: ldpc.decode_minsum(idx, llr, 10, use_kernel=False))
    err = (post - post_p).abs().max().item()
    check(err <= 1e-4, f"LDPC posteriors differ by {err} between kernel and plain")
    coded, uncoded = dec.float().mean().item(), float((llr < 0).mean())
    check(bool(torch.isfinite(post).all()) and coded < uncoded,
          f"LDPC coded BER {coded} not below uncoded {uncoded}")
    print(f"LDPC N={H.shape[1]} batch={llr.shape[0]} iters=10 at 3 dB: decode {secs * 1e3:.3f} ms "
          f"(plain {secs_p * 1e3:.3f} ms), posteriors agree to {err:.2e}, coded BER {coded:.3e} "
          f"< uncoded {uncoded:.3e}")

    est, secs = wall(torch, lambda: pf.track(frames, pcfg))
    est_p, secs_p = wall(torch, lambda: pf.track(frames, pcfg, use_kernel=False))
    err = float(np.abs(est - est_p).max())
    check(np.isfinite(est).all() and err <= 1e-3, f"PF tracks differ by {err}")
    track_err = float(np.linalg.norm(est - truth, axis=1).mean())
    print(f"PF img={pcfg.img} roi={pcfg.roi} particles={pcfg.n_particles} frames={len(frames)}: "
          f"track {secs * 1e3:.3f} ms (plain {secs_p * 1e3:.3f} ms), tracks agree to {err:.2e}, "
          f"mean tracking error {track_err:.3f} px")
    counts = {name: n for name, n in ops.launch_counts().items() if name in CASE_STUDY_KERNELS}
    print(f"kernel launches on the main path: {counts}")
    check(all(v > 0 for v in counts.values()), f"a kernel was not launched: {counts}")
    for kern in kernels:
        kern["launches"] = counts.get(kern["name"], kern["launches"])

    # -- phase 4: the sim NoC engine on the card ---------------------------------
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    llr7 = ldpc.awgn_llr(np.zeros(7, np.int8), 3.0, rng)
    _, _, st = ldpc.decode_on_noc(ldpc.fano_plane_H(), llr7, 10)
    check(st.as_dict() == GOLDEN_LDPC_FANO, f"Fano LDPC NoCStats {st.as_dict()}")
    rng = np.random.default_rng(0)
    cfg64 = bmvm.BMVMConfig(n=64, k=8, fold=2)
    A64 = rng.integers(0, 2, (64, 64)).astype(np.uint8)
    v64 = rng.integers(0, 2, (64,)).astype(np.uint8)
    lut64 = bmvm.preprocess(A64, cfg64)
    out, st = bmvm.iterate_noc_sim(lut64, v64, cfg64, 2, topology="mesh")
    check(np.array_equal(out.reshape(1, -1), bmvm.software_ref(A64, v64[None], 2)), "BMVM n=64")
    check(st.as_dict() == GOLDEN_BMVM_64, f"BMVM n=64 NoCStats {st.as_dict()}")
    print("golden NoCStats of the Fano LDPC and BMVM n=64 runs reproduced field for field")
    for topo in ("ring", "mesh", "torus", "fattree"):
        out, st = bmvm.iterate_noc_sim(lut64, v64, cfg64, 3, topology=topo)
        check(np.array_equal(out.reshape(1, -1), bmvm.software_ref(A64, v64[None], 3)),
              f"BMVM n=64 on {topo}")
        print(f"  BMVM n=64 r=3 on {topo}: equal to software_ref, rounds={st.rounds} "
              f"link_bytes={st.link_bytes}")
    scfg = pf.PFConfig(img=128, roi=32, n_particles=256, n_bins=16)
    sframes, _ = pf.synth_video(scfg, 8, rng)
    est_noc, st = pf.track_on_noc(sframes, scfg, n_pe=4, n_nodes=8)
    err = float(np.abs(est_noc - pf.track(sframes, scfg, use_kernel=False)).max())
    check(err <= 1e-3, f"track_on_noc differs from track by {err}")
    print(f"  PF track_on_noc (4 PEs, 8-node mesh): agrees with track to {err:.2e}, "
          f"flits={st.flits}")
    big = bmvm.BMVMConfig(n=1024, k=8, fold=4)
    Ab = rng.integers(0, 2, (1024, 1024)).astype(np.uint8)
    vb = rng.integers(0, 2, (1024,)).astype(np.uint8)
    (out, st), secs = wall(torch, lambda: bmvm.iterate_noc_sim(
        bmvm.preprocess(Ab, big), vb, big, 2, topology="mesh", n_nodes=64))
    check(np.array_equal(out.reshape(1, -1), bmvm.software_ref(Ab, vb[None], 2)), "BMVM n=1024")
    _, st_cpu = bmvm.iterate_noc_sim(bmvm.preprocess(Ab, big, device="cpu"), vb, big, 2,
                                     topology="mesh", n_nodes=64, device="cpu")
    check(st.as_dict() == st_cpu.as_dict(), "BMVM n=1024 NoCStats differ between GPU and CPU")
    print(f"  BMVM n=1024 fold=4 ({big.n_pe} PEs, 8x8 mesh) r=2: equal to software_ref in "
          f"{secs:.3f} s, NoCStats equal to the CPU run: {st.as_dict()}")
    print(f"NoC phase {time.perf_counter() - t0:.2f} s")

    # -- phase 5: whisper-large-v3 served at full width ---------------------------
    serve_stats = whisper_phase(torch, dev)
    for kern in kernels:
        if kern["name"] == "flash_attention":
            kern["launches"] = serve_stats["launches"]
            kern["combine"]["launches"] = serve_stats["combine_launches"]

    # -- phase 6: partitioned execution on the card --------------------------------
    partition_phase(torch, dev)

    # -- phase 7: the buffered switch and the verifier on the card ----------------
    buffered_phase(torch, dev)

    # -- phase 8: telemetry on the card ---------------------------------------------
    telemetry_phase(torch, dev, smi, serve_stats)

    # -- phase 9: the dense family served and trained on the card -----------------
    dense = dense_phase(torch, dev, smi)

    # -- phase 10: the MoE, MLA and vlm families served and trained on the card ---
    families = families_phase(torch, dev, smi)

    # -- phase 11: the hybrid and xlstm families served and trained on the card ---
    recurrent = recurrent_phase(torch, dev, smi)

    # -- phase 12: device-mesh execution, 8 ranks on the card ---------------------
    spmd = spmd_phase(torch, smi)
    for kern in kernels:
        if kern["name"] == "gf2_bmvm":
            kern["launches_by_path"] = {"iterate_kernel": kern["launches"],
                                        "spmd": spmd["launches"]}
            kern["launches"] = sum(kern["launches_by_path"].values())
    for kern in kernels:
        if kern["name"] == "flash_attention":
            kern["launches_by_path"] = {"whisper_serve": serve_stats["launches"],
                                        "llama_serve": dense["serve_launches"],
                                        "llama_train": dense["train_launches"],
                                        **families["launches"], **recurrent["launches"]}
            kern["launches"] = sum(kern["launches_by_path"].values())
            kern["combine"]["launches_by_path"] = {
                "whisper_serve": serve_stats["combine_launches"], "llama_serve": 0,
                "llama_train": dense["train_combine_launches"],
                **families["combine_launches"], **recurrent["combine_launches"]}
            kern["combine"]["launches"] = sum(kern["combine"]["launches_by_path"].values())

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


def whisper_phase(torch, dev):
    """Phase 5: serve whisper-large-v3 FULL (flash) and hold it to the plain
    path on the card and, at SMOKE size, to the CPU."""
    from repro_torch._tree import leaves
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention, ops
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import init_params

    requests, batch, prompt_len, gen_len = 16, 4, 32, 16

    # SMOKE on the card (kernel) against the CPU (plain versions), f32
    small = get_config("whisper-large-v3", smoke=True).replace(attn_impl="flash")
    sp = init_params(T.abstract_params(small), torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, small.vocab, (2, 10)))
    frames = torch.as_tensor(rng.normal(size=(2, small.enc_seq, small.d_frontend)),
                             dtype=torch.float32)
    outs = []
    with torch.inference_mode():
        for d in ("cpu", dev):
            small_in = {"tokens": toks.to(d), "frames": frames.to(d)}
            lg, _, _, _ = T.forward(_to(sp, d), small_in, small)
            outs.append(lg.cpu())
    err = (outs[0] - outs[1]).abs().max().item()
    scale = outs[0].abs().max().item()
    check(err <= 1e-3 * max(scale, 1.0), f"whisper SMOKE logits: card vs CPU differ by {err}")
    print(f"whisper SMOKE forward (flash kernel on the card vs plain on the CPU, f32): "
          f"max |diff| {err:.3e} of max |logit| {scale:.3f} (limit 1e-3 x scale)")

    # FULL width, weights from a seed
    cfg = get_config("whisper-large-v3").replace(attn_impl="flash")
    gen = torch.Generator(device=dev).manual_seed(0)
    masters, secs = wall(torch, lambda: init_params(T.abstract_params(cfg), gen))
    n_params = sum(t.numel() for t in leaves(masters))
    check(n_params == cfg.param_count(), f"{n_params} params, expected {cfg.param_count()}")
    params = T.cast_params(masters, cfg.cdtype)
    del masters
    print(f"whisper-large-v3 FULL: {n_params:,} params drawn in {secs:.2f} s; serving from a "
          f"{cfg.cdtype} copy ({n_params * 2 / 1e9:.2f} GB)")
    prompts = torch.randint(0, cfg.vocab, (requests, prompt_len), generator=gen, device=dev)
    frames = torch.randn((requests, cfg.enc_seq, cfg.d_frontend), generator=gen,
                         device=dev).to(cfg.cdtype)
    prompts_np = prompts.cpu().numpy()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    tokens = np.concatenate([
        serve.serve_batch(params, cfg, prompts_np[i:i + batch], gen_len,
                          frames=frames[i:i + batch], device=dev)
        for i in range(0, requests, batch)])
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    expect = requests // batch * (cfg.n_enc_layers + cfg.n_layers)
    print(f"served {requests} requests x {gen_len} tokens at batch {batch} in {serve_s:.3f} s "
          f"({requests * gen_len / serve_s:.1f} tokens/s), peak memory {peak / 2**30:.2f} GiB")
    print(f"kernel launches on the serve path: {counts}")
    combines = flash_attention.flash_attention.combine_launches
    print(f"flash_attention_combine launches: {combines} ({combines // (requests // batch)} per "
          f"prefill)")
    check(counts["flash_attention"] == expect,
          f"flash_attention launched {counts['flash_attention']} times, expected {expect}")
    check(combines == requests // batch * cfg.n_layers,
          f"flash_attention_combine launched {combines} times, expected "
          f"{requests // batch * cfg.n_layers} (one per cross-attention call)")
    check(tokens.shape == (requests, gen_len) and tokens.min() >= 0
          and tokens.max() < cfg.vocab, f"tokens {tokens.shape} out of range")

    # Kernel path against the plain path (attn_impl="naive") on the first
    # batch.  With the reference's init (q, k ~ N(0, 64): scores of std 64)
    # this random network amplifies any rounding difference about fivefold
    # per layer, so two plain implementations (naive, blocked) already
    # disagree end to end; the end-to-end gaps are printed, and the check is
    # on every flash call of a prefill, against the plain version on that
    # call's own inputs.
    forced = torch.as_tensor(tokens[:batch], device=dev)
    first = {"tokens": prompts[:batch], "frames": frames[:batch]}

    def drive(c):
        cache = T.init_cache(c, batch, prompt_len + gen_len, device=dev)
        with torch.inference_mode():
            (lg, cache), pre_s = wall(torch, lambda: T.prefill(params, first, c, cache))
            steps, dec = [lg[:, -1].float()], []
            for i in range(gen_len - 1):
                (lg, cache), s = wall(torch, lambda: T.decode_step(
                    params, {"tokens": forced[:, i:i + 1]}, c, cache))
                steps.append(lg.float())
                dec.append(s)
        return torch.stack(steps, 1), pre_s, dec

    plain_cfg = cfg.replace(attn_impl="naive")
    lk, pre_k, dec_k = drive(cfg)
    drive(plain_cfg)                 # first call: cuBLAS picks its algorithms
    lp, pre_p, dec_p = drive(plain_cfg)
    lb, _, _ = drive(cfg.replace(attn_impl="blocked"))
    check(bool(torch.isfinite(lk).all()), "kernel-path logits are not finite")

    def gap(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    print(f"end to end, batch 0, prefill + 15 teacher-forced decode steps: max |diff| / max "
          f"|logit| kernel vs plain {gap(lk, lp):.4f}, blocked vs plain (no kernel) "
          f"{gap(lb, lp):.4f}; argmax agreement kernel vs plain "
          f"{(lk.argmax(-1) == lp.argmax(-1)).float().mean().item():.3f}, blocked vs plain "
          f"{(lb.argmax(-1) == lp.argmax(-1)).float().mean().item():.3f}")

    per_call = []
    real = ops.flash_attention

    def held(q, k, v, causal=True, use_kernel=False):
        out = real(q, k, v, causal, use_kernel)
        plain = flash_attention.flash_attention_plain(q, k, v, causal).float()
        per_call.append(((out.float() - plain).abs().max() / plain.abs().max()).item())
        return out

    ops.flash_attention = held
    try:
        with torch.inference_mode():
            T.prefill(params, first, cfg, T.init_cache(cfg, batch, prompt_len, device=dev))
    finally:
        ops.flash_attention = real
    worst = max(per_call)
    print(f"every flash call of a FULL prefill ({len(per_call)}: {cfg.n_enc_layers} encoder "
          f"self-attention, {cfg.n_layers} cross-attention) against the plain version on its "
          f"own inputs: worst max |diff| / max |out| {worst:.3e} (limit 1e-2: both round a "
          f"float32 result to bf16, a relative step of 3.9e-3)")
    check(len(per_call) == cfg.n_enc_layers + cfg.n_layers and worst <= 1e-2,
          f"flash calls on the serve path differ from the plain version by {worst:.3e}")
    print(f"prefill {pre_k * 1e3:.3f} ms (plain path {pre_p * 1e3:.3f} ms); decode "
          f"{statistics.median(dec_k) * 1e3:.3f} ms/token median of {len(dec_k)} "
          f"(plain path {statistics.median(dec_p) * 1e3:.3f})")
    return dict(launches=counts["flash_attention"], combine_launches=combines,
                serve_s=serve_s, peak_bytes=peak,
                prefill_ms=pre_k * 1e3, decode_ms=statistics.median(dec_k) * 1e3,
                served=dict(params=params, cfg=cfg, prompts=prompts_np, frames=frames,
                            tokens=tokens, batch=batch, gen_len=gen_len))


def partition_phase(torch, dev):
    """Phase 6: the NoC cut into pods over quasi-SERDES bridges, on the card,
    held to the uncut run and to the port's own CPU run."""
    from repro_torch import core
    from repro_torch.apps import bmvm, ldpc
    from repro_torch.apps import particle_filter as pf
    from repro_torch.core import serdes

    t_phase = time.perf_counter()

    def bridge_free(st):
        return {k: v for k, v in st.as_dict().items()
                if not k.startswith(("bridge_", "cross_pod_"))}

    # table 8's gates: BMVM n=64 on the 8-node mesh, 2 and 4 pods, every wire
    # width x compression at 2 lanes
    rng = np.random.default_rng(8)
    cfg = bmvm.BMVMConfig(n=64, k=8, fold=2)
    A = rng.integers(0, 2, (64, 64)).astype(np.uint8)
    v = rng.integers(0, 2, (64,)).astype(np.uint8)
    lut, lut_cpu = bmvm.preprocess(A, cfg), bmvm.preprocess(A, cfg, device="cpu")
    sw = bmvm.software_ref(A, v[None], 2)
    g, _ = bmvm.build_bmvm_graph(lut, cfg)
    topo = core.make_topology("mesh", 8)
    out0, st0 = bmvm.iterate_noc_sim(lut, v, cfg, 2, topology="mesh")
    cuts = {2: [0] * 4 + [1] * 4, 4: [0, 0, 1, 1, 2, 2, 3, 3]}
    beats = {}
    for n_pods, pods in cuts.items():
        for wb in (8, 16, 32):
            for comp in ("none", "bf16"):
                scfg = core.QuasiSerdesConfig(wire_bits=wb, lanes=2, compress=comp)
                out, st = bmvm.iterate_noc_sim(lut, v, cfg, 2, topology="mesh", pods=pods,
                                               serdes_cfg=scfg)
                _, st_cpu = bmvm.iterate_noc_sim(lut_cpu, v, cfg, 2, topology="mesh", pods=pods,
                                                 serdes_cfg=scfg, device="cpu")
                what = f"BMVM n=64 cut into {n_pods} pods, wire {wb} bits, {comp}"
                check(np.array_equal(out, out0) and np.array_equal(out.reshape(1, -1), sw),
                      f"{what}: outputs differ from the uncut run or software_ref")
                check(bridge_free(st) == bridge_free(st0),
                      f"{what}: non-bridge NoCStats differ from the uncut run")
                check(st.as_dict() == st_cpu.as_dict() and st.bridge_beats > 0,
                      f"{what}: NoCStats differ from the CPU run: {st.as_dict()} vs "
                      f"{st_cpu.as_dict()}")
                plan = core.cut(g, core.place_round_robin(g, topo), pods, scfg)
                bprog = core.compile_bridges(core.compile_routes(topo), plan,
                                             core.BridgeConfig(serdes=scfg, fifo_depth=8))
                cube = torch.as_tensor(rng.integers(0, 255, (8, 8, 16), dtype=np.uint8),
                                       device=dev)
                d, _, b_sim = core.simulate_bridged_program(bprog, cube)
                check(torch.equal(d, cube.transpose(0, 1)) and
                      core.bridge_program_stats(bprog, cube.numel()).as_dict()
                      == b_sim.as_dict(), f"{what}: bridged cube delivery or stats differ")
                beats[(n_pods, wb, comp)] = (st.bridge_beats, st.bridge_stall_rounds)
    print("table 8 on the card: BMVM n=64 cut into 2 and 4 pods x wire 8/16/32 x none/bf16 "
          "equal to the uncut run and software_ref, non-bridge NoCStats unchanged, every "
          "counter equal to the CPU run, analytic bridge stats == the simulator; (beats, "
          "stall rounds): " + ", ".join(f"p{p}w{w}{c}={b}" for (p, w, c), b in beats.items()))

    # at full NoC size: BMVM n=1024 fold=4 (32 + 32 PEs) on the 8x8 mesh
    big = bmvm.BMVMConfig(n=1024, k=8, fold=4)
    Ab = rng.integers(0, 2, (1024, 1024)).astype(np.uint8)
    vb = rng.integers(0, 2, (1024,)).astype(np.uint8)
    lut_b, lut_b_cpu = bmvm.preprocess(Ab, big), bmvm.preprocess(Ab, big, device="cpu")
    swb = bmvm.software_ref(Ab, vb[None], 2)
    walls = {}
    for name, pods in (("uncut", None), ("2 pods", [0] * 32 + [1] * 32),
                       ("4 pods", [i // 16 for i in range(64)])):
        bmvm.iterate_noc_sim(lut_b, vb, big, 1, topology="mesh", n_nodes=64, pods=pods)
        (out, st), secs = wall(torch, lambda: bmvm.iterate_noc_sim(
            lut_b, vb, big, 2, topology="mesh", n_nodes=64, pods=pods))
        _, st_cpu = bmvm.iterate_noc_sim(lut_b_cpu, vb, big, 2, topology="mesh", n_nodes=64,
                                         pods=pods, device="cpu")
        check(np.array_equal(out.reshape(1, -1), swb), f"BMVM n=1024 {name}: differs from "
              "software_ref")
        check(st.as_dict() == st_cpu.as_dict(), f"BMVM n=1024 {name}: NoCStats differ from "
              f"the CPU run: {st.as_dict()} vs {st_cpu.as_dict()}")
        if pods is None:
            out_uncut, st_uncut = out, st
        else:
            check(np.array_equal(out, out_uncut) and bridge_free(st) == bridge_free(st_uncut),
                  f"BMVM n=1024 {name}: differs from the uncut run")
        walls[name] = secs
        print(f"  BMVM n=1024 fold=4 on the 8x8 mesh, {name}, r=2: {secs * 1e3:.3f} ms wall, "
              f"equal to software_ref and NoCStats equal to the CPU run: rounds={st.rounds} "
              f"bridge_beats={st.bridge_beats} bridge_wire_bytes={st.bridge_wire_bytes} "
              f"bridge_stall_rounds={st.bridge_stall_rounds} bridge_peak_fifo="
              f"{st.bridge_peak_fifo}")

    # the other two apps, cut
    llr7 = ldpc.awgn_llr(np.zeros(7, np.int8), 3.0, rng)
    H = ldpc.fano_plane_H()
    bits0, post0, st0 = ldpc.decode_on_noc(H, llr7, 10, topology="mesh", n_nodes=16)
    for pods in ([0] * 8 + [1] * 8, [i // 4 for i in range(16)]):
        bits, post, st = ldpc.decode_on_noc(H, llr7, 10, topology="mesh", n_nodes=16, pods=pods)
        check(np.array_equal(bits, bits0) and np.array_equal(post, post0)
              and bridge_free(st) == bridge_free(st0) and st.bridge_beats > 0,
              f"Fano LDPC cut into {max(pods) + 1} pods differs from the uncut run")
    scfg = pf.PFConfig(img=128, roi=32, n_particles=256, n_bins=16)
    frames, _ = pf.synth_video(scfg, 8, rng)
    noise = [rng.normal(size=(256, 2)).astype(np.float32) for _ in range(7)]
    c0, st0 = pf.track_on_noc(frames, scfg, n_pe=4, topology="torus", n_nodes=8, noise=noise)
    c1, st1 = pf.track_on_noc(frames, scfg, n_pe=4, topology="torus", n_nodes=8, noise=noise,
                              pods=[0] * 4 + [1] * 4)
    check(np.array_equal(c1, c0) and bridge_free(st1) == bridge_free(st0)
          and st1.bridge_beats > 0, "PF track_on_noc cut into 2 pods differs from the uncut run")
    print("Fano LDPC (16-node mesh, 2 and 4 pods) and PF track_on_noc (img 128, roi 32, 256 "
          "particles, 4 PEs, 8-node torus, 2 pods): equal to their uncut runs")

    # the seed loop and the placement search
    for name in ("ring", "mesh", "torus", "fattree"):
        for pods in (None, cuts[2]):
            runs = {m: bmvm.iterate_noc_sim(lut, v, cfg, 2, topology=name, pods=pods, mode=m)
                    for m in ("sim", "sim_python")}
            check(np.array_equal(runs["sim"][0], runs["sim_python"][0])
                  and runs["sim"][1].as_dict() == runs["sim_python"][1].as_dict(),
                  f"sim_python differs from sim on {name} (pods {pods})")
    g_cpu, _ = bmvm.build_bmvm_graph(lut_cpu, cfg)
    g_ldpc, _ = ldpc.build_ldpc_graph(H)
    for gname, gg, gg_cpu, tp in (("BMVM n=64", g, g_cpu, topo),
                                  ("Fano LDPC", g_ldpc, g_ldpc, core.make_topology("mesh", 16))):
        pl = core.optimize_placement(gg, tp, iters=4000, seed=0)
        check(pl == core.optimize_placement(gg_cpu, tp, iters=4000, seed=0),
              f"{gname}: the placement search differs from the CPU-built graph's")
        c_opt = core.placement_cost(gg, tp, pl)
        c_rr = core.placement_cost(gg, tp, core.place_round_robin(gg, tp))
        check(c_opt <= c_rr, f"{gname}: annealed cost {c_opt} above round-robin {c_rr}")
        print(f"  placement search {gname}: cost {c_opt} (round-robin {c_rr})")
    tp16 = core.make_topology("mesh", 16)
    plan, cost = core.optimize_pod_cut(g_ldpc, tp16, n_pods=2)
    naive = core.placement_cost(g_ldpc, tp16, core.place_round_robin(g_ldpc, tp16),
                                core.candidate_cuts(tp16, 2)[0], core.QuasiSerdesConfig())
    check(cost <= naive, f"pod-cut co-optimizer cost {cost} above the naive cut's {naive}")
    print(f"sim_python == sim on 4 topologies with and without a plan; pod-cut co-optimizer "
          f"(Fano, 2 pods): cost {cost} <= naive {naive}, serdes {plan.serdes_cfg}")

    # serdes endpoints on the card, against the CPU
    x = torch.as_tensor(rng.normal(size=(1000,)).astype(np.float32) * 3)
    res0 = torch.as_tensor(rng.normal(size=(1000,)).astype(np.float32) * 0.01)
    for comp in ("none", "bf16", "int8"):
        for wb in (8, 16, 32):
            c = core.QuasiSerdesConfig(wire_bits=wb, lanes=4, compress=comp, block=64)
            meta = serdes.plan(x.shape, x.dtype, c)
            res_in = res0 if comp == "int8" else None
            w, sw_, res = serdes.encode(x.to(dev), c, meta,
                                        None if res_in is None else res_in.to(dev))
            w_c, sw_c, res_c = serdes.encode(x, c, meta, res_in)
            y = serdes.decode(w, sw_, c, meta)
            same = (torch.equal(w.cpu().view(torch.uint8), w_c.view(torch.uint8))
                    and torch.equal(sw_.cpu().view(torch.uint8), sw_c.view(torch.uint8)))
            if comp == "none":
                check(same and torch.equal(y.cpu(), x), f"serdes none, {wb} bits: no round trip")
            elif comp == "bf16":
                check(same, f"serdes bf16, {wb} bits: words differ from the CPU run")
            else:
                err = (res.cpu() - res_c).abs().max().item()
                check(same and err <= 1e-6, f"serdes int8, {wb} bits: codes or residual "
                      f"({err}) differ from the CPU run")
    print("serdes on the card (none/bf16/int8 x wire 8/16/32): none round-trips bit for bit, "
          "bf16 words and int8 codes equal the CPU run's, int8 residual within 1e-6")
    print(f"partition phase {time.perf_counter() - t_phase:.2f} s; BMVM n=1024 wall: " +
          ", ".join(f"{k} {v * 1e3:.3f} ms" for k, v in walls.items()))


def buffered_phase(torch, dev):
    """Phase 7: ``mode="buffered"`` and ``verify="strict"`` on the card, held
    to ``sim``, ``software_ref`` and the reference's counters."""
    from repro_torch import analysis, core
    from repro_torch.apps import bmvm, ldpc
    from repro_torch.apps import particle_filter as pf
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as kref

    t_phase = time.perf_counter()
    ops.reset_launch_counts()
    rng = np.random.default_rng(0)
    llr7 = ldpc.awgn_llr(np.zeros(7, np.int8), 3.0, rng)
    H = ldpc.fano_plane_H()
    bits_s, post_s, _ = ldpc.decode_on_noc(H, llr7, 10)
    bits, post, st = ldpc.decode_on_noc(H, llr7, 10, mode="buffered")
    check(np.array_equal(bits, bits_s) and np.array_equal(post, post_s),
          "Fano LDPC buffered: the decode differs from sim")
    check(st.as_dict() == GOLDEN_LDPC_FANO_BUFFERED, f"Fano LDPC buffered NoCStats {st.as_dict()}")
    rng = np.random.default_rng(0)
    cfg64 = bmvm.BMVMConfig(n=64, k=8, fold=2)
    A64 = rng.integers(0, 2, (64, 64)).astype(np.uint8)
    v64 = rng.integers(0, 2, (64,)).astype(np.uint8)
    out, st = bmvm.iterate_noc_sim(bmvm.preprocess(A64, cfg64), v64, cfg64, 2, topology="mesh",
                                   mode="buffered")
    check(np.array_equal(out.reshape(1, -1), bmvm.software_ref(A64, v64[None], 2)),
          "BMVM n=64 buffered differs from software_ref")
    check(st.as_dict() == GOLDEN_BMVM_64_BUFFERED, f"BMVM n=64 buffered NoCStats {st.as_dict()}")
    print("golden buffered NoCStats of the Fano LDPC and BMVM n=64 runs reproduced field for "
          "field; outputs equal sim and software_ref")

    # at full NoC size: BMVM n=1024 fold=4 (32 + 32 PEs) on the 8x8 mesh, r=2
    big = bmvm.BMVMConfig(n=1024, k=8, fold=4)
    Ab = rng.integers(0, 2, (1024, 1024)).astype(np.uint8)
    vb = rng.integers(0, 2, (1024,)).astype(np.uint8)
    lut_b = bmvm.preprocess(Ab, big)
    swb = bmvm.software_ref(Ab, vb[None], 2)
    walls = {}
    for name, pods, want in (("uncut", None, BMVM_N1024_BUFFERED),
                             ("2 pods", [0] * 32 + [1] * 32, BMVM_N1024_BUFFERED_2PODS)):
        out_s, _ = bmvm.iterate_noc_sim(lut_b, vb, big, 2, topology="mesh", n_nodes=64, pods=pods)
        (out, st), secs = wall(torch, lambda: bmvm.iterate_noc_sim(
            lut_b, vb, big, 2, topology="mesh", n_nodes=64, pods=pods, mode="buffered"))
        check(np.array_equal(out.reshape(1, -1), swb) and np.array_equal(out, out_s),
              f"BMVM n=1024 buffered, {name}: differs from software_ref or the sim run")
        check(st.as_dict() == want, f"BMVM n=1024 buffered, {name}: NoCStats {st.as_dict()}")
        walls[name] = secs
        print(f"  BMVM n=1024 fold=4 on the 8x8 mesh, {name}, r=2, buffered: {secs * 1e3:.3f} ms "
              f"wall, equal to software_ref and sim; NoCStats equal the reference's: "
              f"switch_cycles={st.switch_cycles} stalls={st.switch_stall_cycles} "
              f"arb_losses={st.switch_arb_losses} bridge_beats={st.bridge_beats}")
    g, fb = bmvm.build_bmvm_graph(lut_b, big)
    topo = core.make_topology("mesh", 64)
    ex = core.NoCExecutor(g, topo)
    found = [str(d) for d in analysis.verify_executor(ex)]
    check(found == [NOC005_N1024] and [str(d) for d in ex.verification] == found,
          f"BMVM n=1024 verifier findings {found}")
    print(f"  verify_executor on the BMVM n=1024 executor: {found[0]}")
    words = kref.gf2_pack_vector(torch.as_tensor(rng.integers(0, 2, (4, 1024), dtype=np.uint8),
                                                 device=dev), big.k)
    binp = {f"lut{i}.v": words[:, i * big.fold:(i + 1) * big.fold].view(torch.uint32)
            for i in range(big.n_pe)}
    (b_out, b_st), secs = wall(torch, lambda: ex.run_batch(binp, mode="buffered"))
    s_out, s_st = ex.run_batch(binp, mode="sim")
    check(all(torch.equal(b_out[k], s_out[k]) for k in s_out) and b_st.flits == s_st.flits
          and b_st.switch_cycles > 0, "BMVM n=1024 run_batch buffered (B=4) differs from sim")
    print(f"  run_batch(mode='buffered') at B=4 on the BMVM n=1024 executor: equal to sim in "
          f"{secs * 1e3:.3f} ms, switch_cycles={b_st.switch_cycles}")
    scfg = pf.PFConfig(img=128, roi=32, n_particles=256, n_bins=16)
    frames, _ = pf.synth_video(scfg, 8, rng)
    c_s, _ = pf.track_on_noc(frames, scfg, n_pe=4, n_nodes=8)
    c_b, st = pf.track_on_noc(frames, scfg, n_pe=4, n_nodes=8, mode="buffered")
    check(np.array_equal(c_b, c_s) and st.switch_cycles > 0,
          "PF track_on_noc buffered differs from sim")
    print(f"  PF track_on_noc (img 128, 8-node mesh) buffered: equal to sim, "
          f"switch_cycles={st.switch_cycles}")

    # standalone payloads stay on the card; the deadlock pair of the 8-node ring
    ring = core.make_topology("ring", 8)
    pays = [torch.randint(0, 255, (7,), dtype=torch.uint8, device=dev) for _ in range(16)]
    res = core.simulate_switch(ring, [core.Packet(i % 8, (i * 3 + 1) % 8, 4, payload=p)
                                      for i, p in enumerate(pays)])
    check(all(r.device == p.device and torch.equal(r[:7], p) and not r[7:].any()
              for r, p in zip(res.payloads, pays)), "switch payloads differ on the card")
    wedge = [core.Packet(s, (s + 4) % 8, 4) for s in range(8) for _ in range(4)]
    one_vc = core.SwitchConfig(buffer_depth=1, n_vcs=1, max_cycles=50_000)
    for verify, err, mark in ((True, ValueError, "NOC001"),
                              (False, core.DeadlockError, "culprit wait cycle")):
        try:
            core.simulate_switch(ring, wedge, one_vc, verify=verify)
        except err as e:
            check(mark in str(e) and "->" in str(e), f"ring 8 at one VC: {e}")
            print(f"  ring 8, 1 VC, verify={verify}: {type(e).__name__}: {str(e)[:150]}")
        else:
            raise AssertionError(f"ring 8 at one VC, verify={verify}: no {err.__name__}")

    cli = subprocess.run([sys.executable, "-m", "repro_torch.analysis"], capture_output=True,
                         text=True, timeout=300, cwd=HERE,
                         env=dict(os.environ, PYTHONPATH=os.path.join(HERE, "src")))
    check(cli.returncode == 0, f"python -m repro_torch.analysis exited {cli.returncode}: "
          f"{cli.stdout[-2000:]}{cli.stderr[-2000:]}")
    print(f"  python -m repro_torch.analysis on the card: exit 0, "
          f"{cli.stdout.strip().splitlines()[-1]}")
    print(f"kernel launches on the buffered path (its PEs fire the plain ops): "
          f"{ops.launch_counts()}")
    print(f"buffered phase {time.perf_counter() - t_phase:.2f} s; BMVM n=1024 buffered wall: " +
          ", ".join(f"{k} {v * 1e3:.3f} ms" for k, v in walls.items()))


def telemetry_phase(torch, dev, smi, serve_stats):
    """Phase 8: the tracer, the profiler, the Perfetto export and the metrics
    registry on the card, held to the port's own CPU run (which the tests
    hold to the reference) and to the reference's counters; then serve_batch
    with a registry at whisper-large-v3 FULL."""
    from repro_torch import telemetry as tel
    from repro_torch.apps import bmvm, ldpc
    from repro_torch.apps import particle_filter as pf
    from repro_torch.core.noc import _MAX_MERGE_FIELDS
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    t_phase = time.perf_counter()
    ops.reset_launch_counts()

    def events(tr):
        return [(e.ts, e.name, e.track, e.kind, e.dur, e.value, e.args) for e in tr.events()]

    def halves(n):
        return [0] * (n // 2) + [1] * (n - n // 2)

    # (a) tests/test_telemetry.py's grid on the mesh: the card's events == the CPU's
    rng = np.random.default_rng(0)
    A64 = rng.integers(0, 2, (64, 64)).astype(np.uint8)
    v64 = rng.integers(0, 2, (64,)).astype(np.uint8)
    cfg64 = bmvm.BMVMConfig(n=64, k=8, fold=2)
    llr7 = ldpc.awgn_llr(np.zeros(7, np.int8), 4.0, rng)
    pcfg = pf.PFConfig(img=48, roi=12, n_particles=32, n_bins=12)
    frames, _ = pf.synth_video(pcfg, 3, rng)
    noise = [rng.normal(size=(32, 2)).astype(np.float32) for _ in range(2)]

    def run_app(app, mode, pods, tracer, device):
        if app == "bmvm":
            return bmvm.iterate_noc_sim(bmvm.preprocess(A64, cfg64, device=device), v64, cfg64,
                                        2, topology="mesh", mode=mode, pods=pods,
                                        tracer=tracer, device=device)[-1]
        if app == "ldpc":
            return ldpc.decode_on_noc(ldpc.fano_plane_H(), llr7, 2, topology="mesh",
                                      n_nodes=16, mode=mode, pods=pods, tracer=tracer,
                                      device=device)[-1]
        return pf.track_on_noc(frames, pcfg, n_pe=4, topology="mesh", n_nodes=8, mode=mode,
                               pods=pods, tracer=tracer, noise=noise, device=device)[-1]

    grid = [(app, mode, cut) for app in ("bmvm", "ldpc", "pf")
            for mode, cut in (("sim", False), ("buffered", False), ("sim", True))]
    grid += [("bmvm", "sim_python", False), ("bmvm", "sim_python", True)]
    n_events = 0
    for app, mode, cut in grid:
        pods = halves(16 if app == "ldpc" else 8) if cut else None
        traces = []
        for device in (dev, "cpu"):
            tr = tel.Tracer()
            st = run_app(app, mode, pods, tr, device)
            check(tr.dropped == 0 and tel.trace_stats(tr).as_dict() == st.as_dict(),
                  f"{app} {mode} cut={cut} on {device}: trace_stats differs from NoCStats")
            traces.append((events(tr), st.as_dict()))
        check(traces[0] == traces[1], f"{app} {mode} cut={cut}: the card's events or "
              "NoCStats differ from the CPU run's")
        n_events += len(traces[0][0])
    print(f"traced grid on the card ({len(grid)} runs: BMVM, LDPC, PF x sim, buffered, "
          f"bridged on the mesh, sim_python uncut and cut): {n_events} events, each equal to "
          f"the CPU run's; trace_stats == NoCStats in every run")

    # (b) BMVM n=1024 fold=4 (32 + 32 PEs) on the 8x8 mesh, r=2, buffered
    big = bmvm.BMVMConfig(n=1024, k=8, fold=4)
    Ab = rng.integers(0, 2, (1024, 1024)).astype(np.uint8)
    vb = rng.integers(0, 2, (1024,)).astype(np.uint8)
    lut_b = bmvm.preprocess(Ab, big, device=dev)

    def run_big(pods, tracer=None):
        return wall(torch, lambda: bmvm.iterate_noc_sim(
            lut_b, vb, big, 2, topology="mesh", n_nodes=64, pods=pods, mode="buffered",
            tracer=tracer, device=dev))

    walls = {}
    for name, pods, want in (("uncut", None, BMVM_N1024_BUFFERED),
                             ("2 pods", [0] * 32 + [1] * 32, BMVM_N1024_BUFFERED_2PODS)):
        ev0, rec0 = tel.events_allocated(), tel.records_allocated()
        untraced = [run_big(pods)[1] for _ in range(3)]
        check((tel.events_allocated(), tel.records_allocated()) == (ev0, rec0),
              f"BMVM n=1024 {name}: an untraced run allocated events or records")
        traced = []
        for _ in range(3):
            tr = tel.Tracer()
            (_, st), secs = run_big(pods, tr)
            traced.append(secs)
        check(st.as_dict() == want and tel.trace_stats(tr).as_dict() == want,
              f"BMVM n=1024 buffered {name}: trace_stats {tel.trace_stats(tr).as_dict()}")
        prof = tel.profile_trace(tr).check_exact()
        cp = prof.critical_path()
        check(cp.length == tr.clock, f"BMVM n=1024 {name}: critical path {cp.length} != "
              f"clock {tr.clock}")
        doc = json.loads(json.dumps(tel.chrome_trace(tr)))
        n_doc = tel.validate_chrome_trace(doc)
        check(tel.trace_stats(tel.events_from_chrome(doc)).as_dict() == want,
              f"BMVM n=1024 {name}: the Perfetto round trip changes trace_stats")
        walls[name] = (statistics.median(traced), statistics.median(untraced))
        print(f"  BMVM n=1024 buffered, {name}: {len(tr)} events, trace_stats == NoCStats == "
              f"the reference's counters (switch_cycles={st.switch_cycles} stalls="
              f"{st.switch_stall_cycles} arb={st.switch_arb_losses} bridge_beats="
              f"{st.bridge_beats}); profile exact over {len(prof.records)} packets, critical "
              f"path {cp.length} ticks, gap {cp.gap}; Perfetto {n_doc} events valid and "
              f"round-tripping; host wall traced {walls[name][0] * 1e3:.3f} ms / untraced "
              f"{walls[name][1] * 1e3:.3f} ms (medians of 3) = "
              f"{walls[name][0] / walls[name][1]:.3f}x")
    tr = tel.Tracer(detail="flits")
    (_, st), flit_s = run_big(None, tr)
    n_flit = sum(e.name == "flit" for e in tr.events())
    check(n_flit == st.link_bytes // 2 == 108544 and tel.trace_stats(tr).as_dict()
          == BMVM_N1024_BUFFERED, f"detail='flits': {n_flit} flit events, link flits "
          f"{st.link_bytes // 2}")
    print(f"  detail='flits', uncut: {n_flit} flit events == link_bytes / flit_wire_bytes; "
          f"{len(tr)} events, host wall {flit_s * 1e3:.3f} ms (one run) = "
          f"{flit_s / walls['uncut'][1]:.3f}x the untraced median")

    # (c) the CLI on the card, four runs at once
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
        runs = {app: [] for app in ("bmvm", "ldpc", "pf")}
        runs["bmvm buffered"] = ["--mode", "buffered", "--profile", "--metrics",
                                 os.path.join(tmp, "metrics.json")]
        procs = {}
        for key, extra in runs.items():
            out = os.path.join(tmp, key.replace(" ", "_") + ".json")
            cmd = [sys.executable, "-m", "repro_torch.telemetry", "--app", key.split()[0],
                   "--out", out] + extra
            procs[key] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                           text=True, cwd=HERE, env=env), out)
        for key, (proc, out) in procs.items():
            stdout, stderr = proc.communicate(timeout=300)
            check(proc.returncode == 0 and "parity OK (bit-exact)" in stdout,
                  f"python -m repro_torch.telemetry {key} exited {proc.returncode}: "
                  f"{stdout[-1500:]}{stderr[-1500:]}")
            with open(out) as fh:
                n_doc = tel.validate_chrome_trace(json.load(fh))
            print(f"  python -m repro_torch.telemetry --app {key}: exit 0, "
                  f"{stdout.splitlines()[0]}; Perfetto {n_doc} events valid")
        with open(os.path.join(tmp, "metrics.json")) as fh:
            snap = json.load(fh)
        check(any(k.startswith("noc.latency.total{") for k in snap["histograms"])
              and any(k.startswith("noc.switch_cycles{") for k in snap["counters"]),
              f"--metrics snapshot lacks noc.latency.* or noc.*: {sorted(snap)}")

    # (d) the engine publishes its NoCStats under noc.*
    reg = tel.enable_metrics()
    try:
        st = run_app("bmvm", "sim", None, None, dev)
    finally:
        tel.disable_metrics()
    snap = reg.snapshot()
    label = "{mode=sim,topology=Mesh2D}"
    for field, v in st.as_dict().items():
        kind = "gauges" if field in _MAX_MERGE_FIELDS else "counters"
        check(snap[kind].get(f"noc.{field}{label}") == v, f"registry noc.{field}: "
              f"{snap[kind].get(f'noc.{field}{label}')} != {v}")
    print(f"  enable_metrics: one sim run published its {len(st.as_dict())} NoCStats fields "
          f"under noc.*{label} with the run's values")
    print(f"kernel launches on the traced NoC paths (their PEs fire the plain ops): "
          f"{ops.launch_counts()}")
    t_noc = time.perf_counter() - t_phase

    # (e) serve_batch with a registry at whisper-large-v3 FULL, phase 5's traffic
    s5 = serve_stats["served"]
    cfg, batch = s5["cfg"], s5["batch"]
    reg = tel.MetricsRegistry()
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tokens = np.concatenate([
        serve.serve_batch(s5["params"], cfg, s5["prompts"][i:i + batch], s5["gen_len"],
                          frames=s5["frames"][i:i + batch], device=dev, reg=reg)
        for i in range(0, len(s5["prompts"]), batch)])
    torch.cuda.synchronize()
    serve_wall = time.perf_counter() - t0
    counts, combines = ops.launch_counts(), ops.flash_attention_kernel.combine_launches
    pre, dec = reg.histogram("serve.prefill.seconds"), reg.histogram("serve.decode.seconds")
    share = (pre.total + dec.total) / serve_wall
    n_batches = len(s5["prompts"]) // batch
    check(pre.count == n_batches and dec.count == n_batches * (s5["gen_len"] - 1),
          f"serve --metrics: {pre.count} prefill and {dec.count} decode samples")
    check(counts["flash_attention"] == serve_stats["launches"] == 256
          and combines == serve_stats["combine_launches"] == 128,
          f"serve --metrics: {counts['flash_attention']} flash and {combines} combine launches")
    check(np.array_equal(tokens, s5["tokens"]), "serve --metrics: tokens differ from phase 5's")
    check(0.8 <= share <= 1.0, f"serve --metrics: samples sum to {share:.3f} of the synced wall")
    print(f"serve_batch with a metrics registry, whisper-large-v3 FULL, {len(tokens)} requests "
          f"at batch {batch}: tokens equal to phase 5's; {counts['flash_attention']} flash and "
          f"{combines} combine launches; prefill n={pre.count} p50 {pre.p50 * 1e3:.3f} ms p99 "
          f"{pre.p99 * 1e3:.3f} ms; decode n={dec.count} p50 {dec.p50 * 1e3:.3f} ms p99 "
          f"{dec.p99 * 1e3:.3f} ms p99.9 {dec.p999 * 1e3:.3f} ms; samples sum "
          f"{(pre.total + dec.total) * 1e3:.3f} ms = {share:.4f} of the synced wall "
          f"{serve_wall * 1e3:.3f} ms ({smi})")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "serve.json")
        serve.run(["--smoke", "--metrics", path])
        with open(path) as fh:
            hists = json.load(fh)["histograms"]
    check({k: h["count"] for k, h in hists.items()} == {"serve.prefill.seconds": 4,
                                                        "serve.decode.seconds": 60},
          f"serve --smoke --metrics on the card: {hists}")
    check(tel.get_registry() is None, "serve --metrics left the registry enabled")
    print(f"telemetry phase {time.perf_counter() - t_phase:.2f} s (NoC parts {t_noc:.2f} s)")


def dense_phase(torch, dev, smi):
    """Phase 9: llama3.2-1b (the dense family) served and trained on the card,
    with the flash kernel in every training step's forward."""
    from repro_torch._tree import leaves
    from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
    from repro_torch.checkpoint import manager as ckpt_manager
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, _synthesize
    from repro_torch.kernels import flash_attention, ops
    from repro_torch.launch import serve, train
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import init_params
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.telemetry import MetricsRegistry

    t_phase = time.perf_counter()

    # (a) SMOKE on the card (kernel) against the CPU (plain versions), f32:
    # forward logits and three train steps' losses
    for arch in ("llama3.2-1b", "gemma-7b"):
        small = get_config(arch, smoke=True).replace(attn_impl="flash")
        p0 = init_params(T.abstract_params(small), torch.Generator().manual_seed(0))
        data = DataConfig(vocab=small.vocab, seq_len=16, global_batch=4, seed=0)
        step = make_train_step(small, AdamWConfig(lr=2e-3), total_steps=10, warmup=1)
        outs = []
        for d in ("cpu", dev):
            state = {"params": _to(p0, d)}
            state["opt"] = adamw_init(state["params"])
            batches = [train.device_batch(_synthesize(data, s), small, d) for s in range(3)]
            with torch.no_grad():
                lg = T.forward(state["params"], batches[0], small)[0].cpu()
            losses = []
            for b in batches:
                state, m = step(state, b)
                losses.append(float(m["loss"]))
            outs.append((lg, np.array(losses)))
        err = (outs[0][0] - outs[1][0]).abs().max().item()
        scale = outs[0][0].abs().max().item()
        lerr = float(np.abs(outs[0][1] - outs[1][1]).max())
        check(err <= 1e-3 * max(scale, 1.0) and lerr <= 1e-3 * float(np.abs(outs[0][1]).max()),
              f"{arch} SMOKE: card vs CPU logits differ by {err}, losses by {lerr}")
        print(f"{arch} SMOKE (flash kernel on the card vs plain on the CPU, f32): logits max "
              f"|diff| {err:.3e} of {scale:.3f}; 3 train steps' losses "
              f"{np.round(outs[1][1], 5).tolist()} vs CPU, max |diff| {lerr:.3e} "
              f"(limits 1e-3 x scale)")

    # (b) llama3.2-1b FULL from a seed, served from a bf16 copy: with a cache
    # the reference's dispatch takes the plain path, so no flash launch
    cfg = get_config("llama3.2-1b").replace(attn_impl="flash")
    requests, batch, prompt_len, gen_len = 16, 4, 32, 16
    gen = torch.Generator(device=dev).manual_seed(0)
    masters, secs = wall(torch, lambda: init_params(T.abstract_params(cfg), gen))
    n_params = sum(t.numel() for t in leaves(masters))
    check(n_params == cfg.param_count() == 1_235_814_400,
          f"llama3.2-1b FULL has {n_params} params, expected {cfg.param_count()}")
    params = T.cast_params(masters, cfg.cdtype)
    print(f"llama3.2-1b FULL: {n_params:,} params drawn in {secs:.2f} s; serving from a "
          f"{cfg.cdtype} copy ({n_params * 2 / 1e9:.2f} GB)")
    prompts = torch.randint(0, cfg.vocab, (requests, prompt_len), generator=gen,
                            device=dev).cpu().numpy()
    serve.serve_batch(params, cfg, prompts[:batch], 2, device=dev)    # cuBLAS warm-up
    reg = MetricsRegistry()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    tokens = np.concatenate([serve.serve_batch(params, cfg, prompts[i:i + batch], gen_len,
                                               device=dev, reg=reg)
                             for i in range(0, requests, batch)])
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    serve_counts = ops.launch_counts()
    serve_peak = torch.cuda.max_memory_allocated()
    pre, dec = reg.histogram("serve.prefill.seconds"), reg.histogram("serve.decode.seconds")
    check(serve_counts["flash_attention"] == 0
          and flash_attention.flash_attention.combine_launches == 0,
          f"llama serve launched flash {serve_counts['flash_attention']} times, expected 0")
    check(tokens.shape == (requests, gen_len) and tokens.min() >= 0
          and tokens.max() < cfg.vocab, f"llama tokens {tokens.shape} out of range")
    print(f"llama3.2-1b FULL served {requests} requests x {gen_len} tokens at batch {batch} "
          f"(prompt {prompt_len}) in {serve_s:.3f} s ({requests * gen_len / serve_s:.1f} "
          f"tokens/s); prefill p50 {pre.p50 * 1e3:.3f} ms, decode p50 {dec.p50 * 1e3:.3f} "
          f"ms/token (p99 {dec.p99 * 1e3:.3f}); peak memory {serve_peak / 2**30:.2f} GiB; "
          f"launches {serve_counts} (with a cache the dispatch takes _naive) ({smi})")
    del params

    # (c) llama3.2-1b FULL trained: batch 8, seq 128 (the CLI's defaults), lr
    # 3e-4, AdamW in float32 masters; flash in every layer's forward, and
    # once more a layer in the backward under remat
    n_steps, tb, ts_ = 6, 8, 128
    state = {"params": masters, "opt": adamw_init(masters)}
    del masters
    step = make_train_step(cfg, AdamWConfig(lr=3e-4), total_steps=n_steps,
                           warmup=max(n_steps // 20, 5))
    data = DataConfig(vocab=cfg.vocab, seq_len=ts_, global_batch=tb, seed=0)
    batches = [train.device_batch(_synthesize(data, s), cfg, dev) for s in range(n_steps)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    step_s, losses, gnorms = [], [], []
    for b in batches:
        (state, m), secs = wall(torch, lambda: step(state, b))
        step_s.append(secs)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    train_counts = ops.launch_counts()
    train_combines = flash_attention.flash_attention.combine_launches
    train_peak = torch.cuda.max_memory_allocated()
    expect = n_steps * cfg.n_layers * (2 if cfg.remat else 1)
    check(train_counts["flash_attention"] == expect,
          f"llama train launched flash {train_counts['flash_attention']} times, expected {expect}")
    check(np.isfinite(losses).all() and np.isfinite(gnorms).all(),
          f"llama train: loss {losses}, grad_norm {gnorms}")
    med = statistics.median(step_s[1:])
    print(f"llama3.2-1b FULL trained {n_steps} steps at batch {tb} x seq {ts_} (remat "
          f"{cfg.remat}): losses {np.round(losses, 4).tolist()}, grad_norm "
          f"{np.round(gnorms, 3).tolist()}; step {med * 1e3:.3f} ms median of steps 2-"
          f"{n_steps} (first {step_s[0] * 1e3:.3f} ms), {tb * ts_ / med:,.0f} tokens/s; peak "
          f"memory {train_peak / 2**30:.2f} GiB; flash launches {train_counts['flash_attention']}"
          f" = {n_steps} steps x {cfg.n_layers} layers x {2 if cfg.remat else 1}, combine "
          f"{train_combines} ({smi})")

    # every flash call of one step's forward against the plain version on its
    # own inputs (the forward alone, outside the counted run)
    per_call = []
    real = ops.flash_attention

    def held(q, k, v, causal=True, use_kernel=False):
        out = real(q, k, v, causal, use_kernel)
        plain = flash_attention.flash_attention_plain(q, k, v, causal).float()
        per_call.append(((out.float() - plain).abs().max() / plain.abs().max()).item())
        return out

    ops.flash_attention = held
    try:
        with torch.no_grad():
            lk = T.loss(state["params"], batches[0], cfg)[0].item()
    finally:
        ops.flash_attention = real
    with torch.no_grad():
        lp = T.loss(state["params"], batches[0], cfg.replace(attn_impl="naive"))[0].item()
    worst = max(per_call)
    check(len(per_call) == cfg.n_layers and worst <= 1e-2,
          f"flash calls of a training forward differ from the plain version by {worst:.3e}")
    print(f"every flash call of a training forward ({len(per_call)}, (8, 32:8, 128, 128, 64) "
          f"causal bf16) against the plain version on its own inputs: worst max |diff| / max "
          f"|out| {worst:.3e} (limit 1e-2); loss on batch 0 after training {lk:.5f} through "
          f"the kernel, {lp:.5f} through the plain path (attn_impl='naive')")
    del state, batches

    # (d) checkpoint and restart through launch.train.run (SMOKE on the card):
    # the restored state equals the one saved bit for bit, and the resumed
    # steps' losses follow an uninterrupted run
    saved = {}
    real_save = ckpt_manager.CheckpointManager.save

    def keep(self, step_, tree, extra=None):
        saved[step_] = [t.detach().cpu().clone() for t in leaves(tree)]
        return real_save(self, step_, tree, extra)

    base = ["--smoke", "--batch", "4", "--seq", "16", "--lr", "2e-3", "--log-every", "100"]
    with tempfile.TemporaryDirectory() as tmp:
        ckpt_manager.CheckpointManager.save = keep
        try:
            first = train.run(base + ["--steps", "6", "--ckpt", tmp, "--ckpt-every", "3"])
        finally:
            ckpt_manager.CheckpointManager.save = real_save
        small = get_config("llama3.2-1b", smoke=True)
        restored, at, _ = CheckpointManager(CheckpointConfig(tmp)).restore(
            train.build_state(small, 1, dev))
        check(at == 6 and sorted(saved) == [3, 6], f"checkpoints at {sorted(saved)}, latest {at}")
        got = leaves(restored)
        check(len(got) == len(saved[6]) and all(
            g.is_cuda and torch.equal(g.cpu(), s) for g, s in zip(got, saved[6])),
            "the restored state differs from the saved one")
        resumed = train.run(base + ["--steps", "9", "--ckpt", tmp, "--ckpt-every", "3"])
    whole = train.run(base + ["--steps", "9"])
    gap = max(abs(a - b) / abs(b) for a, b in zip(first + resumed, whole))
    check(len(first) == 6 and len(resumed) == 3 and gap <= 1e-3,
          f"resumed losses {first + resumed} vs uninterrupted {whole}: gap {gap}")
    print(f"launch.train.run on the card (SMOKE): checkpoint at steps 3 and 6, the restored "
          f"state ({len(got)} tensors) equal to the saved one bit for bit; resumed 6 -> 9 "
          f"losses {np.round(resumed, 6).tolist()} vs uninterrupted "
          f"{np.round(whole[6:], 6).tolist()}: max relative gap over 9 steps {gap:.3e} "
          f"({'bit-exact' if gap == 0 else 'not bit-exact'}; limit 1e-3)")

    # (e) the two CLIs with their default arch, at once
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    procs = [subprocess.Popen([sys.executable, "-m", f"repro_torch.launch.{m}", *a],
                              cwd=HERE, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for m, a in (("train", ["--smoke", "--steps", "4", "--metrics", "-"]),
                          ("serve", ["--smoke", "--metrics", "-"]))]
    want = ({"train.step.seconds": 4}, {"serve.prefill.seconds": 4, "serve.decode.seconds": 60})
    outs = []
    for p, w in zip(procs, want):
        out, err_ = p.communicate(timeout=300)
        check(p.returncode == 0, f"{p.args}: exit {p.returncode}\n{err_[-2000:]}")
        hists = json.loads(out[out.index("{"):])["histograms"]
        check({k: h["count"] for k, h in hists.items()} == w, f"{p.args}: {hists}")
        outs.append(out)
    check("arch=llama3.2-1b" in outs[0] and "device=cuda" in outs[0],
          f"train CLI: {outs[0][:200]}")
    print(f"python -m repro_torch.launch.train --smoke --steps 4 --metrics - and "
          f"python -m repro_torch.launch.serve --smoke --metrics - (default arch llama3.2-1b, "
          f"default device cuda): exit 0, samples {want}")
    print(f"dense phase {time.perf_counter() - t_phase:.2f} s")
    return dict(serve_launches=serve_counts["flash_attention"],
                train_launches=train_counts["flash_attention"],
                train_combine_launches=train_combines)


METRIC_KEYS = ("loss", "grad_norm", "aux", "moe_drops", "moe_peak_occupancy")


def smoke_card_vs_cpu(torch, dev, arch, kw):
    """``arch`` at SMOKE in float32 with the flash impl and remat, on the card
    (kernels) against the CPU (plain versions): forward logits and stack
    stats, greedy serve tokens, three train steps' loss, grad norm and aux
    (relative limit 1e-3) and MoE counters (equal)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, _synthesize
    from repro_torch.launch import serve, train
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import init_params
    from repro_torch.optim import AdamWConfig, adamw_init

    small = get_config(arch, smoke=True).replace(attn_impl="flash", remat=True, **kw)
    p0 = init_params(T.abstract_params(small), torch.Generator().manual_seed(0))
    data = DataConfig(vocab=small.vocab, seq_len=16, global_batch=4, seed=0)
    step = make_train_step(small, AdamWConfig(lr=2e-3), total_steps=10, warmup=1)
    prompts = np.random.default_rng(0).integers(0, small.vocab, (4, 8))
    outs = []
    for d in ("cpu", dev):
        state = {"params": _to(p0, d)}
        state["opt"] = adamw_init(state["params"])
        batches = [train.device_batch(_synthesize(data, s), small, d) for s in range(3)]
        with torch.no_grad():
            lg, _, _, st = T.forward(state["params"], batches[0], small)
        tokens = serve.serve_batch(state["params"], small, prompts, 4, device=d)
        mets = []
        for b in batches:
            state, m = step(state, b)
            mets.append([float(m[k]) for k in METRIC_KEYS])
        outs.append((lg.cpu(), {k: int(v) for k, v in st.items()}, tokens, np.array(mets)))
    (lc, sc, tc, mc), (lg_, sg, tg, mg) = outs
    err = (lc - lg_).abs().max().item()
    scale = lc.abs().max().item()
    merr = np.abs(mc[:, :3] - mg[:, :3]).max(0) / np.abs(mc[:, :3]).max(0).clip(1e-6)
    check(err <= 1e-3 * max(scale, 1.0) and sc == sg and np.array_equal(tc, tg)
          and (merr <= 1e-3).all() and np.array_equal(mc[:, 3:], mg[:, 3:])
          and np.isfinite(mg).all(),
          f"{arch} SMOKE: card vs CPU logits differ by {err}, stats {sc} vs {sg}, tokens "
          f"equal {np.array_equal(tc, tg)}, train metrics by {merr} (drops/peak "
          f"{mc[:, 3:].tolist()} vs {mg[:, 3:].tolist()})")
    print(f"{arch} SMOKE {kw or ''} (card vs CPU, f32): logits max |diff| {err:.3e} of "
          f"{scale:.3f}, stack stats {sg} equal, serve tokens equal; 3 train steps' loss, "
          f"grad_norm, aux {np.round(mg[:, :3], 5).tolist()}, relative gaps "
          f"{np.round(merr, 8).tolist()} (limit 1e-3), drops/peak {mg[:, 3:].tolist()} equal")


def held_flash_calls(torch, fn):
    """fn() without grad and with every flash call held to the plain version
    on its own inputs: (fn's result, the calls' max |diff| / max |out|)."""
    from repro_torch.kernels import flash_attention, ops

    per_call, real = [], ops.flash_attention

    def held(q, k, v, causal=True, use_kernel=False):
        out = real(q, k, v, causal, use_kernel)
        plain = flash_attention.flash_attention_plain(q, k, v, causal).float()
        per_call.append(((out.float() - plain).abs().max() / plain.abs().max()).item())
        return out

    ops.flash_attention = held
    try:
        with torch.no_grad():
            return fn(), per_call
    finally:
        ops.flash_attention = real


class FullWidth:
    """Serve and train configs at full width on the card, recording each
    path's flash and combine launches under ``<tag>_serve`` / ``<tag>_train``."""

    def __init__(self, torch, dev, smi):
        self.torch, self.dev, self.smi = torch, dev, smi
        self.launches, self.combines = {}, {}

    def serve(self, tag, cfg, requests=16, batch=4, prompt_len=32, gen_len=16):
        """Serve ``cfg`` from weights drawn in its serving dtypes from a seed:
        16 requests at batch 4, launch counters reset just before and read
        just after."""
        from repro_torch._tree import leaves
        from repro_torch.configs import get_config
        from repro_torch.kernels import flash_attention, ops
        from repro_torch.launch import serve
        from repro_torch.models import transformer as T
        from repro_torch.telemetry import MetricsRegistry

        torch, dev = self.torch, self.dev
        t0 = time.perf_counter()
        gen = torch.Generator(device=dev).manual_seed(0)
        params = draw_serving_params(torch, cfg, gen, dev)
        n_params = sum(t.numel() for t in leaves(params))
        check(n_params == cfg.param_count(),
              f"{tag}: {n_params} params, expected {cfg.param_count()}")
        prompts = torch.randint(0, cfg.vocab, (requests, prompt_len), generator=gen,
                                device=dev).cpu().numpy()
        serve.serve_batch(params, cfg, prompts[:batch], 2, device=dev)    # cuBLAS warm-up
        reg = MetricsRegistry()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        ts = time.perf_counter()
        tokens = np.concatenate([serve.serve_batch(params, cfg, prompts[i:i + batch], gen_len,
                                                   device=dev, reg=reg)
                                 for i in range(0, requests, batch)])
        torch.cuda.synchronize()
        secs = time.perf_counter() - ts
        n_flash = ops.launch_counts()["flash_attention"]
        self.launches[f"{tag}_serve"] = n_flash
        self.combines[f"{tag}_serve"] = flash_attention.flash_attention.combine_launches
        peak = torch.cuda.max_memory_allocated()
        with torch.no_grad():
            b = {"tokens": torch.as_tensor(prompts[:batch], device=dev)}
            if cfg.family == "vlm":
                b["patches"] = torch.zeros((batch, cfg.n_patches, cfg.d_frontend),
                                           dtype=cfg.cdtype, device=dev)
            lg, _, _, st = T.forward(params, b, cfg)
            finite = bool(torch.isfinite(lg).all())
        check(n_flash == 0 and finite and tokens.shape == (requests, gen_len)
              and tokens.min() >= 0 and tokens.max() < cfg.vocab,
              f"{tag} serve: {n_flash} flash launches (expected 0: a cache takes the plain "
              f"path), logits finite {finite}, tokens {tokens.shape}")
        pre, dec = reg.histogram("serve.prefill.seconds"), reg.histogram("serve.decode.seconds")
        print(f"{cfg.name} ({cfg.n_layers} of {get_config(cfg.name).n_layers} layers, "
              f"{n_params:,} params, {cfg.cdtype}) served {requests} requests x {gen_len} "
              f"tokens at batch {batch} (prompt {prompt_len}"
              f"{f' after {cfg.n_patches} patches' if cfg.family == 'vlm' else ''}) in "
              f"{secs:.3f} s ({requests * gen_len / secs:.1f} tokens/s); prefill p50 "
              f"{pre.p50 * 1e3:.3f} ms, decode p50 {dec.p50 * 1e3:.3f} ms/token (p99 "
              f"{dec.p99 * 1e3:.3f}); peak memory {peak / 2**30:.2f} GiB; flash launches "
              f"{n_flash}; a forward of the first prompts: logits finite, MoE stats "
              f"{ {k: int(v) for k, v in st.items()} }; phase wall for this arch "
              f"{time.perf_counter() - t0:.2f} s ({self.smi})")
        del params
        torch.cuda.empty_cache()
        return tokens

    def train(self, tag, cfg, n_steps=6, tb=8, ts_=128):
        """Train ``cfg`` 6 AdamW steps at batch 8 x seq 128 from float32
        masters drawn from a seed, launch counters reset just before and read
        just after; then every flash call of a forward held to the plain
        version."""
        from repro_torch.configs import get_config
        from repro_torch.data.pipeline import DataConfig, _synthesize
        from repro_torch.kernels import flash_attention, ops
        from repro_torch.launch import train
        from repro_torch.launch.steps import make_train_step
        from repro_torch.models import transformer as T
        from repro_torch.models.layers import init_params
        from repro_torch.optim import AdamWConfig, adamw_init

        torch, dev = self.torch, self.dev
        t0 = time.perf_counter()
        masters = init_params(T.abstract_params(cfg), torch.Generator(device=dev).manual_seed(0))
        state = {"params": masters, "opt": adamw_init(masters)}
        del masters
        step = make_train_step(cfg, AdamWConfig(lr=3e-4), total_steps=n_steps,
                               warmup=max(n_steps // 20, 5))
        data = DataConfig(vocab=cfg.vocab, seq_len=ts_, global_batch=tb, seed=0)
        batches = [train.device_batch(_synthesize(data, s), cfg, dev) for s in range(n_steps)]
        if cfg.family == "vlm":
            # seeded patches, not the train CLI's zeros: a zero prefix row stays zero
            # through the stack, where rms_norm's derivative is rsqrt(eps) = 1000,
            # so at 24 layers the gradient overflows to NaN (the reference's too)
            pg = torch.Generator(device=dev).manual_seed(1)
            for b in batches:
                b["patches"] = torch.randn(b["patches"].shape, generator=pg,
                                           device=dev).to(cfg.cdtype)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        step_s, mets = [], []
        for b in batches:
            (state, m), secs = wall(torch, lambda: step(state, b))
            step_s.append(secs)
            mets.append({k: float(m[k]) for k in METRIC_KEYS})
        n_flash = ops.launch_counts()["flash_attention"]
        self.launches[f"{tag}_train"] = n_flash
        self.combines[f"{tag}_train"] = flash_attention.flash_attention.combine_launches
        peak = torch.cuda.max_memory_allocated()
        n_attn = sum(m == "attn" for m, _ in cfg.pattern) * cfg.n_periods
        if cfg.attn_impl != "flash":
            n_attn = 0
        expect = n_steps * n_attn * (2 if cfg.remat else 1)
        check(n_flash == expect, f"{tag} train launched flash {n_flash} times, expected {expect}")
        check(all(np.isfinite(list(m.values())).all() for m in mets), f"{tag} train: {mets}")
        med = statistics.median(step_s[1:])
        L = ts_ + (cfg.n_patches if cfg.family == "vlm" else 0)
        print(f"{cfg.name} ({cfg.n_layers} of {get_config(cfg.name).n_layers} layers, "
              f"{cfg.param_count():,} params) trained {n_steps} steps at batch {tb} x seq {ts_}"
              f"{f' after {cfg.n_patches} seeded patches' if cfg.family == 'vlm' else ''} (remat "
              f"{cfg.remat}): per step loss/grad_norm/aux/moe_drops/moe_peak_occupancy "
              f"{[[round(m[k], 4) for k in METRIC_KEYS] for m in mets]}; step "
              f"{med * 1e3:.3f} ms median of steps 2-{n_steps} (first {step_s[0] * 1e3:.3f} ms), "
              f"{tb * ts_ / med:,.0f} tokens/s; peak memory {peak / 2**30:.2f} GiB; flash "
              f"launches {n_flash} = {n_steps} steps x {n_attn} attention layers x "
              f"{2 if cfg.remat else 1} over {L} positions")
        if expect:
            lk, per_call = held_flash_calls(
                torch, lambda: T.loss(state["params"], batches[0], cfg)[0].item())
            check(len(per_call) == n_attn and max(per_call) <= 1e-2,
                  f"{tag}: flash calls of a training forward differ from the plain version by "
                  f"{max(per_call):.3e}")
            print(f"  every flash call of a training forward ({len(per_call)}) against the plain "
                  f"version on its own inputs: worst max |diff| / max |out| "
                  f"{max(per_call):.3e} (limit 1e-2); loss on batch 0 after training {lk:.5f}")
        print(f"  phase wall for this arch {time.perf_counter() - t0:.2f} s ({self.smi})")
        del state, batches
        torch.cuda.empty_cache()
        return mets


def families_phase(torch, dev, smi):
    """Phase 10: the MoE (phi3.5-moe, qwen3-moe), MLA (minicpm3-4b) and vlm
    (internvl2-1b) families served and trained on the card, the MoE layer on
    the one-rank gather engine, with the flash kernel in every training
    forward of an attention model."""
    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    run = FullWidth(torch, dev, smi)

    # (a) SMOKE on the card (kernel) against the CPU (plain versions), f32, the
    # MoE archs on the gather engine at flit buffer depth 2 (so packets drop):
    # forward logits and stack stats, greedy serve tokens, three train steps
    gather2 = dict(moe_impl="gather", moe_flit_buffer_depth=2)
    for arch, kw in (("phi3.5-moe-42b-a6.6b", gather2), ("qwen3-moe-235b-a22b", gather2),
                     ("minicpm3-4b", {}), ("internvl2-1b", {})):
        smoke_card_vs_cpu(torch, dev, arch, kw)

    # (b) phi3.5-moe at full width: served at 16 of 32 layers from bf16 (42 GB),
    # trained at 2 layers from float32 masters
    phi = get_config("phi3.5-moe-42b-a6.6b").replace(attn_impl="flash")
    run.serve("phi", phi.replace(n_layers=16))
    run.train("phi", phi.replace(n_layers=2))
    # (c) qwen3-moe at full width (128 experts top-8, QK-norm) served at 4 of
    # 94 layers from bf16; its training is held at SMOKE in (a)
    run.serve("qwen", get_config("qwen3-moe-235b-a22b").replace(attn_impl="flash", n_layers=4))
    # (d) minicpm3-4b FULL (62 layers, MLA), served uncut from bf16; trained at
    # full width cut to 31 layers (its float32 state at 62 layers, 65 GB, and
    # the optimizer's temporaries pass the card's 80 GB).  MLA never takes flash.
    mini = get_config("minicpm3-4b").replace(attn_impl="flash")
    run.serve("minicpm", mini)
    run.train("minicpm", mini.replace(n_layers=31))
    # (e) internvl2-1b FULL, uncut: served after its 256-patch prefix, trained
    # with flash over prefix + text = 384 positions
    vl = get_config("internvl2-1b").replace(attn_impl="flash")
    run.serve("internvl", vl)
    run.train("internvl", vl)
    print(f"families phase {time.perf_counter() - t_phase:.2f} s")
    return dict(launches=run.launches, combine_launches=run.combines)


def recurrent_phase(torch, dev, smi):
    """Phase 11: the hybrid (jamba-v0.1-52b: attention, Mamba and MoE) and
    xlstm (xlstm-350m: mLSTM and sLSTM) families served and trained on the
    card, and their three recurrent mixers alone at full width against the
    CPU."""
    from repro_torch.configs import get_config
    from repro_torch.models import ssm, xlstm
    from repro_torch.models.layers import init_params

    t_phase = time.perf_counter()
    run = FullWidth(torch, dev, smi)

    # (a) SMOKE on the card (flash kernel) against the CPU (plain versions), f32
    for arch in ("jamba-v0.1-52b", "xlstm-350m"):
        smoke_card_vs_cpu(torch, dev, arch, {})

    # (b) the mixers alone at full width, batch 4 x seq 128, float32: chunked
    # over the whole sequence, then a prefill of 127 tokens and one decode step
    # against a cache; card against CPU, outputs and states
    jamba, xl = get_config("jamba-v0.1-52b"), get_config("xlstm-350m")
    mamba_c = ssm.MambaConfig(jamba.d_model, jamba.mamba_d_state, jamba.mamba_d_conv,
                              jamba.mamba_expand, chunk=jamba.mamba_chunk)
    xl_c = xlstm.XLSTMConfig(xl.d_model, xl.n_heads, proj_factor=xl.xlstm_proj_factor,
                             chunk=xl.xlstm_chunk)
    mixers = (("mamba", mamba_c, ssm.mamba_specs, ssm.mamba_apply,
               lambda d: ssm.init_mamba_cache(mamba_c, 4, device=d)),
              ("mlstm", xl_c, xlstm.mlstm_specs, xlstm.mlstm_apply,
               lambda d: xlstm.init_mlstm_cache(xl_c, 4, device=d)),
              ("slstm", xl_c, xlstm.slstm_specs, xlstm.slstm_apply,
               lambda d: xlstm.init_slstm_cache(xl_c, 4, device=d)))
    for name, c, specs, apply, cache0 in mixers:
        p = init_params(specs(c), torch.Generator().manual_seed(0))
        x = torch.randn((4, 128, c.d_model), generator=torch.Generator().manual_seed(1))
        outs = []
        for d in ("cpu", dev):
            pd, xd = _to(p, d), x.to(d)
            with torch.no_grad():
                y, _ = apply(pd, xd, c)
                _, cache = apply(pd, xd[:, :127], c, cache0(d))
                y1, cache = apply(pd, xd[:, 127:], c, cache)
                outs.append([t.cpu() for t in (y, y1, *cache.values())])
                if d == dev:
                    _, secs = wall(torch, lambda: apply(pd, xd, c))
        gaps = [((a - b).abs().max() / max(a.abs().max().item(), 1.0)).item()
                for a, b in zip(*outs)]
        check(max(gaps) <= 1e-3, f"{name} at full width: card vs CPU gaps {gaps}")
        print(f"{name} alone at full width (d_model {c.d_model}, d_inner {c.d_inner}"
              f"{f', N {c.d_state}' if name == 'mamba' else f', {c.n_heads} heads'}) batch 4 "
              f"x seq 128, f32: card vs CPU max |diff| / scale: chunked {gaps[0]:.3e}, decode "
              f"step {gaps[1]:.3e}, states {max(gaps[2:]):.3e} (limit 1e-3); chunked forward "
              f"on the card {secs * 1e3:.3f} ms host wall, second call ({smi})")

    # (c) jamba-v0.1-52b at full width served at 16 of 32 layers (two whole
    # periods: 14 Mamba and 2 attention layers, 8 MoE ffns on the one-rank
    # gather engine) from bf16 with Mamba's a_log and d_skip in float32
    jamba = jamba.replace(attn_impl="flash")
    run.serve("jamba", jamba.replace(n_layers=16))
    # (d) jamba trained at full width on the 2-layer cut of its period's own
    # sub-layers, one Mamba and one attention layer with dense MLPs: the cut
    # that keeps the MoE ffn (3.68 B params) needs 55 GiB of float32 state
    # before AdamW's temporaries.  Its MoE is trained at SMOKE in (a).
    run.train("jamba", jamba.replace(pattern=(("mamba", "mlp"), ("attn", "mlp")), n_layers=2))
    # (e) xlstm-350m FULL, uncut, served and trained; no attention, so no flash
    run.serve("xlstm", xl)
    run.train("xlstm", xl)
    print(f"recurrent phase {time.perf_counter() - t_phase:.2f} s")
    return dict(launches=run.launches, combine_launches=run.combines)


SPMD_TOPOLOGIES = ("ring", "mesh", "torus", "fattree")
SPMD_CUTS = {"2 pods": (0,) * 4 + (1,) * 4, "4 pods": (0, 0, 1, 1, 2, 2, 3, 3),
             "interleaved": (0, 1) * 4}


def spmd_phase(torch, smi):
    """Phase 12: device-mesh execution (``mode="spmd"``, the route programs
    on a mesh, the bridged lowering, ``bmvm.iterate_spmd``), one NoC node per
    rank, every rank on the card.  CUDA is initialized here already, so the
    ranks start with ``spawn``; they join over gloo through a ``FileStore``
    with a 120 s group timeout; the kernel library that phase 2 built is only
    loaded.  A rank that fails or outlives the deadline fails the phase."""
    import torch.multiprocessing as mp

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    # the ranks inherit one OpenMP thread each and gloo on the loopback device
    os.environ.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_spmd_")
    res = {}
    try:
        for part, world in (("mesh8", 8), ("ldpc16", 16)):
            t0 = time.perf_counter()
            ctx = mp.start_processes(_spmd_rank, args=(world, tmp, part), nprocs=world,
                                     join=False, start_method="spawn")
            try:
                while not ctx.join(timeout=1.0):
                    check(time.perf_counter() - t0 < 400,
                          f"phase 12 ({part}): the ranks still run after 400 s")
            finally:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                    p.join(10)
            res[part] = []
            for r in range(world):
                with open(os.path.join(tmp, f"{part}-{r}.pkl"), "rb") as f:
                    res[part].append(pickle.load(f))
            print(f"  world of {world} ranks ({part}) started, ran and joined in "
                  f"{time.perf_counter() - t0:.2f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ranks = res["mesh8"]
    devices = sorted({(r["device"], r["name"]) for r in ranks})
    print(f"phase 12: {len(ranks)} ranks, backend {ranks[0]['backend']} (FileStore), every rank "
          f"computing on {', '.join(f'{d} ({n})' for d, n in devices)}: "
          f"{'the ranks share one card' if len(devices) == 1 else 'cards shared round-robin'}; "
          "CUDA tensors staged through the host at every transfer (gloo reads host memory); "
          f"kernel library loaded, built in {max(r['built_seconds'] for r in ranks)} s "
          f"in the ranks ({smi})")
    print(f"  (a) {ranks[0]['routes']} route-program cases on the (8, 8, 4096) uint8 cube "
          "(own axes, linearized, handwritten schedules, bridged x 2 pods / 4 pods / "
          "interleaved on ring/mesh/torus/fattree) equal to the transpose in every rank")
    for line in ranks[0]["executor"]:
        print(f"  (b) {line}")
    print(f"  (b) Fano LDPC, 10 iterations, 16-node mesh over 16 ranks: spmd == sim, NoCStats "
          f"== GOLDEN_LDPC_FANO in every rank ({len(res['ldpc16'])} ranks)")
    print(f"  (c) gf2_bmvm at the shard's shape lut {ranks[0]['shard_lut']} int32, words "
          f"{ranks[0]['shard_words']}: kernel == plain in every rank (max_abs_err "
          f"{max(r['shard_err'] for r in ranks)})")
    launches = 0
    for name in SPMD_TOPOLOGIES:
        per = [r["iterate"][name] for r in ranks]
        walls = [p["wall_ms"] for p in per]
        trans = [p["transport_ms"] for p in per]
        stage = [p["staging_ms"] for p in per]
        staged = [p["staged_per_iter"] for p in per]
        counts = [p["launches"] for p in per]
        launches += sum(counts)
        print(f"  (c) iterate_spmd n=4096 M=64 r=4 on {name}: equal to gf2_matmul_oracle "
              f"iterated; wall {min(walls):.3f}-{max(walls):.3f} ms, transport "
              f"{min(trans):.3f}-{max(trans):.3f} ms in {per[0]['calls']} transfers, of it the "
              f"copies to and from the host {min(stage):.3f}-{max(stage):.3f} ms (over "
              f"ranks); staged through the host {min(staged)}-{max(staged)} bytes per "
              f"iteration per rank; gf2_bmvm launches per rank {counts} ({smi})")
    print(f"spmd phase {time.perf_counter() - t_phase:.2f} s")
    return dict(launches=launches)


def _spmd_rank(rank, world, tmp, part):
    """One rank of phase 12: join the gloo group, run ``part`` on the card,
    write what it measured for the parent."""
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.launch.mesh import join_process_group

    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(tmp, f"store-{part}"),
                                                         world),
                            rank=rank, world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        dev = join_process_group("gloo", "cuda")
        out = (_spmd_mesh8 if part == "mesh8" else _spmd_ldpc16)(torch, dev, rank)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"{part}-{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def _spmd_ldpc16(torch, dev, rank):
    """The golden Fano LDPC run (phase 4's, 16-node mesh) in mode="spmd"."""
    from repro_torch.apps import ldpc

    llr7 = ldpc.awgn_llr(np.zeros(7, np.int8), 3.0, np.random.default_rng(0))
    bits, post, st = ldpc.decode_on_noc(ldpc.fano_plane_H(), llr7, 10, mode="spmd", device=dev)
    bits_s, post_s, st_s = ldpc.decode_on_noc(ldpc.fano_plane_H(), llr7, 10, device=dev)
    check(np.array_equal(bits, bits_s) and np.array_equal(post, post_s),
          f"rank {rank}: Fano LDPC spmd differs from sim")
    check(st.as_dict() == st_s.as_dict() == GOLDEN_LDPC_FANO,
          f"rank {rank}: Fano LDPC spmd NoCStats {st.as_dict()}")
    return {}


def _spmd_mesh8(torch, dev, rank):
    """Phase 12 (a)-(c) in one of 8 ranks; raises on any disagreement."""
    import torch.distributed as dist

    from repro_torch import core
    from repro_torch.apps import bmvm
    from repro_torch.apps import particle_filter as pf
    from repro_torch.core.collectives import make_mesh
    from repro_torch.kernels import _build, ops, ref

    out = dict(device=str(dev), name=torch.cuda.get_device_name(dev),
               backend=str(dist.get_backend()), built_seconds=_build.library().build_seconds)

    # (a) route programs on the mesh: a seeded (8, 8, 4096) uint8 cube, each
    # rank sends its node's row; the gathered rows must be the transpose
    gen = torch.Generator(device=dev).manual_seed(12)
    cube = torch.randint(0, 256, (8, 8, 4096), generator=gen, device=dev, dtype=torch.uint8)
    flat = make_mesh((("model", 8),), range(8))
    cases = 0

    def held(mesh, row, what):
        nonlocal cases
        check(torch.equal(mesh.gather_nodes(row), cube.transpose(0, 1)),
              f"rank {rank}: {what} differs from the transpose")
        cases += 1

    for name in SPMD_TOPOLOGIES:
        topo = core.make_topology(name, 8)
        prog = core.compile_routes(topo)
        mesh = core.mesh_for_topology(topo)
        row = cube[mesh.node]
        held(mesh, core.run_route_program(row, prog, mesh), f"run_route_program on {name}")
        held(flat, core.run_route_program(row, prog, flat, axis_name="model"),
             f"linearized run_route_program on {name}")
        held(mesh, core.all_to_all_for(topo, mesh)(row), f"all_to_all_for on {name}")
        for cut, pods in SPMD_CUTS.items():
            plan = core.PartitionPlan({}, pods, (), (),
                                      core.QuasiSerdesConfig(wire_bits=16, lanes=4))
            bprog = core.compile_bridges(prog, plan, core.BridgeConfig(serdes=plan.serdes_cfg))
            bm = core.mesh_for_partition(topo, plan)
            held(bm, core.run_bridged_program(row, bprog, bm, bm.axis_names),
                 f"run_bridged_program on {name}, {cut}")
    out["routes"] = cases

    # (b) the executor: mode="spmd" against mode="sim" on the card
    lines = []

    def pair(fn, what):
        (o_p, st_p), (o_s, st_s) = fn("spmd"), fn("sim")
        check(np.array_equal(o_p, o_s), f"rank {rank}: {what}: spmd outputs differ from sim")
        check(st_p.as_dict() == st_s.as_dict(),
              f"rank {rank}: {what}: NoCStats {st_p.as_dict()} vs sim {st_s.as_dict()}")
        return o_p, st_p

    rng = np.random.default_rng(0)
    cfg64 = bmvm.BMVMConfig(n=64, k=8, fold=2)
    A64 = rng.integers(0, 2, (64, 64)).astype(np.uint8)
    v64 = rng.integers(0, 2, (64,)).astype(np.uint8)
    lut64 = bmvm.preprocess(A64, cfg64, device=dev)
    sw = bmvm.software_ref(A64, v64[None], 3, device=dev)
    for name in SPMD_TOPOLOGIES:
        o, st = pair(lambda m: bmvm.iterate_noc_sim(lut64, v64, cfg64, 3, topology=name, mode=m,
                                                    device=dev), f"BMVM n=64 on {name}")
        check(np.array_equal(o.reshape(1, -1), sw), f"rank {rank}: BMVM n=64 on {name}")
    lines.append("BMVM n=64 r=3 on ring/mesh/torus/fattree (8 nodes): spmd == sim == "
                 "software_ref, NoCStats equal field for field")
    _, st = pair(lambda m: bmvm.iterate_noc_sim(lut64, v64, cfg64, 2, topology="mesh", mode=m,
                                                device=dev), "BMVM n=64 golden")
    check(st.as_dict() == GOLDEN_BMVM_64, f"rank {rank}: BMVM n=64 spmd NoCStats {st.as_dict()}")
    lines.append("BMVM n=64 r=2 on the mesh: spmd NoCStats == GOLDEN_BMVM_64")
    for cut in ("2 pods", "4 pods"):
        pods = list(SPMD_CUTS[cut])
        _, st = pair(lambda m: bmvm.iterate_noc_sim(lut64, v64, cfg64, 2, topology="mesh",
                                                    pods=pods, mode=m, device=dev),
                     f"BMVM n=64 cut into {cut}")
        check(st.bridge_beats > 0, f"rank {rank}: no bridge traffic in {cut}")
        lines.append(f"BMVM n=64 on the mesh cut into {cut}: spmd == sim with the bridge "
                     f"counters (bridge_beats {st.bridge_beats}, stall rounds "
                     f"{st.bridge_stall_rounds})")
    g, _ = bmvm.build_bmvm_graph(lut64, cfg64)
    ex = core.NoCExecutor(g, core.make_topology("mesh", 8), device=dev)
    vb = torch.as_tensor(rng.integers(0, 2, (4, 64)).astype(np.uint8), device=dev)
    vw = ref.gf2_pack_vector(vb, 8).view(torch.uint32)
    inputs = {f"lut{i}.v": vw[:, 2 * i:2 * i + 2] for i in range(cfg64.n_pe)}

    def batch(m):
        o, st = ex.run_batch(inputs, mode=m)
        return np.stack([o[k].view(torch.int32).cpu().numpy() for k in sorted(o)]), st

    _, st = pair(batch, "run_batch")
    lines.append(f"run_batch of the BMVM n=64 graph at B=4 on the mesh: spmd == sim "
                 f"(rounds {st.rounds}, link_bytes {st.link_bytes})")
    scfg = pf.PFConfig(img=128, roi=32, n_particles=256, n_bins=16)
    sframes, _ = pf.synth_video(scfg, 8, np.random.default_rng(4))
    _, st = pair(lambda m: pf.track_on_noc(sframes, scfg, n_pe=4, n_nodes=8, mode=m, device=dev),
                 "PF track_on_noc")
    lines.append(f"PF track_on_noc (4 PEs, 8-node mesh, 8 frames of 128^2): spmd == sim, "
                 f"flits {st.flits}")
    out["executor"] = lines

    # (c) bmvm.iterate_spmd at phase 3's size: n=4096, k=8, M=64, r=4
    gen = torch.Generator(device=dev).manual_seed(0)
    bcfg = bmvm.BMVMConfig(n=4096, k=8, fold=1)
    A = torch.randint(0, 2, (bcfg.n, bcfg.n), generator=gen, device=dev, dtype=torch.uint8)
    V = torch.randint(0, 2, (64, bcfg.n), generator=gen, device=dev, dtype=torch.uint8)
    lut = bmvm.preprocess(A, bcfg, device=dev)
    expect = V
    for _ in range(4):
        expect = ref.gf2_matmul_oracle(A, expect)
    c_loc = lut.shape[0] // 8
    lut_loc = lut[rank * c_loc:(rank + 1) * c_loc]
    vw_loc = ref.gf2_pack_vector(V, bcfg.k)[:, rank * c_loc:(rank + 1) * c_loc].contiguous()
    k_out = ops.gf2_bmvm(lut_loc, vw_loc)
    out["shard_err"] = (k_out.long() - ops.gf2_bmvm(lut_loc, vw_loc, use_kernel=False).long()
                        ).abs().max().item()
    check(out["shard_err"] == 0, f"rank {rank}: gf2_bmvm differs at the shard's shape")
    out["shard_lut"], out["shard_words"] = tuple(lut_loc.shape), tuple(vw_loc.shape)
    out["iterate"] = {}
    for name in SPMD_TOPOLOGIES:
        mesh = core.mesh_for_topology(core.make_topology(name, 8))
        bmvm.iterate_spmd(lut, V, bcfg, 4, mesh=mesh, topology=name, device=dev)   # warm-up
        mesh.stats.reset()
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = bmvm.iterate_spmd(lut, V, bcfg, 4, mesh=mesh, topology=name, device=dev)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        n_launch = ops.launch_counts()["gf2_bmvm"]
        check(torch.equal(got, expect), f"rank {rank}: iterate_spmd on {name} differs from the "
              "direct GF(2) product")
        check(n_launch > 0, f"rank {rank}: gf2_bmvm was not launched by iterate_spmd on {name}")
        # the final gather of the (64, 64) int32 shards stages one row out
        # and eight in; the rest is the four iterations' all-to-alls
        staged = dev.type == "cuda" and mesh.stages_cuda
        gather_bytes = (1 + 8) * got.shape[0] * c_loc * 4 if staged else 0
        out["iterate"][name] = dict(wall_ms=wall_ms, transport_ms=mesh.stats.seconds * 1e3,
                                    staging_ms=mesh.stats.staging_seconds * 1e3,
                                    calls=mesh.stats.calls, launches=n_launch,
                                    staged_per_iter=(mesh.stats.staged_bytes - gather_bytes) // 4)
    return out


def draw_serving_params(torch, cfg, gen, dev):
    """The params of ``cfg`` in their serving dtypes (``cfg.cdtype``, float32
    for ``T.FLOAT32_LEAVES``), drawn from ``gen`` by the reference's init
    rules, each stacked leaf a layer at a time: no leaf has a float32 copy
    whole (phi3.5-moe's experts are 27 GB a leaf in float32 at 16 layers).
    Slicing the layers axis keeps a stacked weight's fan-in rule."""
    import dataclasses

    from repro_torch.models import transformer as T
    from repro_torch.models.layers import init_param, is_spec

    def draw(sp, path):
        sp = dataclasses.replace(sp, dtype=T.serving_dtype(path, cfg.cdtype))
        if len(sp.shape) < 3:
            return init_param(gen, sp, dev)
        one = dataclasses.replace(sp, shape=sp.shape[1:], axes=sp.axes[1:])
        out = torch.empty(sp.shape, dtype=sp.dtype, device=dev)
        for layer in out:
            layer.copy_(init_param(gen, one, dev))
        return out

    # spec_tree_map's walk with each leaf's path: it draws in the spec tree's
    # insertion order, as the earlier phases drew (``flatten`` sorts the keys
    # and would change every draw)
    def walk(tree, path):
        if is_spec(tree):
            return draw(tree, path)
        return {k: walk(v, path + (k,)) for k, v in tree.items()}

    return walk(T.abstract_params(cfg), ())


def _to(x, device):
    """A copy on ``device`` (the train step updates its params in place)."""
    if isinstance(x, dict):
        return {k: _to(v, device) for k, v in x.items()}
    return x.to(device, copy=True)



if __name__ == "__main__":
    sys.exit(main())
