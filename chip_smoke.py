#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``
with ``nvcc``, then runs eighteen phases and raises on any failure:

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
   transport, and the bytes staged through the host per iteration;
13. the examples on the card — ``examples/*_torch.py`` (quickstart, the BMVM
   Table IV/V, LDPC and particle-filter case studies, LM train/restart/serve)
   run in process with no ``--device``, launch counters reset before each:
   their deterministic lines equal to the reference's, ``gf2_bmvm`` launched
   2225 times by Table IV, ``minsum_check`` 48 times by the BER sweep,
   ``particle_histogram`` 19 times by ``track``, the tracker's errors within
   2.0 px mean / 3.0 px max, the LM losses falling, the restart resuming from
   step 150, the quickstart and LM step-1 losses held to a ``--device cpu``
   rerun at rtol 1e-3; Table IV's columns, the device time of one
   ``gf2_bmvm`` launch at its shape and each example's wall printed;
   then ``python -m repro_torch.telemetry --app bmvm --mode buffered --out``
   and ``python -m repro_torch.launch.report --trace/--csv/--profile`` on
   that trace, each exiting 0;
14. the MoE layer on a device mesh — 4 ranks on a (1, 4) ``("data",
   "model")`` mesh, spawned as phase 12's: qwen3-moe's layer at full width
   (d 4096, 128 experts top-8) on a seeded (4, 32, 4096) input in float32
   and bf16, each rank drawing only its 32 experts, ``gather`` and ``noc``
   on four topologies against the one-rank engine with all 128 experts in
   this process, the noc topologies bit-identical, drops and peak equal
   across engines at the config's capacity and at flit buffer depth 2;
   qwen3-moe at full width cut to 4 of 94 layers, bf16, serving phase 10's
   traffic through ``serve_batch(mesh=)`` on ``noc`` and on ``gather``, every
   rank's tokens equal, the prefill on noc and each decode step demoted to
   gather with its warning; then 8 ranks on a (2, 4) mesh, the SMOKE layer
   against ``dense_ref``.  No kernel runs on this path;
15. tensor and data parallelism — 4 ranks spawned as phase 12's: llama3.2-1b
   FULL served from bf16 on a (1, 4) ``("data", "model")`` mesh (each rank a
   quarter of the heads, kv heads, MLP and vocab) on phase 9's traffic, every
   rank's tokens equal, each of the 16 decoder blocks in float32 held to the
   same block on one rank at 1e-4 x max |out|, SMOKE tokens on the mesh equal
   to the one-rank tokens; llama3.2-1b FULL trained 3 steps on a (2, 2) mesh
   at batch 8 x seq 128 (remat, flash on each rank's head block, every flash
   call of step 1 held to its plain version), step 1's loss and grad norm
   held to phase 9's one-rank step at rtol 1e-2, the bytes staged and the
   peak memory a rank a step printed (the loss keeps the logits the rank's
   vocab block); qwen3-moe's layer at full
   width through the backward on the (1, 4) mesh, ``gather`` and ``noc``, the
   gradients of x, the router and each rank's experts held to the one-rank
   engine's at 1e-5 x scale;
16. the mla, mamba, mlstm and slstm mixers on the model axis — 4 ranks
   spawned as phase 12's: minicpm3-4b FULL at 16 of 62 layers, jamba-v0.1-52b
   FULL at one period of 8 layers and xlstm-350m FULL on a (1, 4) mesh, every
   sub-layer in float32 held to the same sub-layer on one rank at 1e-4 x max
   |out|, one batch of 4 prompts served from bf16 with each rank drawing
   only its blocks (every rank's tokens equal), SMOKE tokens on the mesh
   equal to one rank's; xlstm-350m FULL and minicpm3-4b FULL at 4 layers
   trained 2 steps on a (2, 2) mesh, step 1's loss (bf16) and loss and grad
   norm (float32 compute) held to one rank's at rtol 1e-2; jamba's Mamba and
   attention sub-layers at full width through the backward on (1, 4), the
   gradients of x and of each rank's leaves held to one rank's at 1e-5
   (relative L2), flash on the rank's head block held to its plain version;
17. the cross-pod gradient exchange and elastic rescale — 4 ranks spawned as
   phase 12's: llama3.2-1b FULL on a (2, 1, 2) ``("pod", "data", "model")``
   mesh, one float32 step at batch 8 x seq 128 from one state under
   ``pod_sync="auto"`` and ``"serdes"`` with none, bf16 and int8 links, the
   grad norm and AdamW's m and v (over each leaf's max) held to auto's
   (1e-4 / 1e-5 none, 1e-3 / 1e-2 bf16, 1e-3 / 2e-2 int8), with each
   variant's wall, transport, staged and wire bytes, ppermutes, peak and
   flash launches; none at 4 layers on (2, 2, 1) held to one process's step
   on the whole batch; llama3.2-1b at 4 layers trained 2 steps on a (2, 2)
   mesh and saved, then restored by a world of 2 ranks through
   ``restore(shardings=remesh_plan(...))`` (the gathered blocks equal to the
   saved arrays bit for bit) and its float32 step held to one rank's; every
   float32 flash call of a step at each shape held to its plain version;
18. the multi-pod dry run and the H100 roofline — ``python -m
   repro_torch.launch.dryrun`` on the host (fake CUDA tensors, a no-op world
   of 256 or 512 ranks) over a named subset of cells, in parallel processes,
   each printed as the reference's CLI prints it with each record's
   ``temp_bytes`` and ``peak_bytes`` a rank (llama3.2-1b x train_4k's peak
   held under the card's memory), and
   ``python -m repro_torch.launch.report`` over them; then two real steps
   counted on the card by ``launch.roofline.CostCounter``: llama3.2-1b FULL
   trained one step at batch 8 x seq 128 and whisper-large-v3 FULL's
   prefill at batch 4 (prompt 32), both with flash, launch counters reset
   just before and read just after: the count over the real CUDA tensors
   equal to the count over fake copies of the same arguments (flops, bytes,
   raw bytes, every op), the counted flash ops equal to the launches and
   the combines to the expected count, every flash call held to its plain
   version, the synced wall beside the H100 roofline terms, and the custom
   op's host cost per call.

Prints the ``nvidia-smi`` name/power-limit line, one ``{"kernels": [...]}``
JSON line and, last, ``{"ok": true, "device": {...}}``.  Exits non-zero with
no result when no CUDA device is present or the port is not beside it.
"""
import contextlib
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
    t_script = time.perf_counter()
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
                                        ("internvl2-1b", (8, 14, 2, 384, 64)),
                                        # phase 15's mesh training: a rank's
                                        # batch and head block on (2, 2)
                                        ("llama3.2-1b, (2, 2) mesh", (4, 16, 4, 128, 64))):
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

    # -- phase 13: the examples on the card, and the report CLI ---------------------
    examples = examples_phase(torch, smi)

    # -- phase 14: the MoE layer on a device mesh, 4 and 8 ranks on the card --------
    moe_mesh_phase(torch, dev, smi)

    # -- phase 15: tensor and data parallelism of the LM, 4 ranks on the card ------
    tp = tp_phase(torch, dev, smi, dense)

    # -- phase 16: the mla, mamba, mlstm and slstm mixers on the model axis, 4 ranks
    tp2b = tp2b_phase(torch, dev, smi)

    # -- phase 17: the cross-pod gradient exchange and elastic rescale, 4 and 2 ranks
    pods = pod_phase(torch, dev, smi)

    # -- phase 18: the multi-pod dry run and the H100 roofline of two counted steps
    roof = roofline_phase(torch, dev, smi)
    phase3_path = {"gf2_bmvm": "iterate_kernel", "minsum_check": "decode_minsum",
                   "particle_histogram": "track"}
    for kern in kernels:
        if kern["name"] in phase3_path:
            paths = {phase3_path[kern["name"]]: kern["launches"]}
            if kern["name"] == "gf2_bmvm":
                paths["spmd"] = spmd["launches"]
            paths.update(examples["launches"][kern["name"]])
            kern["launches_by_path"] = paths
            kern["launches"] = sum(paths.values())
    for kern in kernels:
        if kern["name"] == "flash_attention":
            kern["launches_by_path"] = {"whisper_serve": serve_stats["launches"],
                                        "llama_serve": dense["serve_launches"],
                                        "llama_train": dense["train_launches"],
                                        **families["launches"], **recurrent["launches"],
                                        "llama_serve_mesh": tp["serve_launches"],
                                        "llama_train_mesh": tp["train_launches"],
                                        "jamba_attn_layer_mesh": tp2b["launches"],
                                        "llama_train_pods": pods["launches"],
                                        **roof["launches"]}
            kern["launches"] = sum(kern["launches_by_path"].values())
            kern["combine"]["launches_by_path"] = {
                "whisper_serve": serve_stats["combine_launches"], "llama_serve": 0,
                "llama_train": dense["train_combine_launches"],
                **families["combine_launches"], **recurrent["combine_launches"],
                "llama_serve_mesh": 0, "llama_train_mesh": tp["train_combine_launches"],
                "jamba_attn_layer_mesh": tp2b["combine_launches"],
                "llama_train_pods": pods["combine_launches"], **roof["combine_launches"]}
            kern["combine"]["launches"] = sum(kern["combine"]["launches_by_path"].values())

    print(f"chip_smoke phases 1-18 in {time.perf_counter() - t_script:.1f} s")
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
                train_combine_launches=train_combines, step1=(losses[0], gnorms[0]),
                step_ms=med * 1e3, serve_tokens=tokens)


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


# what the examples print that does not depend on the device: the reference's
# examples on the CPU print the same (tests/test_torch_examples*.py)
EXAMPLE_NOC_STATS = dict(GOLDEN_BMVM_64, waves=3, rounds=4, link_bytes=2048, payload_bytes=64,
                         flits=32)
EXAMPLE_TABLE_V = {"ring": ("62", "1015808", "65.62"), "mesh": ("20", "548864", "14.49"),
                   "torus": ("12", "327680", "8.33"), "fattree": ("2", "31744", "1.32")}
EXAMPLE_LINES = {
    "quickstart": ["single-pod NoC result: [ 1.  9. 25. 49.] ...",
                   "  network stats: " + str(EXAMPLE_NOC_STATS),
                   "2-pod partition identical; cross-pod msgs: 1 wire bytes: 32",
                   "traced run: 32 events -> 45 Perfetto events; trace aggregation "
                   "reproduces NoCStats bit-exactly"],
    "gf2_bmvm_topologies": ["Table-IV analog: n=64 k=8 fold=2 (4 PEs), LUT (8, 256, 8) = 64 KiB"],
    "ldpc_decode": ["  chk0   raw=  24B wrapped= 120B overhead=+4.00x",
                    "  chk3   raw=  24B wrapped= 120B overhead=+4.00x",
                    "single-FPGA 4x4 mesh: decoded=[0 0 0 0 0 0 0] (rounds=60, flits=420)",
                    "2-FPGA partition (dotted arc): identical decode; cross-chip msgs=180, "
                    "wire bytes=2880",
                    "  SNR 1.0 dB: uncoded BER 0.0533  coded BER 0.0032",
                    "  SNR 2.0 dB: uncoded BER 0.0355  coded BER 0.0012",
                    "  SNR 3.0 dB: uncoded BER 0.0242  coded BER 0.0000",
                    "  SNR 4.0 dB: uncoded BER 0.0142  coded BER 0.0000"],
    "particle_tracking": ["  pe0    raw= 16588B wrapped= 16668B",
                          "  pe3    raw= 16588B wrapped= 16668B",
                          "  root   raw=    56B wrapped=   200B"],
    "train_lm": ["restored from step 150", "generated token matrix: (8, 8)"],
}
# kernel -> (example, launches, key in launches_by_path): Table IV runs r = 3
# once and 1/10/100/1000 twice (warm + timed); the BER sweep 4 SNRs x 12
# iterations; track 20 - 1 frames
EXAMPLE_LAUNCHES = {
    "gf2_bmvm": ("gf2_bmvm_topologies", 3 + 2 * (1 + 10 + 100 + 1000), "example_table_iv"),
    "minsum_check": ("ldpc_decode", 48, "example_ber_sweep"),
    "particle_histogram": ("particle_tracking", 19, "example_track")}


def run_example(torch, name, argv):
    """Run ``examples/<name>_torch.py`` in process as ``__main__`` with
    ``sys.argv[1:] = argv``: (stdout, synced wall seconds)."""
    import contextlib
    import io
    import runpy

    path = os.path.join(HERE, "examples", f"{name}_torch.py")
    buf = io.StringIO()
    saved = sys.argv
    sys.argv = [path] + argv
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            runpy.run_path(path, run_name="__main__")
    finally:
        sys.argv = saved
    torch.cuda.synchronize()
    return buf.getvalue(), time.perf_counter() - t0


def step_losses(out):
    """The train driver's logged losses, one list per train run of ``out``."""
    runs = []
    for line in out.splitlines():
        if line.startswith("arch="):
            runs.append([])
        found = re.match(r"step +(\d+) +loss ([\d.]+) ", line)
        if found:
            runs[-1].append(float(found.group(2)))
    return runs


def examples_phase(torch, smi):
    """Phase 13: the five ``examples/*_torch.py`` run in process with no
    ``--device`` (so on the card), each with the launch counters reset just
    before and read just after; their deterministic lines held to the
    reference's values, their kernels' launches counted, the LM examples'
    step-1 losses held to a ``--device cpu`` rerun (rtol 1e-3); then a
    buffered BMVM trace through ``python -m repro_torch.telemetry`` and
    ``python -m repro_torch.launch.report`` over it."""
    from repro_torch.kernels import ops

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    outs, walls, counts = {}, {}, {}
    for name in EXAMPLE_LINES:
        ops.reset_launch_counts()
        outs[name], walls[name] = run_example(torch, name, [])
        counts[name] = ops.launch_counts()
        print(f"examples/{name}_torch.py on the card: wall {walls[name]:.3f} s, kernel "
              f"launches {counts[name]} ({smi}); its stdout:")
        for line in outs[name].splitlines():
            print(f"  | {line}")
    for name, lines in EXAMPLE_LINES.items():
        got = outs[name].splitlines()
        missing = [ln for ln in lines if ln not in got]
        check(not missing, f"examples/{name}_torch.py did not print {missing}")
    launches = {}
    for kname, (name, want, path) in EXAMPLE_LAUNCHES.items():
        got = counts[name][kname]
        check(got == want, f"{kname} launched {got} times in examples/{name}_torch.py, "
                           f"not {want}")
        launches[kname] = {path: got}

    # Table IV on the card: the kernel column and the host software column
    rows = [ln.split() for ln in outs["gf2_bmvm_topologies"].splitlines()
            if re.match(r"^ +\d+ +[\d.]+ +[\d.]+ +[\d.]+$", ln)]
    check([r[0] for r in rows] == ["1", "10", "100", "1000"], f"Table IV rows {rows}")
    print("Table IV on the card (n=64 k=8, M=4): r / software_ref on the host CPU (us) / "
          "iterate_kernel with gf2_bmvm (us) / speedup: "
          + "; ".join(" / ".join(r) for r in rows) + f" ({smi})")
    # the device time of one launch at Table IV's shape, against the host's
    g = torch.Generator(device="cuda").manual_seed(0)
    lut = torch.randint(-2**31, 2**31 - 1, (8, 256, 8), generator=g, device="cuda",
                        dtype=torch.int32)
    vw = torch.randint(0, 256, (4, 8), generator=g, device="cuda", dtype=torch.int32)
    dev_us = timed(torch, lambda: ops.gf2_bmvm(lut, vw)) * 1e3
    print(f"gf2_bmvm at Table IV's shape (LUT (8, 256, 8), words (4, 8)): {dev_us:.2f} us of "
          f"device time a launch (CUDA events, median of 25) against "
          f"{float(rows[-1][2]) / 1000:.2f} us a launch on the host clock in the r=1000 row "
          f"({smi})")
    table_v = {ln.split()[0]: tuple(ln.split()[1:3] + ln.split()[4:5])
               for ln in outs["gf2_bmvm_topologies"].splitlines()
               if ln.split()[:1] and ln.split()[0] in EXAMPLE_TABLE_V}
    check(table_v == EXAMPLE_TABLE_V, f"Table V rounds/link_bytes/model_us {table_v}")
    sim_ms = {ln.split()[0]: ln.split()[3] for ln in outs["gf2_bmvm_topologies"].splitlines()
              if ln.split()[:1] and ln.split()[0] in EXAMPLE_TABLE_V}
    print(f"Table V on the card: rounds and link_bytes equal to the reference's; sim_ms "
          f"{sim_ms} ({smi})")

    # the particle filter: the card's generator draws its own noise; bounds
    pf_out = outs["particle_tracking"]
    mean, mx = (float(x) for x in re.search(
        r"kernel path: +mean err ([\d.]+)px +max ([\d.]+)px", pf_out).groups())
    check("(flits=456, rounds=76)" in pf_out, "PF NoC flits/rounds differ from 456/76")
    check(mean <= 2.0 and mx <= 3.0, f"PF errors {mean} px mean, {mx} px max on the card "
                                     "(bounds 2.0 / 3.0)")
    print(f"PF on the card: mean error {mean} px, max {mx} px (bounds 2.0 / 3.0; the CPU "
          "run: 1.25 / 1.78, the reference: 1.33 / 2.04)")

    # the LM examples: losses fall; restart; card vs CPU at step 1
    qs, lm = step_losses(outs["quickstart"]), step_losses(outs["train_lm"])
    check(len(qs) == 1 and len(qs[0]) == 5 and qs[0][-1] < qs[0][0],
          f"quickstart losses {qs}")
    check(len(lm) == 2 and len(lm[0]) == 7 and len(lm[1]) == 3
          and all(r[-1] < r[0] for r in lm), f"train_lm losses {lm}")
    lm_out = outs["train_lm"]
    check(lm_out.index("restored from step 150") < lm_out.index("done: 50 steps"),
          "train_lm did not resume from step 150 and run 50 more steps")
    gaps = []
    for name, card in (("quickstart", qs), ("train_lm", lm)):
        out, secs = run_example(torch, name, ["--device", "cpu"])
        cpu = step_losses(out)
        check(len(cpu) == len(card), f"{name} on the CPU: losses {cpu}")
        gap = abs(card[0][0] - cpu[0][0]) / abs(cpu[0][0])
        check(gap <= 1e-3, f"{name}: step-1 loss {card[0][0]} on the card vs {cpu[0][0]} "
                           "on the CPU")
        gaps.append(f"{name} {card[0][0]} vs {cpu[0][0]} ({gap:.2e})")
        # the later logged losses are printed, not held: they follow 150 steps
        # of rounding differences between the card and the CPU
        print(f"examples/{name}_torch.py --device cpu: wall {secs:.3f} s; every logged loss "
              f"on the card {card} and on the CPU {cpu}")
    print("step-1 losses card vs CPU (rtol 1e-3; the same seeded weights and batches): "
          + "; ".join(gaps))

    # a buffered BMVM trace through the telemetry CLI, then the report CLI
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_report_")
    try:
        trace = os.path.join(tmp, "bmvm_buffered.json")
        for args in (["-m", "repro_torch.telemetry", "--app", "bmvm", "--mode", "buffered",
                      "--out", trace],
                     ["-m", "repro_torch.launch.report", "--trace", trace],
                     ["-m", "repro_torch.launch.report", "--trace", trace, "--csv"],
                     ["-m", "repro_torch.launch.report", "--profile", trace]):
            t0 = time.perf_counter()
            r = subprocess.run([sys.executable] + args, capture_output=True, text=True,
                               env=env, cwd=HERE, timeout=300)
            check(r.returncode == 0 and r.stdout.strip(),
                  f"python {' '.join(args)} exited {r.returncode}: {r.stderr[-2000:]}")
            print(f"python {' '.join(a if a != trace else 'TRACE' for a in args)}: exit 0 in "
                  f"{time.perf_counter() - t0:.2f} s, {len(r.stdout.splitlines())} lines, "
                  f"first: {r.stdout.splitlines()[0]!r}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print("examples walls on the card: " + ", ".join(f"{n} {w:.3f} s" for n, w in walls.items())
          + f" ({smi})")
    print(f"examples phase {time.perf_counter() - t_phase:.2f} s")
    return dict(launches=launches, walls=walls, table_iv_launch_us=dev_us)


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


def _spmd_rank(rank, world, tmp, part, args=()):
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
        out = {"mesh8": _spmd_mesh8, "ldpc16": _spmd_ldpc16, "moe4": _moe_mesh4,
               "moe8": _moe_mesh8, "tp4": _tp_mesh4, "tp2b4": _tp2b_mesh4, "pod4": _pod_mesh4,
               "elastic2": _elastic_restore2}[part](torch, dev, rank, *args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"{part}-{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


MOE_SEED = 14
MOE_X_SHAPE = (4, 32, 4096)                  # batch 4 x seq 32 at qwen3-moe's d_model
MOE_TOPOLOGIES = ("fattree", "ring", "mesh2d", "torus2d")
MOE_TOL = {"float32": 1e-4, "bfloat16": 2e-2}   # x max(1, max |one-rank out|)


def moe_mesh_phase(torch, dev, smi):
    """Phase 14: the MoE layer on a device mesh (``impl="gather"`` and
    ``"noc"`` over a ``("data", "model")`` mesh of gloo ranks on the card),
    spawned as phase 12's ranks are, each world with a 400 s deadline:

    (a) one qwen3-moe layer at full width (d 4096, 128 experts top-8, f 1536)
        on x (4, 32, 4096) from a seed, in float32 and bf16, on a (1, 4) mesh
        of 4 ranks, each rank drawing only its 32 experts (each expert from a
        generator seeded by (seed, layer, expert, leaf)): at capacity_factor
        8 gather and noc on four topologies within ``MOE_TOL`` of the
        one-rank engine that this process runs with all 128 experts, drop
        free; the four noc topologies bit-identical; at the config's
        capacity gather's and noc's drops and peak equal;
    (b) qwen3-moe at full width cut to 4 of 94 layers, bf16, on that mesh:
        phase 10's traffic (16 requests at batch 4, prompt 32, 16 tokens)
        served through ``serve_batch(mesh=)`` with ``moe_impl="noc"``
        (torus2d) and with ``"gather"``; every rank's tokens equal, the
        prefill on noc, every decode step demoted to gather with the
        warning;
    (c) a (2, 4) mesh of 8 ranks: the qwen3-moe SMOKE layer in float32, the
        engines against ``dense_ref`` within 1e-4.

    No kernel of the port runs here: the MoE path is plain PyTorch and the
    serve prefill holds a cache, which takes attention's plain path."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe as M

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    cfg = get_config("qwen3-moe-235b-a22b")
    E, d, k, f = cfg.n_experts, cfg.d_model, cfg.top_k, cfg.d_ff_expert

    # the one-rank engine with all 128 experts, in this process
    w = moe_layer_weights(torch, cfg, dev, range(E))
    x = moe_input(torch, dev)
    one = {}
    c = M.MoEConfig(d, E, k, f, capacity_factor=8.0, impl="gather")
    with torch.no_grad():
        for dt in (torch.float32, torch.bfloat16):
            xd = x.to(dt)
            M.moe_apply(w, xd, c)                                # warm-up
            (out, _, st), secs = wall(torch, lambda: M.moe_apply(w, xd, c))
            one[str(dt).split(".")[1]] = (out.float().cpu().numpy(), int(st.drops), secs)
    del w, out
    torch.cuda.empty_cache()

    ranks4 = run_ranks(torch, "moe4", 4)
    ranks8 = run_ranks(torch, "moe8", 8)
    r0 = ranks4[0]
    print(f"phase 14: MoE layer on a (1, 4) mesh of 4 ranks and a (2, 4) mesh of 8, backend "
          f"{r0['backend']} (FileStore), every rank on {r0['device']} ({r0['name']}); CUDA "
          f"tensors staged through the host at every transfer ({smi})")

    # (a) every rank's outputs bit-equal; the noc topologies bit-identical; each
    # engine within MOE_TOL of the one-rank engine
    for key in r0["digest"]:
        check(all(r["digest"][key] == r0["digest"][key] for r in ranks4),
              f"phase 14 (a): the ranks' outputs differ for {key}")
    for dt, tol in MOE_TOL.items():
        ref, ref_drops, ref_secs = one[dt]
        check(ref_drops == 0, f"phase 14 (a): the one-rank engine dropped {ref_drops} in {dt}")
        nocs = {r0["digest"][(dt, f"noc-{t}")] for t in MOE_TOPOLOGIES}
        check(len(nocs) == 1, f"phase 14 (a): the noc topologies differ in {dt}")
        scale = max(1.0, float(np.abs(ref).max()))
        for eng in ["gather"] + [f"noc-{t}" for t in MOE_TOPOLOGIES]:
            got = r0["out"][(dt, eng)]
            err = float(np.abs(got - ref).max())
            st = r0["runs"][(dt, eng)]
            check(err <= tol * scale and st["drops"] == 0,
                  f"phase 14 (a): {eng} in {dt}: max |diff| {err:.3e} against the one-rank "
                  f"engine (limit {tol} x {scale:.3f}), drops {st['drops']}")
            walls = [r["runs"][(dt, eng)]["wall_ms"] for r in ranks4]
            trans = [r["runs"][(dt, eng)]["transport_ms"] for r in ranks4]
            print(f"  (a) {eng:13s} {dt:8s} max |diff| {err:.3e} against the one-rank engine "
                  f"(limit {tol} x {scale:.3f}); drops 0; rounds {st['rounds']}, flits "
                  f"{st['flits']}, link_bytes {st['link_bytes']}; wall {min(walls):.3f}-"
                  f"{max(walls):.3f} ms over ranks, of it transport {min(trans):.3f}-"
                  f"{max(trans):.3f} ms in {st['calls']} transfers, staged {st['staged']} bytes a "
                  f"rank")
        print(f"  (a) one-rank engine, {dt}, {E} experts in one process: wall "
              f"{ref_secs * 1e3:.3f} ms; the four noc topologies bit-identical")
    cap = r0["config_capacity"]
    for depth, what in ((0, f"the config's capacity factor {cfg.capacity_factor}"),
                        (2, "flit buffer depth 2")):
        g, n = cap[(depth, "gather")], cap[(depth, "noc")]
        check(g == n and (depth == 0 or g[0] > 0),
              f"phase 14 (a): at {what} gather (drops, peak, capacity) {g} != noc {n}")
        print(f"  (a) at {what} (capacity {g[2]} slots a FIFO): gather and noc drops {g[0]}, "
              f"peak {g[1]}, equal")

    # (b) the served tokens: every rank equal; prefill on noc, decode on gather
    for impl in ("noc", "gather"):
        runs = [r["serve"][impl] for r in ranks4]
        check(all(np.array_equal(s["tokens"], runs[0]["tokens"]) for s in runs),
              f"phase 14 (b): the ranks served different tokens on {impl}")
        s = runs[0]
        want_pre = "noc" if impl == "noc" else "gather"
        check(s["engines"] == {("prefill", want_pre): 4 * 4, ("decode", "gather"): 4 * 15 * 4}
              and s["tokens"].shape == (16, 16) and s["flash"] == 0,
              f"phase 14 (b) {impl}: engines {s['engines']}, tokens {s['tokens'].shape}, "
              f"flash launches {s['flash']}")
        if impl == "noc":
            check(s["decode_warnings"] == 4 * 15 * 4,
                  f"phase 14 (b): {s['decode_warnings']} decode-shaped warnings, expected 240")
        peak = max(r["serve"][impl]["peak"] for r in ranks4)
        print(f"  (b) qwen3-moe-235b-a22b (4 of 94 layers, bf16, {s['params']:,} params a rank) "
              f"moe_impl={impl!r}: 16 requests x 16 tokens at batch 4 (prompt 32) in "
              f"{s['secs']:.3f} s ({16 * 16 / s['secs']:.1f} tokens/s); prefill p50 "
              f"{s['prefill_ms']:.3f} ms, decode p50 {s['decode_ms']:.3f} ms/token; transport "
              f"{s['transport_s']:.3f} s in {s['calls']} transfers, of it staging "
              f"{s['staging_s']:.3f} s, {s['staged'] / 2**20:.1f} MiB staged a rank; prefill "
              f"drops {s['drops']}; engines {s['engines']}; decode-shaped warnings "
              f"{s['decode_warnings']}; peak memory {peak / 2**30:.2f} GiB a rank; every "
              f"rank's tokens equal ({smi})")
    same = np.array_equal(r0["serve"]["noc"]["tokens"], r0["serve"]["gather"]["tokens"])
    print(f"  (b) noc and gather served {'the same' if same else 'different'} tokens "
          f"({int((r0['serve']['noc']['tokens'] != r0['serve']['gather']['tokens']).sum())} of "
          "256 differ; bf16 sums in another order may flip a greedy token)")

    # (c) the (2, 4) mesh at SMOKE
    for key in ranks8[0]["digest"]:
        check(all(r["digest"][key] == ranks8[0]["digest"][key] for r in ranks8),
              f"phase 14 (c): the ranks' outputs differ for {key}")
    errs = ranks8[0]["errs"]
    check(max(errs.values()) <= 1e-4 and not any(ranks8[0]["drops"].values()),
          f"phase 14 (c): against dense_ref {errs}, drops {ranks8[0]['drops']}")
    print(f"  (c) qwen3-moe SMOKE layer ({ranks8[0]['layer']}) on a (2, 4) mesh of 8 ranks, "
          f"float32: max |diff| against dense_ref {errs} (limit 1e-4), drop free, every rank "
          "equal")
    print(f"moe mesh phase {time.perf_counter() - t_phase:.2f} s")


def expert_seed(seed, layer, expert, leaf):
    """The seed of one expert's leaf: any rank rebuilds any expert alone."""
    return ((seed * 1000 + layer) * 1000 + expert) * 10 + ("gate", "up", "down").index(leaf)


def draw_expert(torch, spec, dev, seed, layer, expert, leaf):
    """One expert of a stacked (E, a, b) spec, by the reference's init rules."""
    import dataclasses

    from repro_torch.models.layers import init_param

    one = dataclasses.replace(spec, shape=spec.shape[-2:], axes=spec.axes[-2:])
    gen = torch.Generator(device=dev).manual_seed(expert_seed(seed, layer, expert, leaf))
    return init_param(gen, one, dev)


def moe_layer_weights(torch, cfg, dev, experts, seed=MOE_SEED):
    """Layer 0 of ``cfg``'s MoE in float32: the router from the seed, and
    gate/up/down of ``experts`` (ids), each from its own seed."""
    from repro_torch.models import moe as M
    from repro_torch.models.layers import init_param

    specs = M.moe_specs(M.MoEConfig(cfg.d_model, cfg.n_experts, cfg.top_k, cfg.d_ff_expert))
    w = {"router": init_param(torch.Generator(device=dev).manual_seed(seed), specs["router"],
                              dev)}
    for leaf in ("gate", "up", "down"):
        w[leaf] = torch.stack([draw_expert(torch, specs[leaf], dev, seed, 0, e, leaf)
                               for e in experts])
    return w


def moe_input(torch, dev):
    gen = torch.Generator(device=dev).manual_seed(MOE_SEED + 1)
    return torch.randn(MOE_X_SHAPE, generator=gen, device=dev)


def run_ranks(torch, part, world, deadline=400.0, args=()):
    """Spawn ``world`` ranks running ``part`` (phase 12's ``_spmd_rank``)
    with ``args`` after its own, wait for them with a deadline, and return
    what each wrote, in rank order; a rank that fails or outlives the
    deadline fails the run."""
    import torch.multiprocessing as mp

    os.environ.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo")
    tmp = tempfile.mkdtemp(prefix=f"chip_smoke_{part}_")
    t0 = time.perf_counter()
    try:
        ctx = mp.start_processes(_spmd_rank, args=(world, tmp, part, args), nprocs=world,
                                 join=False, start_method="spawn")
        try:
            while not ctx.join(timeout=1.0):
                check(time.perf_counter() - t0 < deadline,
                      f"{part}: the ranks still run after {deadline:.0f} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(10)
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"{part}-{r}.pkl"), "rb") as fh:
                out.append(pickle.load(fh))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"  world of {world} ranks ({part}) started, ran and joined in "
          f"{time.perf_counter() - t0:.2f} s")
    return out


def _digest(t):
    """A hash of a tensor's values (bf16 widens to float32 exactly)."""
    import hashlib

    return hashlib.sha256(t.detach().float().cpu().numpy().tobytes()).hexdigest()


def _moe_mesh4(torch, dev, rank):
    """Phase 14 (a) and (b) in one of 4 ranks on a (1, 4) mesh."""
    import collections
    import warnings

    import torch.distributed as dist

    from repro_torch._tree import leaves
    from repro_torch.configs import get_config
    from repro_torch.core.noc import NoCConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_host_mesh, set_mesh
    from repro_torch.models import moe as M
    from repro_torch.telemetry import MetricsRegistry

    mesh = make_host_mesh(model=4)
    coord = mesh.axis("model").coord
    out = dict(device=str(dev), name=torch.cuda.get_device_name(dev),
               backend=str(dist.get_backend()), digest={}, runs={}, out={}, serve={})
    cfg = get_config("qwen3-moe-235b-a22b")
    E, d, k, f = cfg.n_experts, cfg.d_model, cfg.top_k, cfg.d_ff_expert
    epr = E // 4

    # (a) the rank's 32 experts, drawn alone
    w = moe_layer_weights(torch, cfg, dev, range(coord * epr, (coord + 1) * epr))
    x = moe_input(torch, dev)
    engines = [("gather", "fattree")] + [("noc", t) for t in MOE_TOPOLOGIES]
    with set_mesh(mesh), torch.no_grad():
        for dt in (torch.float32, torch.bfloat16):
            name = str(dt).split(".")[1]
            xd = x.to(dt)
            for impl, topo in engines:
                key = (name, impl if impl == "gather" else f"noc-{topo}")
                c = M.MoEConfig(d, E, k, f, capacity_factor=8.0, impl=impl, noc_topology=topo)
                M.moe_apply(w, xd, c)                        # warm-up
                torch.cuda.synchronize()
                mesh.stats.reset()
                (o, _, st), secs = wall(torch, lambda: M.moe_apply(w, xd, c))
                out["digest"][key] = _digest(o)
                out["runs"][key] = dict(drops=int(st.drops), rounds=st.rounds, flits=st.flits,
                                        link_bytes=st.link_bytes, wall_ms=secs * 1e3,
                                        transport_ms=mesh.stats.seconds * 1e3,
                                        calls=mesh.stats.calls, staged=mesh.stats.staged_bytes)
                check(st.engine == impl and st.fallback is None,
                      f"rank {rank}: {key} ran {st.engine} ({st.fallback})")
                if rank == 0:
                    out["out"][key] = o.float().cpu().numpy()
        cap = {}
        for depth in (0, 2):            # the config's capacity formula, and 2 slots
            for impl in ("gather", "noc"):
                c = M.MoEConfig(d, E, k, f, capacity_factor=cfg.capacity_factor, impl=impl,
                                noc_topology=cfg.moe_topology,
                                noc=NoCConfig(flit_buffer_depth=depth) if depth else None)
                _, _, st = M.moe_apply(w, x, c)
                cap[(depth, impl)] = (int(st.drops), int(st.peak_occupancy), st.capacity)
        out["config_capacity"] = cap
    del w
    torch.cuda.empty_cache()

    # (b) qwen3-moe at 4 layers, bf16, served on the mesh under noc and gather
    prompts = torch.randint(0, cfg.vocab, (16, 32), generator=torch.Generator(
        device=dev).manual_seed(0), device=dev).cpu().numpy()
    record = collections.Counter()
    drops = []
    apply = M.moe_apply

    def recorded(p, h, c, **kw):
        o, aux, st = apply(p, h, c, **kw)
        record[("prefill" if h.shape[1] > 1 else "decode", st.engine)] += 1
        if h.shape[1] > 1:
            drops.append(st.drops)
        return o, aux, st

    params = draw_mesh_serving_params(torch, cfg.replace(n_layers=4), dev, mesh)
    n_params = sum(t.numel() for t in leaves(params))
    for impl in ("noc", "gather"):
        scfg = cfg.replace(n_layers=4, attn_impl="flash", moe_impl=impl)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            serve.serve_batch(params, scfg, prompts[:4], 2, device=dev, mesh=mesh)  # warm-up
        reg = MetricsRegistry()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mesh.stats.reset()
        ops.reset_launch_counts()
        record.clear()
        drops.clear()
        M.moe_apply = recorded
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                ts = time.perf_counter()
                tokens = np.concatenate([serve.serve_batch(params, scfg, prompts[i:i + 4], 16,
                                                           device=dev, reg=reg, mesh=mesh)
                                         for i in range(0, 16, 4)])
                torch.cuda.synchronize()
                secs = time.perf_counter() - ts
        finally:
            M.moe_apply = apply
        pre, dec = reg.histogram("serve.prefill.seconds"), reg.histogram("serve.decode.seconds")
        out["serve"][impl] = dict(
            tokens=tokens, secs=secs, prefill_ms=pre.p50 * 1e3, decode_ms=dec.p50 * 1e3,
            transport_s=mesh.stats.seconds, staging_s=mesh.stats.staging_seconds,
            calls=mesh.stats.calls, staged=mesh.stats.staged_bytes,
            drops=int(sum(int(t) for t in drops)), engines=dict(record), params=n_params,
            flash=ops.launch_counts()["flash_attention"],
            decode_warnings=sum("decode-shaped" in str(m.message) for m in caught),
            peak=torch.cuda.max_memory_allocated())
    del params
    torch.cuda.empty_cache()
    return out


def draw_mesh_serving_params(torch, cfg, dev, mesh, seed=MOE_SEED):
    """``cfg``'s params in their serving dtypes, this rank's block of each
    leaf on ``mesh`` (`models.layers.leaf_pspec`): every leaf but the
    experts from one seeded generator (the same on every rank), a layer at a
    time, then cut; the MoE gate/up/down leaves only the rank's block of
    experts, each expert from its own seed (`expert_seed`)."""
    import dataclasses

    from repro_torch.core.partition import block
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import init_param, is_spec, leaf_pspec

    gen = torch.Generator(device=dev).manual_seed(seed)
    coord = mesh.axis("model").coord
    n_model = mesh.axis("model").size

    def draw(sp, path):
        spec = leaf_pspec(sp, mesh)
        sp = dataclasses.replace(sp, dtype=T.serving_dtype(path, cfg.cdtype))
        if path[-2:-1] == ("moe",) and path[-1] in ("gate", "up", "down"):
            L, E = sp.shape[:2]
            epr = E // n_model
            out = torch.empty((L, epr) + sp.shape[2:], dtype=sp.dtype, device=dev)
            for layer in range(L):
                for j in range(epr):
                    out[layer, j] = draw_expert(torch, sp, dev, seed, layer, coord * epr + j,
                                                path[-1])
            return out
        if len(sp.shape) < 3:
            return block(init_param(gen, sp, dev), spec, mesh).clone()
        one = dataclasses.replace(sp, shape=sp.shape[1:], axes=sp.axes[1:])
        layers = [block(init_param(gen, one, dev), spec[1:], mesh).clone()
                  for _ in range(sp.shape[0])]
        return torch.stack(layers)

    def walk(tree, path):
        if is_spec(tree):
            return draw(tree, path)
        return {k: walk(v, path + (k,)) for k, v in tree.items()}

    return walk(T.abstract_params(cfg), ())


def _moe_mesh8(torch, dev, rank):
    """Phase 14 (c) in one of 8 ranks on a (2, 4) mesh: the qwen3-moe SMOKE
    layer, float32, the engines against dense_ref."""
    from repro_torch.configs import get_config
    from repro_torch.core.partition import DEFAULT_RULES, mesh_shape
    from repro_torch.launch.mesh import make_host_mesh, set_mesh
    from repro_torch.models import moe as M
    from repro_torch.models.layers import param_pspecs, shard_params

    mesh = make_host_mesh(model=4)
    cfg = get_config("qwen3-moe-235b-a22b", smoke=True)
    E, d, k, f = cfg.n_experts, cfg.d_model, cfg.top_k, cfg.d_ff_expert
    w = moe_layer_weights(torch, cfg, dev, range(E))
    x = torch.randn((4, 16, d), generator=torch.Generator(device=dev).manual_seed(3),
                    device=dev)
    out = {"digest": {}, "errs": {}, "drops": {}, "layer": f"d {d}, {E} experts top-{k}, f {f}"}
    with torch.no_grad():
        ref, _ = M.dense_ref(w, x, M.MoEConfig(d, E, k, f, impl="dense"))
        with set_mesh(mesh):
            specs = param_pspecs(M.moe_specs(M.MoEConfig(d, E, k, f)), DEFAULT_RULES,
                                 mesh.axis_names, mesh_shape(mesh))
            wl = shard_params(w, specs, mesh)
            for impl, topo in [("gather", "fattree")] + [("noc", t) for t in MOE_TOPOLOGIES]:
                tag = impl if impl == "gather" else f"noc-{topo}"
                o, _, st = M.moe_apply(wl, x, M.MoEConfig(d, E, k, f, capacity_factor=8.0,
                                                          impl=impl, noc_topology=topo))
                out["digest"][tag] = _digest(o)
                out["errs"][tag] = float((o - ref).abs().max())
                out["drops"][tag] = int(st.drops)
    return out


TP_X_SHAPE = (4, 32, 2048)                  # batch 4 x prompt 32 at llama3.2-1b's d_model
TP_SEED = 15


def tp_phase(torch, dev, smi, dense):
    """Phase 15: tensor and data parallelism of the LM over a ``("data",
    "model")`` mesh of 4 gloo ranks on the card, spawned as phase 12's ranks
    are (one world, a 400 s deadline):

    (a) llama3.2-1b FULL (the weights of phase 9, seed 0) on a (1, 4) mesh:
        each of the 16 decoder blocks in float32 on a seeded (4, 32, 2048)
        input against the same block on one rank in this process, within
        1e-4 x max |out|; served from bf16 on phase 9's traffic (16 requests
        at batch 4, prompt 32, 16 tokens), every rank's tokens equal; the
        SMOKE model's tokens on the mesh equal to one rank's here;
    (b) llama3.2-1b FULL trained 3 steps on a (2, 2) mesh at batch 8 x seq
        128 (phase 9's weights and batches, remat, flash on each rank's
        batch and head block): flash launched 3 x 16 x 2 times a rank, every
        flash call of step 1 within 1e-2 x max |out| of its plain version,
        step 1's loss within rtol 1e-2 of phase 9's one-rank step 1, and
        step 1's loss and grad norm with float32 compute on the weights with
        the attention rescaled (`conditioned`) within rtol 1e-2 of one
        rank's (a bf16 grad norm at full depth moves by tens of percent with
        the order of its sums: it is printed beside one rank's through the
        plain attention path);
    (c) qwen3-moe's layer at full width (phase 14's weights and input,
        capacity_factor 8) through the backward of sum(out · r) + aux on the
        (1, 4) mesh, ``gather`` and ``noc`` (fattree): the gradients of x,
        the router and each rank's 32 experts within 1e-5 x max(1, max |g|)
        of the one-rank engine's, which rank 0 computes with all 128 experts
        and hands each rank its block of."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import init_params

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    cfg = get_config("llama3.2-1b").replace(attn_impl="flash")
    masters = init_params(T.abstract_params(cfg), torch.Generator(device=dev).manual_seed(0))
    x = torch.randn(TP_X_SHAPE, generator=torch.Generator(device=dev).manual_seed(TP_SEED),
                    device=dev)
    with torch.no_grad():
        one_blocks = [run_block(torch, masters, cfg, layer, x, None).cpu().numpy()
                      for layer in range(cfg.n_layers)]
    del masters
    torch.cuda.empty_cache()
    small = get_config("llama3.2-1b", smoke=True)
    sp = init_params(T.abstract_params(small), torch.Generator().manual_seed(0), dev)
    one_small = serve.serve_batch(sp, small, tp_smoke_prompts(small), 8, device=dev)
    del sp
    # (b)'s one-rank step 1 in float32 compute, and in bf16 through the plain
    # attention path (how far the bf16 grad norm moves with its sums' order)
    from repro_torch.data.pipeline import DataConfig, _synthesize
    from repro_torch.launch import steps, train

    masters = init_params(T.abstract_params(cfg), torch.Generator(device=dev).manual_seed(0))
    batch0 = train.device_batch(_synthesize(DataConfig(vocab=cfg.vocab, seq_len=128,
                                                       global_batch=8, seed=0), 0), cfg, dev)
    one_f32 = step1_in_float32(torch, masters, batch0, cfg, None)
    loss_p, _, g = steps.loss_and_grads(masters, batch0, cfg.replace(attn_impl="naive"))
    one_plain = (float(loss_p), float(steps.global_norm(g)))
    del masters, batch0, g
    torch.cuda.empty_cache()

    ranks = run_ranks(torch, "tp4", 4)
    r0 = ranks[0]
    print(f"phase 15: llama3.2-1b FULL and qwen3-moe's layer on ('data', 'model') meshes of 4 "
          f"ranks, backend {r0['backend']} (FileStore), every rank on {r0['device']}; CUDA "
          f"tensors staged through the host at every transfer ({smi})")

    # (a) the blocks, the served tokens, SMOKE
    errs = []
    for layer, want in enumerate(one_blocks):
        got = r0["blocks"][layer]
        errs.append(float(np.abs(got - want).max() / np.abs(want).max()))
    check(max(errs) <= 1e-4 and all(r["block_digests"] == r0["block_digests"] for r in ranks),
          f"phase 15 (a): decoder blocks on the mesh against one rank: {errs}")
    a = [r["serve"] for r in ranks]
    check(all(np.array_equal(s["tokens"], a[0]["tokens"]) for s in a)
          and a[0]["tokens"].shape == (16, 16) and a[0]["flash"] == 0,
          f"phase 15 (a): the ranks' tokens differ, or {a[0]['tokens'].shape}, flash "
          f"{a[0]['flash']}")
    check(all(np.array_equal(r["smoke_tokens"], one_small) for r in ranks),
          "phase 15 (a): SMOKE tokens on the (1, 4) mesh differ from one rank's")
    same9 = int((a[0]["tokens"] == dense["serve_tokens"]).sum())
    print(f"  (a) the 16 decoder blocks (float32, x {TP_X_SHAPE}, the rank's 8 of 32 heads, 2 "
          f"of 8 kv heads, 2048 of 8192 MLP columns): max |diff| / max |out| against one rank "
          f"{max(errs):.3e} (limit 1e-4; per block {', '.join(f'{e:.1e}' for e in errs)})")
    s0 = a[0]
    peaks = ", ".join(f"{r['serve']['peak'] / 2**30:.2f}" for r in ranks)
    print(f"  (a) llama3.2-1b FULL served from bf16 on the (1, 4) mesh ({s0['params']:,} params a "
          f"rank): 16 requests x 16 tokens at batch 4 (prompt 32) in {s0['secs']:.3f} s "
          f"({256 / s0['secs']:.1f} tokens/s); prefill p50 {s0['prefill_ms']:.3f} ms, decode "
          f"p50 {s0['decode_ms']:.3f} ms/token; transport {s0['transport_s']:.3f} s in "
          f"{s0['calls']} transfers, of it staging {s0['staging_s']:.3f} s; staged "
          f"{s0['staged'] / 2**20:.1f} MiB a rank; peak memory {peaks} GiB (ranks 0-3); "
          f"flash 0 (a cached prefill); every rank's tokens equal; {same9} of 256 equal to "
          f"phase 9's one-rank tokens (bf16 sums in another order); SMOKE tokens equal to one "
          f"rank's ({smi})")

    # (b) the training steps
    b = [r["train"] for r in ranks]
    loss1, gn1 = dense["step1"]
    got_loss, got_gn = b[0]["losses"][0], b[0]["gnorms"][0]
    launches = sum(t["flash"] for t in b)
    check(all(t["flash"] == 3 * cfg.n_layers * 2 for t in b)
          and all(t["losses"] == b[0]["losses"] for t in b),
          f"phase 15 (b): flash launches {[t['flash'] for t in b]}, or the ranks' losses differ")
    worst = max(max(t["per_call"]) for t in b)
    check(worst <= 1e-2 and all(len(t["per_call"]) == 2 * cfg.n_layers for t in b),
          f"phase 15 (b): flash calls of step 1 against the plain version: {worst}")
    check(abs(got_loss - loss1) <= 1e-2 * abs(loss1) and np.isfinite(b[0]["losses"]).all()
          and np.isfinite(b[0]["gnorms"]).all(),
          f"phase 15 (b): step 1 loss {got_loss} against one rank's {loss1}")
    f32 = r0["f32_step1"]
    check(all(r["f32_step1"] == f32 for r in ranks)
          and abs(f32[0] - one_f32[0]) <= 1e-2 * abs(one_f32[0])
          and abs(f32[1] - one_f32[1]) <= 1e-2 * abs(one_f32[1]),
          f"phase 15 (b): step 1 in float32 compute, loss / grad norm {f32} on the mesh "
          f"against {one_f32} on one rank")
    med = [statistics.median(t["step_ms"][1:]) for t in b]
    share = [statistics.median(t["transport_ms"][1:]) / m for t, m in zip(b, med)]
    peaks = ", ".join(f"{t['peak'] / 2**30:.3f}" for t in b)
    print(f"  (b) llama3.2-1b FULL trained 3 steps on the (2, 2) mesh at batch 8 x seq 128 "
          f"(each rank 4 rows, 16 of 32 heads): losses {np.round(b[0]['losses'], 4).tolist()}, "
          f"grad_norm {np.round(b[0]['gnorms'], 3).tolist()}; step 1 against phase 9's one "
          f"rank: loss {got_loss:.5f} vs {loss1:.5f}, grad norm {got_gn:.4g} vs {gn1:.4g} "
          f"(rtol 1e-2); step {min(med):.1f}-{max(med):.1f} ms (median of steps 2-3 over "
          f"ranks; one rank's phase 9 step {dense['step_ms']:.1f} ms), transport "
          f"{min(share) * 100:.1f}-{max(share) * 100:.1f} % of it, staged "
          f"{', '.join(str(t['staged_per_step']) for t in b)} bytes a step (ranks 0-3; "
          f"{b[0]['staged_per_step'] / 2**30:.3f} GiB; the loss's logits stay the rank's vocab "
          f"block); peak memory {peaks} GiB; "
          f"one rank's bf16 step 1 through the plain attention path: loss {one_plain[0]:.5f}, "
          f"grad norm {one_plain[1]:.4g}; step 1 in float32 compute, attention rescaled: loss "
          f"{f32[0]:.6f} vs "
          f"{one_f32[0]:.6f}, grad norm {f32[1]:.6g} vs {one_f32[1]:.6g} (rel "
          f"{abs(f32[1] - one_f32[1]) / one_f32[1]:.2e}, limit 1e-2); flash {launches} launches "
          f"(3 steps x 16 layers x 2 under remat x 4 ranks) at {b[0]['flash_shape']}, every "
          f"call of step 1 within {worst:.3e} of the plain version (limit 1e-2) ({smi})")

    # (c) the MoE layer's gradients on the mesh
    for impl in ("gather", "noc"):
        errs_c = {k: max(r["moe_grad"][impl]["errs"][k] for r in ranks)
                  for k in r0["moe_grad"][impl]["errs"]}
        check(max(errs_c.values()) <= 1e-5
              and all(r["moe_grad"][impl]["drops"] == 0 for r in ranks),
              f"phase 15 (c) {impl}: gradients against the one-rank engine {errs_c}")
        walls = [r["moe_grad"][impl]["wall_ms"] for r in ranks]
        print(f"  (c) qwen3-moe layer (d 4096, 128 experts top-8, x (4, 32, 4096) f32) through "
              f"the backward on {impl}{' (fattree)' if impl == 'noc' else ''}: max |diff| / "
              f"max(1, max |g|) against the one-rank engine "
              f"{', '.join(f'{k} {v:.2e}' for k, v in errs_c.items())} (limit 1e-5), drop "
              f"free; forward + backward {min(walls):.1f}-{max(walls):.1f} ms over ranks (warm) "
              f"(one-rank engine {r0['moe_grad']['one_rank_ms']:.1f} ms) ({smi})")
    print(f"tp phase {time.perf_counter() - t_phase:.2f} s")
    return dict(serve_launches=0, train_launches=launches, train_combine_launches=sum(
        t["combines"] for t in b))


def conditioned(params, cfg):
    """``params`` with the attention projections rescaled to the fan-in of
    their whole input (wq, wk, wv by sqrt(H / d); wo by sqrt(1 / H); MLA's
    q_b and kv_b by sqrt(H / rank), its wo by sqrt(1 / H)): the reference's
    init takes the fan-in of a rank-3 weight as its middle dim (ROADMAP
    Queue 3), which puts llama3.2-1b FULL's attention scores near a std of
    128, where the softmax turns float32 rounding into percent-level changes
    of the grad norm.  The other leaves are shared, not copied."""
    blocks = dict(params["blocks"])
    for i, (mixer, _) in enumerate(cfg.pattern):
        blocks[str(i)] = conditioned_sublayer(blocks[str(i)], mixer, cfg)
    return dict(params, blocks=blocks)


def conditioned_sublayer(p, mixer, cfg):
    """Sub-layer ``p`` with its attention or MLA projections rescaled as
    `conditioned` rescales them (any other mixer: ``p`` itself).  The scales
    are per leaf, so a rank's block of a leaf scales as the whole does."""
    from repro_torch.models import transformer as T

    H = cfg.n_heads
    mla = T._mla_cfg(cfg)
    scales = {"attn": {"wq": (H / cfg.d_model) ** 0.5, "wk": (H / cfg.d_model) ** 0.5,
                       "wv": (H / cfg.d_model) ** 0.5, "wo": H ** -0.5},
              "mla": {"q_b": (H / mla.q_lora_rank) ** 0.5, "kv_b": (H / mla.kv_lora_rank) ** 0.5,
                      "wo": H ** -0.5}}.get(mixer)
    if scales is None:
        return p
    return dict(p, **{mixer: {k: v * scales.get(k, 1.0) for k, v in p[mixer].items()}})


def step1_in_float32(torch, params, batch, cfg, mesh):
    """(loss, grad norm) of one step's gradients with float32 compute (the
    masters' own dtype) on ``mesh`` (None: one device), no update, on the
    `conditioned` params: a bf16 gradient's norm at full depth moves by tens
    of percent with the order of its sums, and on the reference's init a
    float32 one by about one percent (PERF.md §6)."""
    from repro_torch._tree import leaves, unflatten
    from repro_torch.core import collectives as coll
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T

    c32 = cfg.replace(dtype="float32")
    with coll.use_mesh(mesh):
        loss, _, g = steps.loss_and_grads(conditioned(params, cfg), batch, c32)
        bax = T.batch_axis(mesh, batch["tokens"].shape[0])
        if bax is not None:
            g = unflatten(g, [coll.pmean(t, bax) for t in leaves(g)])
        specs = steps.shardings_for_params(cfg, mesh) if mesh is not None else None
        norm = steps.global_norm(g, specs, mesh)
    return float(loss), float(norm)


def tp_smoke_prompts(cfg):
    return np.random.default_rng(TP_SEED).integers(0, cfg.vocab, (4, 16)).astype(np.int64)


def _layer_of(tree, layer):
    return ({k: _layer_of(v, layer) for k, v in tree.items()} if isinstance(tree, dict)
            else tree[layer])


def run_block(torch, params, cfg, layer, x, mesh):
    """Decoder block ``layer`` of ``params`` (the rank's blocks on ``mesh``,
    or whole with None) on x, causal from position 0."""
    from repro_torch.models import transformer as T

    B, S, _ = x.shape
    lay = T.layout(cfg, B, mesh) if mesh is not None else T.Layout()
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    out, *_ = T._apply_sublayer(_layer_of(params["blocks"]["0"], layer), x, cfg, "attn", "mlp",
                                positions=positions, cache=None, enc_out=None, causal=True,
                                lay=lay)
    return out


def _tp_mesh4(torch, dev, rank):
    """Phase 15 (a), (b) and (c) in one of 4 ranks."""
    import torch.distributed as dist

    from repro_torch._tree import leaves
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, _synthesize
    from repro_torch.kernels import flash_attention, ops
    from repro_torch.launch import serve, train
    from repro_torch.launch.mesh import make_host_mesh, set_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import init_params
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.telemetry import MetricsRegistry

    m14, m22 = make_host_mesh(model=4), make_host_mesh(model=2)
    out = dict(device=str(dev), backend=str(dist.get_backend()))
    cfg = get_config("llama3.2-1b").replace(attn_impl="flash")

    # (a) phase 9's weights, seed 0: each leaf drawn whole, the rank's block kept
    gen = torch.Generator(device=dev).manual_seed(0)
    masters = init_params(T.abstract_params(cfg), gen, dev, mesh=m14)
    x = torch.randn(TP_X_SHAPE, generator=torch.Generator(device=dev).manual_seed(TP_SEED),
                    device=dev)
    with torch.no_grad(), set_mesh(m14):
        blocks = [run_block(torch, masters, cfg, layer, x, m14) for layer in range(cfg.n_layers)]
    out["block_digests"] = [_digest(t) for t in blocks]
    if rank == 0:
        out["blocks"] = [t.cpu().numpy() for t in blocks]
    params = T.cast_params(masters, cfg.cdtype)
    del masters, blocks
    prompts = torch.randint(0, cfg.vocab, (16, 32), generator=gen, device=dev).cpu().numpy()
    serve.serve_batch(params, cfg, prompts[:4], 2, device=dev, mesh=m14)      # warm-up
    reg = MetricsRegistry()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    m14.stats.reset()
    ops.reset_launch_counts()
    ts = time.perf_counter()
    tokens = np.concatenate([serve.serve_batch(params, cfg, prompts[i:i + 4], 16, device=dev,
                                               reg=reg, mesh=m14) for i in range(0, 16, 4)])
    torch.cuda.synchronize()
    secs = time.perf_counter() - ts
    pre, dec = reg.histogram("serve.prefill.seconds"), reg.histogram("serve.decode.seconds")
    out["serve"] = dict(tokens=tokens, secs=secs, prefill_ms=pre.p50 * 1e3,
                        decode_ms=dec.p50 * 1e3, transport_s=m14.stats.seconds,
                        staging_s=m14.stats.staging_seconds, calls=m14.stats.calls,
                        staged=m14.stats.staged_bytes, peak=torch.cuda.max_memory_allocated(),
                        flash=ops.launch_counts()["flash_attention"],
                        params=sum(t.numel() for t in leaves(params)))
    del params
    small = get_config("llama3.2-1b", smoke=True)
    sp = init_params(T.abstract_params(small), torch.Generator().manual_seed(0), dev, mesh=m14)
    out["smoke_tokens"] = serve.serve_batch(sp, small, tp_smoke_prompts(small), 8, device=dev,
                                            mesh=m14)
    del sp
    torch.cuda.empty_cache()

    # (b) phase 9's training: the same weights and batches, on the (2, 2) mesh
    masters = init_params(T.abstract_params(cfg), torch.Generator(device=dev).manual_seed(0),
                          dev, mesh=m22)
    state = {"params": masters, "opt": adamw_init(masters)}
    del masters
    step = make_train_step(cfg, AdamWConfig(lr=3e-4), mesh=m22, total_steps=6, warmup=5)
    data = DataConfig(vocab=cfg.vocab, seq_len=128, global_batch=8, seed=0)
    batches = [train.device_batch(_synthesize(data, s), cfg, dev) for s in range(3)]
    out["f32_step1"] = step1_in_float32(torch, state["params"], batches[0], cfg, m22)
    per_call, shapes, real = [], set(), ops.flash_attention

    def held(q, k, v, causal=True, use_kernel=False):
        o = real(q, k, v, causal, use_kernel)
        with torch.no_grad():
            plain = flash_attention.flash_attention_plain(q, k, v, causal).float()
            per_call.append(((o.float() - plain).abs().max() / plain.abs().max()).item())
        shapes.add((tuple(q.shape), tuple(k.shape)))
        return o

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    combines0 = flash_attention.flash_attention.combine_launches
    losses, gnorms, step_ms, transport_ms, staged = [], [], [], [], 0
    for i, bt in enumerate(batches):
        m22.stats.reset()
        ops.flash_attention = held if i == 0 else real
        try:
            (state, mets), secs = wall(torch, lambda: step(state, bt))
        finally:
            ops.flash_attention = real
        losses.append(float(mets["loss"]))
        gnorms.append(float(mets["grad_norm"]))
        step_ms.append(secs * 1e3)
        transport_ms.append(m22.stats.seconds * 1e3)
        staged = m22.stats.staged_bytes
    (q_shape, k_shape), = shapes
    out["train"] = dict(losses=losses, gnorms=gnorms, step_ms=step_ms, transport_ms=transport_ms,
                        staged_per_step=staged, per_call=per_call,
                        flash=ops.launch_counts()["flash_attention"],
                        combines=flash_attention.flash_attention.combine_launches - combines0,
                        peak=torch.cuda.max_memory_allocated(),
                        flash_shape=f"q {q_shape} k {k_shape}")
    del state, batches
    torch.cuda.empty_cache()

    # (c) the MoE layer's gradients: rank 0 computes the one-rank engine with
    # all 128 experts and sends each rank its block of the expert gradients
    qcfg = get_config("qwen3-moe-235b-a22b")
    E, d, k, f = qcfg.n_experts, qcfg.d_model, qcfg.top_k, qcfg.d_ff_expert
    coord, epr = m14.axis("model").coord, qcfg.n_experts // 4
    x = moe_input(torch, dev)
    r = torch.randn(x.shape, generator=torch.Generator(device=dev).manual_seed(MOE_SEED + 2),
                    device=dev)

    def grads_of(w, mesh, impl):
        """The gradients of the second of two runs (the first warms up), and
        that run's synced wall."""
        c = M.MoEConfig(d, E, k, f, capacity_factor=8.0, impl=impl, noc_topology="fattree")
        for _ in range(2):
            w = {key: t.detach().requires_grad_() for key, t in w.items()}
            xx = x.clone().requires_grad_()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with set_mesh(mesh):
                o, aux, st = M.moe_apply(w, xx, c)
            ((o * r).sum() + aux).backward()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        g = {key: t.grad for key, t in w.items()}
        return dict(g, x=xx.grad), int(st.drops), ms

    ref, moe = {}, {}
    if rank == 0:
        ref, _, moe["one_rank_ms"] = grads_of(moe_layer_weights(torch, qcfg, dev, range(E)),
                                              None, "gather")
    for key in ("x", "router"):
        t = ref[key].cpu() if rank == 0 else torch.empty(
            x.shape if key == "x" else (d, E), dtype=torch.float32)
        dist.broadcast(t, src=0)
        ref[key] = t.to(dev)
    for leaf in ("gate", "up", "down"):
        if rank == 0:
            for dst in (1, 2, 3):
                dist.send(ref[leaf][dst * epr:(dst + 1) * epr].cpu(), dst=dst)
            ref[leaf] = ref[leaf][:epr].clone()
        else:
            buf = torch.empty((epr,) + ((d, f) if leaf != "down" else (f, d)))
            dist.recv(buf, src=0)
            ref[leaf] = buf.to(dev)
    torch.cuda.empty_cache()
    for impl in ("gather", "noc"):
        w = moe_layer_weights(torch, qcfg, dev, range(coord * epr, (coord + 1) * epr))
        g, drops, ms = grads_of(w, m14, impl)
        errs = {key: float((g[key] - ref[key]).abs().max()
                           / max(1.0, float(ref[key].abs().max()))) for key in g}
        moe[impl] = dict(errs=errs, drops=drops, wall_ms=ms)
        del w, g
    out["moe_grad"] = moe
    return out


# -- phase 16: the mla, mamba, mlstm and slstm mixers on the model axis ------------

TP2B_SEED = 16
# arch -> its cut at full width for phase 16 (a): minicpm3-4b at 16 of 62
# layers, jamba-v0.1-52b at one period of 8, xlstm-350m uncut
TP2B_CUTS = {"minicpm3-4b": 16, "jamba-v0.1-52b": 8, "xlstm-350m": 24}
# phase 16 (b): arch -> layers trained on the (2, 2) mesh
TP2B_TRAIN = {"xlstm-350m": 24, "minicpm3-4b": 4}
TP2B_STEPS = 2


def tp2b_cfg(arch, n_layers):
    from repro_torch.configs import get_config

    return get_config(arch).replace(n_layers=n_layers, attn_impl="flash")


def tp2b_prompts(cfg):
    """One batch of 4 prompts of 32 tokens (phase 9's serving shape)."""
    return np.random.default_rng(TP2B_SEED).integers(0, cfg.vocab, (4, 32)).astype(np.int64)


def tp2b_block_params(torch, cfg, layer, mixer, ffn, dev, mesh):
    """Sub-layer ``layer`` of ``cfg`` in float32 (the norm(s), the mixer and
    the ffn), each leaf drawn whole by the reference's init rules from its
    own seed (the arch, the layer and the leaf's path), then cut to this
    rank's block on ``mesh`` (None: whole)."""
    import zlib

    from repro_torch.core.partition import block
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import init_param, is_spec, leaf_pspec

    def draw(sp, path):
        seed = zlib.crc32(f"{TP2B_SEED}/{cfg.name}/{layer}/{'/'.join(path)}".encode())
        t = init_param(torch.Generator(device=dev).manual_seed(seed), sp, dev)
        return t if mesh is None else block(t, leaf_pspec(sp, mesh), mesh).clone()

    def walk(tree, path):
        if is_spec(tree):
            return draw(tree, path)
        return {k: walk(v, path + (k,)) for k, v in tree.items()}

    return walk(T._sublayer_specs(cfg, mixer, ffn, False, torch.float32), ())


def tp2b_blocks(torch, cfg, dev, mesh):
    """Every sub-layer of ``cfg`` (float32 compute) on a seeded (4, 32, d)
    input, causal from position 0: this rank's output on ``mesh`` (None:
    one rank), each from `tp2b_block_params`.  The MoE sub-layers run at
    capacity_factor 8, drop free (checked): on a mesh the gather engine
    bounds each (source block, expert) FIFO, with one source block a model
    rank, where one rank has one block, so at the config's 1.25 the two
    drop different tokens by design (`models.moe.dispatch_capacity`)."""
    from repro_torch.models import transformer as T

    c32 = cfg.replace(dtype="float32", capacity_factor=8.0)
    x = torch.randn((4, 32, cfg.d_model), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(TP2B_SEED))
    lay = T.layout(c32, 4, mesh) if mesh is not None else T.Layout()
    pos = torch.arange(32, device=dev)[None].expand(4, 32)
    outs = []
    with torch.no_grad():
        for layer in range(cfg.n_layers):
            mixer, ffn = cfg.pattern[layer % len(cfg.pattern)]
            p = tp2b_block_params(torch, cfg, layer, mixer, ffn, dev, mesh)
            out, _, _, moe = T._apply_sublayer(p, x, c32, mixer, ffn, positions=pos,
                                               cache=None, enc_out=None, causal=True, lay=lay)
            check(moe is None or int(moe[0]) == 0,
                  f"{cfg.name} sub-layer {layer}: {moe and int(moe[0])} tokens dropped")
            outs.append(out)
            del p
    return outs


def tp2b_train_batches(cfg, dev):
    from repro_torch.data.pipeline import DataConfig, _synthesize
    from repro_torch.launch import train

    data = DataConfig(vocab=cfg.vocab, seq_len=128, global_batch=8, seed=0)
    return [train.device_batch(_synthesize(data, s), cfg, dev) for s in range(TP2B_STEPS)]


def tp2b_phase(torch, dev, smi):
    """Phase 16: the mla, mamba, mlstm and slstm mixers on the model axis,
    over ``("data", "model")`` meshes of 4 gloo ranks on the card, spawned as
    phase 12's ranks are (one world, a 400 s deadline):

    (a) on a (1, 4) mesh, minicpm3-4b FULL at 16 of 62 layers, jamba-v0.1-52b
        FULL at one period of 8 layers (7 Mamba and 1 attention; 4 MoE and
        4 MLP) and xlstm-350m FULL uncut: every sub-layer in float32 on a
        seeded (4, 32, d) input against the same sub-layer on one rank in
        this process, within 1e-4 x max |out|; served from bf16, one batch
        of 4 prompts of 32 tokens, 16 new tokens, each rank drawing only its
        blocks (`draw_mesh_serving_params`), every rank's tokens equal; the
        SMOKE model's tokens on the mesh equal to one rank's here;
    (b) on a (2, 2) mesh, xlstm-350m FULL and minicpm3-4b FULL at 4 layers
        trained 2 steps at batch 8 x seq 128 (bf16, remat): step 1's loss
        within rtol 1e-2 of one rank's here, and step 1's loss and grad norm
        with float32 compute (on `conditioned` weights) within rtol 1e-2 of
        one rank's;
    (c) jamba's Mamba sub-layer and its attention sub-layer (flash on the
        rank's 8 of 32 query heads and 2 of 8 kv heads) at full width on a
        (1, 4) mesh in float32, through the backward of sum(out · r), the
        attention's projections rescaled to the usual fan-in
        (`conditioned_sublayer`): the gradients of x and of each rank's
        leaves within 1e-5 (relative L2) of the one-rank sub-layer's blocks,
        every flash call held to its plain version at 3e-5 x max |out|."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve, steps
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import init_params

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    one_blocks, one_smoke = {}, {}
    for arch, n in TP2B_CUTS.items():
        cfg = tp2b_cfg(arch, n)
        one_blocks[arch] = [t.cpu().numpy() for t in tp2b_blocks(torch, cfg, dev, None)]
        torch.cuda.empty_cache()
        small = get_config(arch, smoke=True)
        sp = init_params(T.abstract_params(small), torch.Generator().manual_seed(0), dev)
        one_smoke[arch] = serve.serve_batch(sp, small, tp_smoke_prompts(small), 8, device=dev)
    one_train = {}
    for arch, n in TP2B_TRAIN.items():
        cfg = tp2b_cfg(arch, n)
        masters = init_params(T.abstract_params(cfg), torch.Generator(device=dev).manual_seed(0))
        batch0 = tp2b_train_batches(cfg, dev)[0]
        loss, _, g = steps.loss_and_grads(masters, batch0, cfg)
        one_train[arch] = dict(bf16=(float(loss), float(steps.global_norm(g))),
                               f32=step1_in_float32(torch, masters, batch0, cfg, None))
        del masters, g
        torch.cuda.empty_cache()
    t_one = time.perf_counter() - t_phase

    ranks = run_ranks(torch, "tp2b4", 4)
    r0 = ranks[0]
    fails = []           # every gate of the phase is read before it fails

    def gate(cond, what):
        if not cond:
            print(f"  FAILED: {what}")
            fails.append(what)

    print(f"phase 16: minicpm3-4b, jamba-v0.1-52b and xlstm-350m FULL on ('data', 'model') "
          f"meshes of 4 ranks, backend {r0['backend']} (FileStore), every rank on "
          f"{r0['device']}; the one-rank references here took {t_one:.2f} s ({smi})")

    # (a) the blocks, the served tokens, SMOKE
    for arch, n in TP2B_CUTS.items():
        errs = [float(np.abs(got - want).max() / np.abs(want).max())
                for got, want in zip(r0["blocks"][arch], one_blocks[arch])]
        gate(len(errs) == n and max(errs) <= 1e-4
              and all(r["block_digests"][arch] == r0["block_digests"][arch] for r in ranks),
              f"phase 16 (a) {arch}: sub-layers on the mesh against one rank: {errs}")
        a = [r["serve"][arch] for r in ranks]
        s0 = a[0]
        gate(all(np.array_equal(s["tokens"], s0["tokens"]) for s in a)
              and s0["tokens"].shape == (4, 16) and s0["flash"] == 0
              and 0 <= s0["tokens"].min() and s0["tokens"].max() < s0["vocab"],
              f"phase 16 (a) {arch}: the ranks' tokens differ, or {s0['tokens'].shape}, "
              f"flash {s0['flash']}")
        gate(all(np.array_equal(r["smoke_tokens"][arch], one_smoke[arch]) for r in ranks),
              f"phase 16 (a) {arch}: SMOKE tokens on the (1, 4) mesh differ from one rank's")
        peaks = ", ".join(f"{r['serve'][arch]['peak'] / 2**30:.2f}" for r in ranks)
        print(f"  (a) {arch} FULL at {n} layers on the (1, 4) mesh: the {n} sub-layers in "
              f"float32 (x (4, 32, {s0['d_model']})) within {max(errs):.3e} x max |out| of one "
              f"rank (limit 1e-4; per sub-layer {', '.join(f'{e:.1e}' for e in errs)}); served "
              f"from bf16 ({s0['params']:,} params a rank, {s0['layout']}): 4 requests x 16 "
              f"tokens at batch 4 (prompt 32) in {s0['secs']:.3f} s ({64 / s0['secs']:.1f} "
              f"tokens/s); prefill {s0['prefill_ms']:.3f} ms, decode "
              f"{s0['decode_ms'][2]:.3f} ms a token (mean of 15; "
              f"{s0['decode_ms'][0]:.3f}-{s0['decode_ms'][1]:.3f}); transport {s0['transport_s']:.3f} s in "
              f"{s0['calls']} transfers ({s0['transport_s'] / s0['secs'] * 100:.1f} % of the "
              f"wall), of it staging {s0['staging_s']:.3f} s; staged "
              f"{s0['staged'] / 2**20:.1f} MiB a rank; peak memory {peaks} GiB (ranks 0-3); "
              f"flash 0 (a cached prefill); every rank's tokens equal; SMOKE tokens equal to "
              f"one rank's ({smi})")

    # (b) the training steps
    for arch, n in TP2B_TRAIN.items():
        b = [r["train"][arch] for r in ranks]
        one = one_train[arch]
        got_loss, got_gn = b[0]["losses"][0], b[0]["gnorms"][0]
        f32 = b[0]["f32_step1"]
        gate(all(t["losses"] == b[0]["losses"] and t["f32_step1"] == f32 for t in b)
              and np.isfinite(b[0]["losses"]).all() and np.isfinite(b[0]["gnorms"]).all(),
              f"phase 16 (b) {arch}: the ranks' losses differ or are not finite")
        gate(abs(got_loss - one["bf16"][0]) <= 1e-2 * abs(one["bf16"][0]),
              f"phase 16 (b) {arch}: step 1 loss {got_loss} against one rank's {one['bf16'][0]}")
        gate(abs(f32[0] - one["f32"][0]) <= 1e-2 * abs(one["f32"][0])
              and abs(f32[1] - one["f32"][1]) <= 1e-2 * abs(one["f32"][1]),
              f"phase 16 (b) {arch}: step 1 in float32 compute, loss / grad norm {f32} on the "
              f"mesh against {one['f32']} on one rank")
        med = [statistics.median(t["step_ms"][1:]) for t in b]
        share = [statistics.median(t["transport_ms"][1:]) / m for t, m in zip(b, med)]
        peaks = ", ".join(f"{t['peak'] / 2**30:.2f}" for t in b)
        print(f"  (b) {arch} FULL at {n} layers trained {TP2B_STEPS} steps on the (2, 2) mesh at "
              f"batch 8 x seq 128: losses {np.round(b[0]['losses'], 4).tolist()}, grad_norm "
              f"{np.round(b[0]['gnorms'], 4).tolist()}; step 1 against one rank: loss "
              f"{got_loss:.5f} vs {one['bf16'][0]:.5f} (rtol 1e-2), bf16 grad norm {got_gn:.5g} "
              f"vs {one['bf16'][1]:.5g}; in float32 compute loss {f32[0]:.6f} vs "
              f"{one['f32'][0]:.6f}, grad norm {f32[1]:.6g} vs {one['f32'][1]:.6g} (rel "
              f"{abs(f32[1] - one['f32'][1]) / one['f32'][1]:.2e}, limit 1e-2); step 2 "
              f"{min(med):.1f}-{max(med):.1f} ms over ranks, transport "
              f"{min(share) * 100:.1f}-{max(share) * 100:.1f} % of it, staged "
              f"{b[0]['staged_per_step'] / 2**30:.2f} GiB a step a rank; peak memory {peaks} GiB; "
              f"flash {sum(t['flash'] for t in b)} ({smi})")

    # (c) jamba's Mamba and attention sub-layers through the backward
    flash_launches = combines = 0
    for sub in ("mamba", "attn"):
        errs = {k: max(r["grads"][sub]["errs"][k] for r in ranks)
                for k in r0["grads"][sub]["errs"]}
        worst_call = max(max(r["grads"][sub]["per_call"], default=0.0) for r in ranks)
        gate(max(errs.values()) <= 1e-5 and worst_call <= 3e-5,
              f"phase 16 (c) {sub}: gradients against one rank {errs}, flash calls against "
              f"the plain version {worst_call}")
        n_flash = [r["grads"][sub]["flash"] for r in ranks]
        gate(n_flash == ([1] * 4 if sub == "attn" else [0] * 4),
              f"phase 16 (c) {sub}: flash launches {n_flash} (one a rank for attention)")
        flash_launches += sum(n_flash)
        combines += sum(r["grads"][sub]["combines"] for r in ranks)
        walls = [r["grads"][sub]["wall_ms"] for r in ranks]
        print(f"  (c) jamba's {sub} sub-layer at full width (d 4096, "
              f"{'d_inner 8192, N 16' if sub == 'mamba' else '32:8 heads of 128, flash, '}"
              f"{'' if sub == 'mamba' else 'projections at the usual fan-in'}), "
              f"x (4, 32, 4096) float32, on the (1, 4) mesh through the backward: relative L2 "
              f"against one rank {', '.join(f'{k} {v:.2e}' for k, v in errs.items())} (limit "
              f"1e-5); forward + backward {min(walls):.1f}-{max(walls):.1f} ms over ranks (one "
              f"rank {r0['grads'][sub]['one_rank_ms']:.1f} ms)"
              + (f"; flash {sum(n_flash)} launches at {r0['grads'][sub]['flash_shape']}, every "
                 f"call within {worst_call:.2e} x max |out| of the plain version (limit 3e-5, "
                 f"phase 2's f32 gate)"
                 if sub == "attn" else "") + f" ({smi})")
    print(f"tp2b phase {time.perf_counter() - t_phase:.2f} s")
    check(not fails, f"phase 16: {len(fails)} gates failed: {'; '.join(fails)}")
    return dict(launches=flash_launches, combine_launches=combines)


def _tp2b_mesh4(torch, dev, rank):
    """Phase 16 (a), (b) and (c) in one of 4 ranks."""
    import torch.distributed as dist

    from repro_torch._tree import flatten, leaves, unflatten
    from repro_torch.configs import get_config
    from repro_torch.core.partition import block
    from repro_torch.kernels import flash_attention, ops
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_host_mesh, set_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import init_params, leaf_pspec
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.telemetry import MetricsRegistry

    m14, m22 = make_host_mesh(model=4), make_host_mesh(model=2)
    out = dict(device=str(dev), backend=str(dist.get_backend()), blocks={}, block_digests={},
               serve={}, smoke_tokens={}, train={}, grads={})

    # (a) the sub-layers in float32, then serving from bf16, then SMOKE
    for arch, n in TP2B_CUTS.items():
        cfg = tp2b_cfg(arch, n)
        with set_mesh(m14):
            blocks = tp2b_blocks(torch, cfg, dev, m14)
        out["block_digests"][arch] = [_digest(t) for t in blocks]
        if rank == 0:
            out["blocks"][arch] = [t.cpu().numpy() for t in blocks]
        del blocks
        torch.cuda.empty_cache()
        params = draw_mesh_serving_params(torch, cfg, dev, m14, seed=TP2B_SEED)
        prompts = tp2b_prompts(cfg)
        serve.serve_batch(params, cfg, prompts, 2, device=dev, mesh=m14)      # warm-up
        reg = MetricsRegistry()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        m14.stats.reset()
        ops.reset_launch_counts()
        ts = time.perf_counter()
        tokens = serve.serve_batch(params, cfg, prompts, 16, device=dev, reg=reg, mesh=m14)
        torch.cuda.synchronize()
        secs = time.perf_counter() - ts
        lay = T.layout(cfg, 4, m14)
        split = {k: v.size for k, v in vars(lay).items()
                 if k not in ("mesh", "batch") and v is not None}
        out["serve"][arch] = dict(
            tokens=tokens, secs=secs, vocab=cfg.vocab, d_model=cfg.d_model,
            prefill_ms=reg.histogram("serve.prefill.seconds").total * 1e3,
            decode_ms=[1e3 * getattr(reg.histogram("serve.decode.seconds"), k)
                       for k in ("vmin", "vmax")] + [
                1e3 * reg.histogram("serve.decode.seconds").total
                / reg.histogram("serve.decode.seconds").count],
            transport_s=m14.stats.seconds, staging_s=m14.stats.staging_seconds,
            calls=m14.stats.calls, staged=m14.stats.staged_bytes,
            peak=torch.cuda.max_memory_allocated(), flash=ops.launch_counts()["flash_attention"],
            params=sum(t.numel() for t in leaves(params)),
            layout="model axis of 4 over " + ", ".join(sorted(split)))
        del params
        torch.cuda.empty_cache()
        small = get_config(arch, smoke=True)
        sp = init_params(T.abstract_params(small), torch.Generator().manual_seed(0), dev, mesh=m14)
        out["smoke_tokens"][arch] = serve.serve_batch(sp, small, tp_smoke_prompts(small), 8,
                                                      device=dev, mesh=m14)
        del sp

    # (b) training on the (2, 2) mesh
    for arch, n in TP2B_TRAIN.items():
        cfg = tp2b_cfg(arch, n)
        masters = init_params(T.abstract_params(cfg), torch.Generator(device=dev).manual_seed(0),
                              dev, mesh=m22)
        state = {"params": masters, "opt": adamw_init(masters)}
        del masters
        step = make_train_step(cfg, AdamWConfig(lr=3e-4), mesh=m22, total_steps=6, warmup=5)
        batches = tp2b_train_batches(cfg, dev)
        f32_step1 = step1_in_float32(torch, state["params"], batches[0], cfg, m22)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        losses, gnorms, step_ms, transport_ms, staged = [], [], [], [], 0
        for bt in batches:
            m22.stats.reset()
            (state, mets), secs = wall(torch, lambda: step(state, bt))
            losses.append(float(mets["loss"]))
            gnorms.append(float(mets["grad_norm"]))
            step_ms.append(secs * 1e3)
            transport_ms.append(m22.stats.seconds * 1e3)
            staged = m22.stats.staged_bytes
        out["train"][arch] = dict(losses=losses, gnorms=gnorms, step_ms=step_ms,
                                  transport_ms=transport_ms, staged_per_step=staged,
                                  f32_step1=f32_step1, peak=torch.cuda.max_memory_allocated(),
                                  flash=ops.launch_counts()["flash_attention"])
        del state, batches
        torch.cuda.empty_cache()

    # (c) jamba's Mamba and attention sub-layers at full width, float32,
    # through the backward: each rank computes the one-rank sub-layer too
    cfg = tp2b_cfg("jamba-v0.1-52b", 8).replace(dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(TP2B_SEED + 1)
    x = torch.randn((4, 32, cfg.d_model), generator=gen, device=dev)
    r = torch.randn(x.shape, generator=gen, device=dev)
    pos = torch.arange(32, device=dev)[None].expand(4, 32)
    real = ops.flash_attention

    def fwd_bwd(p, lay):
        """(the gradients of x and of every leaf by path, the synced wall of
        the forward and backward)."""
        req = [t.detach().requires_grad_() for t in leaves(p)]
        tree = unflatten(p, req)
        xx = x.clone().requires_grad_()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        o, *_ = T._apply_sublayer(tree, xx, cfg, mixer, "none", positions=pos, cache=None,
                                  enc_out=None, causal=True, lay=lay)
        (o * r).sum().backward()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        return dict({"/".join(k): t.grad for (k, _), t in zip(flatten(p), req)}, x=xx.grad), ms

    for mixer in ("mamba", "attn"):
        layer = cfg.pattern.index((mixer, "mlp"))
        # the attention projections at the usual fan-in (`conditioned`): at
        # the reference's init the scores' std is in the hundreds, and the
        # softmax's backward turns the ranks' float32 roundings of q and k
        # into 1.6e-4 of the gradients
        whole = conditioned_sublayer(
            tp2b_block_params(torch, cfg, layer, mixer, "none", dev, None), mixer, cfg)
        fwd_bwd(whole, T.Layout())                                # warm-up
        ref, one_ms = fwd_bwd(whole, T.Layout())
        specs = {"/".join(k): leaf_pspec(sp, m14) for k, sp in
                 flatten(T._sublayer_specs(cfg, mixer, "none", False, torch.float32))}
        local = conditioned_sublayer(
            tp2b_block_params(torch, cfg, layer, mixer, "none", dev, m14), mixer, cfg)
        per_call, shapes = [], set()

        def held(q, k, v, causal=True, use_kernel=False):
            o = real(q, k, v, causal, use_kernel)
            with torch.no_grad():
                plain = flash_attention.flash_attention_plain(q, k, v, causal).float()
                per_call.append(((o.float() - plain).abs().max() / plain.abs().max()).item())
            shapes.add((tuple(q.shape), tuple(k.shape)))
            return o

        with set_mesh(m14):
            fwd_bwd(local, T.layout(cfg, 4, m14))                  # warm-up
            per_call.clear()
            ops.reset_launch_counts()
            combines0 = flash_attention.flash_attention.combine_launches
            ops.flash_attention = held
            try:
                g, ms = fwd_bwd(local, T.layout(cfg, 4, m14))
            finally:
                ops.flash_attention = real
            n_flash = ops.launch_counts()["flash_attention"]
            n_comb = flash_attention.flash_attention.combine_launches - combines0
        # a leaf's error over at least 1e-3 of the whole gradient's norm (the
        # CPU tests' GRAD_FLOOR): Mamba's dt_w and dt_b gradients sit
        # behind softplus(-4.6) and are tiny
        floor = 1e-3 * float(torch.sqrt(sum(t.square().sum() for k, t in ref.items()
                                            if k != "x")))
        errs = {}
        for key, t in g.items():
            want = ref[key] if key == "x" else block(ref[key], specs[key], m14)
            errs[key] = float((t - want).norm()) / max(float(want.norm()), floor)
        out["grads"][mixer] = dict(errs=errs, wall_ms=ms, one_rank_ms=one_ms, flash=n_flash,
                                   combines=n_comb, per_call=per_call,
                                   flash_shape=", ".join(f"q {q} k {k}" for q, k in shapes))
        del whole, local, ref, g
        torch.cuda.empty_cache()
    return out


# -- phase 17: the cross-pod gradient exchange and elastic rescale -----------------

POD_VARIANTS = ("auto", "none", "bf16", "int8")
# against auto: the grad norm, relative, and AdamW's m and v, max |diff| over
# each leaf's max |.| (tests/test_torch_pod_sync.py's GNORM_TOL and AUTO_TOL)
POD_GNORM_TOL = {"none": 1e-4, "bf16": 1e-3, "int8": 1e-3}
POD_TOL = {"none": 1e-5, "bf16": 1e-2, "int8": 2e-2}
# (2, 2, 1) none against the step of one process: float32 sums in another
# order (the CPU tests' bound of the port against the reference)
ONE_TOL = {"loss": 1e-5, "gnorm": 1e-4, "state": 1e-4}
FLASH_F32_TOL = 3e-5                           # x max |out|, phase 2's float32 limit
ELASTIC_LAYERS = 4                             # llama3.2-1b at full width, 4 of 16 layers
ELASTIC_STEPS = 2


def pod_phase(torch, dev, smi):
    """Phase 17: the cross-pod gradient exchange and elastic rescale, ranks
    spawned as phase 12's are (one world of 4, then one of 2):

    (a) llama3.2-1b FULL (16 layers, d 2048; phase 9's weights, seed 0, with
        the attention rescaled by `conditioned`) on a ("pod", "data",
        "model") mesh of (2, 1, 2), batch 8 x seq 128, float32 masters and
        float32 compute: from one state, one step under ``auto`` and under
        ``serdes`` with ``compress`` none, bf16 and int8
        (`core.serdes.QuasiSerdesConfig`'s defaults otherwise): the loss
        within 1e-3 of auto's (it is taken before the exchange), the grad
        norm (taken after it) within :data:`POD_GNORM_TOL` of auto's and
        AdamW's m and v (every rank's block, so the whole tensors) within
        :data:`POD_TOL` of each leaf's max |.|; on a (2, 2, 1) mesh at 4 of
        16 layers (whole replicas, where the within-pod data mean runs too)
        the none step held to rank 0's step alone on the whole batch at
        :data:`ONE_TOL`.  Every flash call of the auto step, of both
        (2, 2, 1) steps, of (b)'s resumed step and of the one-rank step here
        is held to the plain version on its own inputs at phase 2's float32
        limit.  Each variant's step wall, transport share, staged bytes,
        cross-pod wire bytes (`serdes.link_bytes_on_wire` over the rank's
        leaves), ppermutes, peak memory and flash launches a rank are
        printed;
    (b) llama3.2-1b at full width cut to 4 of 16 layers: 2 bf16 steps on a
        (2, 2) ("data", "model") mesh of 4 ranks, saved through
        `CheckpointManager` (the gathered tree, float32 params, m and v); a
        world of 2 ranks restores it on ``factor_mesh(2, prefer_model=2)``
        through ``restore(shardings=remesh_plan(...))`` (its blocks, gathered,
        equal to the saved arrays bit for bit) and takes one step in float32
        compute, whose loss and grad norm are held to one rank's step here
        from the same files at rtol 1e-5 and 1e-4."""
    from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, _synthesize
    from repro_torch.kernels import flash_attention, ops
    from repro_torch.launch import train
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import AdamWConfig

    import gc

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    print(f"phase 17 starts with {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated and "
          f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved by this process, "
          f"{free / 2**30:.2f} of {total / 2**30:.2f} GiB free on the card")
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_elastic_")
    try:
        ranks = run_ranks(torch, "pod4", 4, args=(ckpt,))
        restored = run_ranks(torch, "elastic2", 2, args=(ckpt,))
        cfg = get_config("llama3.2-1b").replace(attn_impl="flash", n_layers=ELASTIC_LAYERS)
        proto = elastic_proto(torch, cfg, dev)
        state, step_no, _ = CheckpointManager(CheckpointConfig(ckpt)).restore(proto)
        batch = train.device_batch(_synthesize(DataConfig(vocab=cfg.vocab, seq_len=128,
                                                          global_batch=8, seed=0),
                                               ELASTIC_STEPS), cfg, dev)
        step = make_train_step(cfg.replace(dtype="float32"), AdamWConfig(lr=3e-4),
                               total_steps=6, warmup=1)
        warm_s = warm_up(torch, dev, cfg.replace(dtype="float32"), batch)
        ops.reset_launch_counts()
        combines0 = flash_attention.flash_attention.combine_launches
        with holding_flash(torch) as one_rec:
            (_, mets), one_secs = wall(torch, lambda: step(state, batch))
        one = (float(mets["loss"]), float(mets["grad_norm"]))
        one_flash = ops.launch_counts()["flash_attention"]
        one_comb = flash_attention.flash_attention.combine_launches - combines0
        ckpt_bytes = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(ckpt)
                         for f in fs)
        del state, proto, batch
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    r0 = ranks[0]
    print(f"phase 17: the cross-pod gradient exchange and elastic rescale, worlds of 4 and 2 "
          f"ranks over gloo (FileStore), every rank on {r0['device']}; CUDA tensors staged "
          f"through the host at every transfer ({smi})")

    # (a) the exchange
    print(f"  (a) first step of one layer of llama3.2-1b FULL on (2, 1, 2) (serdes int8, float32) "
          f"{min(r['warm_s'] for r in ranks):.2f}-{max(r['warm_s'] for r in ranks):.2f} s a rank; "
          f"the timed steps come after it")
    launches, combines = 0, 0
    for name, layers, shape in (("full", 16, (2, 1, 2)), ("cut", ELASTIC_LAYERS, (2, 2, 1))):
        runs = [r["pod"][name] for r in ranks]
        ref = "auto" if name == "full" else "one"
        for v in runs[0]:
            got = [r[v] for r in runs if v in r]       # "one": rank 0 alone
            want = runs[0][ref]
            # the loss is taken before the exchange; a lossy link rounds
            # the other pod's gradients, so the pods' grad norms may differ
            check(len({g["loss"] for g in got}) == 1
                  and all(np.isfinite([g["loss"], g["gnorm"]]).all() for g in got),
                  f"phase 17 (a) {name} {v}: the ranks' losses / grad norms "
                  f"{[(g['loss'], g['gnorm']) for g in got]}, or not finite")
            check(all(g["flash"] == 2 * layers == g["flash_calls"] for g in got),
                  f"phase 17 (a) {name} {v}: flash launches {[g['flash'] for g in got]}, calls "
                  f"{[g['flash_calls'] for g in got]}")
            loss_err = abs(got[0]["loss"] - want["loss"]) / abs(want["loss"])
            gn_err = max(abs(g["gnorm"] - want["gnorm"]) for g in got) / want["gnorm"]
            cmp = [g for g in got if "m_err" in g]      # the ranks that hold ref's m and v
            err = max(max(g["m_err"], g["v_err"]) for g in cmp) if v != ref else 0.0
            if v == ref:
                held_txt = ""
            else:
                lim = (dict(loss=ONE_TOL["loss"], gnorm=ONE_TOL["gnorm"], state=ONE_TOL["state"])
                       if ref == "one" else dict(loss=1e-3 / abs(want["loss"]),
                                                 gnorm=POD_GNORM_TOL[v], state=POD_TOL[v]))
                check(loss_err <= lim["loss"] and gn_err <= lim["gnorm"] and err <= lim["state"],
                      f"phase 17 (a) {name} {v}: loss {loss_err:.3e}, grad norm {gn_err:.3e} "
                      f"from {ref}'s (relative), m and v {err:.3e} of each leaf's max (limits "
                      f"{lim})")
                g0 = got[0]
                held_txt = (f"; against {ref}'s: grad norm {gn_err:.2e} (limit {lim['gnorm']:g}), "
                            f"m {max(g['m_err'] for g in cmp):.3e} and v "
                            f"{max(g['v_err'] for g in cmp):.3e} of each leaf's max |.| (limit "
                            f"{lim['state']:g}; max |diff| {g0['m_abs']:.3e} / {g0['v_abs']:.3e}"
                            f", max |m| {g0['m_max']:.4e}, max |v| {g0['v_max']:.4e})")
            calls = [e for g in got for e in g["per_call"]]
            if calls:
                check(len(calls) == sum(g["flash"] for g in got) and max(calls) <= FLASH_F32_TOL,
                      f"phase 17 (a) {name} {v}: {len(calls)} flash calls held, worst "
                      f"{max(calls):.3e} x max |out| (limit {FLASH_F32_TOL})")
                held_txt += (f"; every flash call ({len(calls)}) within {max(calls):.2e} x max "
                             f"|out| of the plain version (limit {FLASH_F32_TOL:g})")
            launches += sum(g["flash"] for g in got)
            combines += sum(g["combines"] for g in got)
            walls = [g["step_ms"] for g in got]
            share = [g["transport_ms"] / g["step_ms"] for g in got]
            peaks = ", ".join(f"{g['peak'] / 2**30:.2f}" for g in got)
            s0 = got[0]
            where = "one process, whole batch" if v == "one" else f"{shape}"
            print(f"  (a) llama3.2-1b FULL at {layers} of 16 layers on {where}, batch 8 x seq "
                  f"128, float32, {v}: loss {s0['loss']:.6f} ({loss_err:.1e} from {ref}'s), "
                  f"grad norm {s0['gnorm']:.7g}{held_txt}; step "
                  f"{min(walls):.1f}-{max(walls):.1f} ms a rank, transport "
                  f"{min(share) * 100:.1f}-{max(share) * 100:.1f} %, staged "
                  f"{s0['staged'] / 2**30:.3f} GiB a rank, cross-pod wire "
                  f"{s0['wire'] / 2**30:.3f} GiB a rank, {s0['ppermutes']} ppermutes a rank, "
                  f"{s0['calls']} transfers, peak {peaks} GiB, flash {s0['flash']} a rank "
                  f"at {s0['flash_shape']} ({smi})")

    # (b) elastic rescale
    save = [r["elastic"] for r in ranks]
    check(all(s["losses"] == save[0]["losses"] for s in save)
          and np.isfinite(save[0]["losses"]).all(),
          f"phase 17 (b): the saving ranks' losses {[s['losses'] for s in save]}")
    res = restored[0]
    check(res["step"] == ELASTIC_STEPS == step_no and res["mesh"] == ((1, 2), ("data", "model"))
          and res["equal"] == res["leaves"] > 0,
          f"phase 17 (b): restored step {res['step']}, mesh {res['mesh']}, {res['equal']} of "
          f"{res['leaves']} leaves equal to the saved arrays")
    check(all(r["mets"] == res["mets"] for r in restored), "phase 17 (b): the ranks' steps differ")
    calls = [e for r in restored for e in r["per_call"]] + one_rec["errs"]
    check(len(calls) == sum(r["flash"] for r in restored) + one_flash
          and max(calls) <= FLASH_F32_TOL,
          f"phase 17 (b): {len(calls)} flash calls of the resumed and the one-rank step held, "
          f"worst {max(calls, default=0.0):.3e} x max |out| (limit {FLASH_F32_TOL})")
    got = res["mets"]
    check(abs(got[0] - one[0]) <= 1e-5 * abs(one[0]) and abs(got[1] - one[1]) <= 1e-4 * one[1],
          f"phase 17 (b): the resumed step's loss / grad norm {got} against one rank's {one}")
    launches += sum(s["flash"] for s in save) + sum(r["flash"] for r in restored)
    combines += sum(s["combines"] for s in save) + sum(r["combines"] for r in restored)
    print(f"  (b) llama3.2-1b at full width, {ELASTIC_LAYERS} of 16 layers: {ELASTIC_STEPS} "
          f"bf16 steps on (2, 2) (losses {np.round(save[0]['losses'], 4).tolist()}), saved in "
          f"{max(s['save_s'] for s in save):.2f} s ({ckpt_bytes / 2**30:.3f} GiB of "
          f"checkpoint); restored on factor_mesh(2, prefer_model=2) = {res['mesh'][0]} in "
          f"{max(r['restore_s'] for r in restored):.2f} s, all {res['leaves']} leaves' blocks "
          f"gathered equal to the saved arrays bit for bit; the resumed float32 step "
          f"{max(r['step_ms'] for r in restored):.1f} ms a rank (transport "
          f"{max(r['transport_ms'] for r in restored):.1f} ms, staged "
          f"{res['staged'] / 2**30:.3f} GiB a rank; after a first step of one layer in "
          f"{max(r['warm_s'] for r in restored):.2f} s): loss {got[0]:.7f} vs one "
          f"rank's {one[0]:.7f} (rtol 1e-5), grad norm {got[1]:.7g} vs {one[1]:.7g} (rtol "
          f"1e-4); one rank's step {one_secs * 1e3:.1f} ms after a first step of one layer "
          f"in {warm_s:.2f} s, flash {one_flash}; every flash call of both steps ({len(calls)}: "
          f"{res['flash_shape']} on the mesh, {sorted(one_rec['shapes'])} alone) within "
          f"{max(calls):.2e} x max |out| of the plain version (limit {FLASH_F32_TOL:g}); peak "
          f"{max(r['peak'] for r in restored) / 2**30:.2f} GiB a restoring rank ({smi})")
    print(f"pod phase {time.perf_counter() - t_phase:.2f} s")
    return dict(launches=launches + one_flash, combine_launches=combines + one_comb)


def elastic_proto(torch, cfg, dev):
    """A tree of the train state's structure whose leaves are empty tensors
    on ``dev``: what ``restore`` reads of its target."""
    from repro_torch._tree import tree_map
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import param_shapes

    params = tree_map(lambda _: torch.empty(0, device=dev),
                      param_shapes(T.abstract_params(cfg)))
    return {"params": params, "opt": {"m": params, "v": params,
                                      "step": torch.empty(0, device=dev)}}


def warm_up(torch, dev, cfg, batch, mesh=None, **kw):
    """One step of ``cfg`` cut to one layer on ``batch`` and ``mesh`` (None:
    this process alone), and its synced seconds: a process's first float32
    step at full width takes seconds more than the next (PERF.md §6),
    so the timed steps come after one of the same shapes; ``kw`` goes to
    ``make_train_step``."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import init_params
    from repro_torch.optim import AdamWConfig, adamw_init

    cfg = cfg.replace(n_layers=1)
    params = init_params(T.abstract_params(cfg), torch.Generator(device=dev).manual_seed(1), dev,
                         mesh=mesh)
    step = make_train_step(cfg, AdamWConfig(), mesh=mesh, **kw)
    return wall(torch, lambda: step({"params": params, "opt": adamw_init(params)}, batch))[1]


@contextlib.contextmanager
def holding_flash(torch, hold=True):
    """Every flash call in the block, through ``ops.flash_attention``:
    counted, its shapes kept and, with ``hold``, its output held to the plain
    version on its own inputs (max |diff| / max |out|, read after the block,
    so the step is not synced call by call).  Yields {"calls", "shapes",
    "errs"}."""
    from repro_torch.kernels import flash_attention, ops

    real, rec = ops.flash_attention, {"calls": 0, "shapes": set(), "errs": []}

    def held(q, k, v, causal=True, use_kernel=False):
        o = real(q, k, v, causal, use_kernel)
        rec["calls"] += 1
        rec["shapes"].add((tuple(q.shape), tuple(k.shape)))
        if hold:
            with torch.no_grad():
                plain = flash_attention.flash_attention_plain(q, k, v, causal).float()
                rec["errs"].append((o.float() - plain).abs().max() / plain.abs().max())
        return o

    ops.flash_attention = held
    try:
        yield rec
    finally:
        ops.flash_attention = real
    rec["errs"] = [float(e) for e in rec["errs"]]


def _pod_step(torch, mesh, cfg, params, batch, pod_sync, serdes, auto=None, keep=False,
              hold=False):
    """One step of ``cfg`` on ``mesh`` (None: this process alone) from
    ``params`` (updated in place) and a fresh AdamW state, with what it cost
    this rank and its flash calls (held to the plain version with ``hold``).
    ``keep``: also return m and v on the host; else against ``auto`` (such
    a kept pair) the largest |diff| of m and of v, alone and over each
    leaf's max |.|, and the largest |.| of auto's."""
    from repro_torch._tree import leaves
    from repro_torch.core import serdes as qserdes
    from repro_torch.kernels import flash_attention, ops
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import AdamWConfig, adamw_init

    state = {"params": params, "opt": adamw_init(params)}
    step = make_train_step(cfg, AdamWConfig(lr=3e-4), mesh=mesh, pod_sync=pod_sync,
                           serdes=serdes, total_steps=6, warmup=1)
    real_pp, n_pp = qserdes.ppermute, [0]

    def counted(*a, **k):
        n_pp[0] += 1
        return real_pp(*a, **k)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    if mesh is not None:
        mesh.stats.reset()
    ops.reset_launch_counts()
    combines0 = flash_attention.flash_attention.combine_launches
    qserdes.ppermute = counted
    try:
        with holding_flash(torch, hold) as rec:
            (state, mets), secs = wall(torch, lambda: step(state, batch))
    finally:
        qserdes.ppermute = real_pp
    st = mesh.stats if mesh is not None else None
    out = dict(loss=float(mets["loss"]), gnorm=float(mets["grad_norm"]), step_ms=secs * 1e3,
               transport_ms=st.seconds * 1e3 if st else 0.0, staged=st.staged_bytes if st else 0,
               calls=st.calls if st else 0, ppermutes=n_pp[0],
               peak=torch.cuda.max_memory_allocated(),
               flash=ops.launch_counts()["flash_attention"],
               combines=flash_attention.flash_attention.combine_launches - combines0,
               flash_calls=rec["calls"], per_call=rec["errs"],
               flash_shape=", ".join(f"q {q} k {k}" for q, k in sorted(rec["shapes"])),
               wire=(sum(qserdes.link_bytes_on_wire(t.shape, t.dtype, serdes)
                         for t in leaves(state["params"])) if serdes else 0))
    m, v = leaves(state["opt"]["m"]), leaves(state["opt"]["v"])
    if keep:
        return out, ([t.cpu() for t in m], [t.cpu() for t in v])
    for key, got, want in (("m", m, auto[0]), ("v", v, auto[1])) if auto else ():
        diffs, sizes = [], []
        for a, b in zip(got, want):
            b = b.to(a.device)
            diffs.append(float((a - b).abs().max()))
            sizes.append(float(b.abs().max()))
        out[f"{key}_abs"], out[f"{key}_max"] = max(diffs), max(sizes)
        out[f"{key}_err"] = max(d / max(sz, 1e-30) for d, sz in zip(diffs, sizes))
    return out, None


def _pod_mesh4(torch, dev, rank, ckpt):
    """Phase 17 (a) and the saving half of (b) in one of 4 ranks."""
    import torch.distributed as dist

    from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.core.collectives import make_mesh
    from repro_torch.core.serdes import QuasiSerdesConfig
    from repro_torch.data.pipeline import DataConfig, _synthesize
    from repro_torch.kernels import flash_attention, ops
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import make_train_step, state_shardings
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import init_params
    from repro_torch.optim import AdamWConfig, adamw_init

    meshes = {shape: make_mesh(tuple(zip(("pod", "data", "model"), shape)), range(4),
                               axis_groups=True) for shape in ((2, 1, 2), (2, 2, 1))}
    m22 = make_host_mesh(model=2)
    out = dict(device=str(dev), pod={})
    full = get_config("llama3.2-1b").replace(attn_impl="flash")
    data = DataConfig(vocab=full.vocab, seq_len=128, global_batch=8, seed=0)
    batch = train.device_batch(_synthesize(data, 0), full, dev)
    out["warm_s"] = warm_up(torch, dev, full.replace(dtype="float32"), batch,
                            meshes[(2, 1, 2)], pod_sync="serdes",
                            serdes=QuasiSerdesConfig(compress="int8"))
    # the full model's auto step, and on (2, 2, 1) rank 0's step alone (the
    # whole batch, whole params: what the mesh's steps must equal) and the
    # none step, hold every flash call to the plain version
    for name, layers, shape, variants in (("full", 16, (2, 1, 2), POD_VARIANTS),
                                          ("cut", ELASTIC_LAYERS, (2, 2, 1), ("one", "none"))):
        cfg = full.replace(n_layers=layers)
        runs, auto = {}, None
        for v in variants:
            dist.barrier()          # each step starts together, after rank 0's step alone
            if v == "one" and rank != 0:
                continue
            mesh = None if v == "one" else meshes[shape]
            # phase 9's weights (seed 0; each leaf drawn whole, the rank's
            # block kept), drawn again for each variant: one copy a rank
            masters = init_params(T.abstract_params(cfg),
                                  torch.Generator(device=dev).manual_seed(0), dev, mesh=mesh)
            params = conditioned(masters, cfg)
            del masters
            serdes = None if v in ("auto", "one") else QuasiSerdesConfig(compress=v)
            runs[v], kept = _pod_step(torch, mesh, cfg.replace(dtype="float32"), params, batch,
                                      "serdes" if serdes else "auto", serdes, auto,
                                      keep=serdes is None, hold=serdes is None or name == "cut")
            auto = kept if kept is not None else auto
            del params
            torch.cuda.empty_cache()
        out["pod"][name] = runs
        del auto

    # (b) the saving half: 2 bf16 steps on (2, 2), then the checkpoint
    cfg = full.replace(n_layers=ELASTIC_LAYERS)
    masters = init_params(T.abstract_params(cfg), torch.Generator(device=dev).manual_seed(0),
                          dev, mesh=m22)
    state = {"params": conditioned(masters, cfg)}
    del masters
    state["opt"] = adamw_init(state["params"])
    step = make_train_step(cfg, AdamWConfig(lr=3e-4), mesh=m22, total_steps=6, warmup=1)
    ops.reset_launch_counts()
    combines0 = flash_attention.flash_attention.combine_launches
    losses = []
    for s in range(ELASTIC_STEPS):
        state, mets = step(state, train.device_batch(_synthesize(data, s), cfg, dev))
        losses.append(float(mets["loss"]))
    flash = ops.launch_counts()["flash_attention"]
    combines = flash_attention.flash_attention.combine_launches - combines0
    (_, save_s) = wall(torch, lambda: CheckpointManager(
        CheckpointConfig(ckpt, async_save=False), m22, state_shardings(cfg, m22)).save(
            ELASTIC_STEPS, state))
    out["elastic"] = dict(losses=losses, save_s=save_s, flash=flash, combines=combines)
    return out


def _elastic_restore2(torch, dev, rank, ckpt):
    """Phase 17 (b)'s restoring half in one of 2 ranks: the mesh of
    ``factor_mesh``, ``restore(shardings=remesh_plan(...))``, the gathered
    blocks against the saved arrays, one float32 step."""
    import json

    import torch.distributed as dist

    from repro_torch._tree import flatten
    from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, _synthesize
    from repro_torch.kernels import flash_attention, ops
    from repro_torch.launch import train
    from repro_torch.launch.steps import make_train_step, state_shardings
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import gather_params
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import factor_mesh, remesh_plan
    from repro_torch.runtime.elastic import make_mesh_from_devices

    cfg = get_config("llama3.2-1b").replace(attn_impl="flash", n_layers=ELASTIC_LAYERS)
    shape, axes = factor_mesh(2, prefer_model=2)
    mesh = make_mesh_from_devices(range(2), shape, axes)
    plan = remesh_plan(T.abstract_params(cfg), mesh)
    shardings = {"params": plan, "opt": {"m": plan, "v": plan, "step": None}}
    data = DataConfig(vocab=cfg.vocab, seq_len=128, global_batch=8, seed=0)
    batch = train.device_batch(_synthesize(data, ELASTIC_STEPS), cfg, dev)
    warm_s = warm_up(torch, dev, cfg.replace(dtype="float32"), batch, mesh)
    torch.cuda.reset_peak_memory_stats()
    (state, step_no, _), restore_s = wall(torch, lambda: CheckpointManager(
        CheckpointConfig(ckpt)).restore(elastic_proto(torch, cfg, dev), shardings=shardings))
    out = dict(mesh=(shape, axes), step=step_no, restore_s=restore_s, warm_s=warm_s)
    # the blocks, gathered, against the arrays in the files
    whole = gather_params(state, state_shardings(cfg, mesh), mesh)
    d = os.path.join(ckpt, f"step_{step_no:08d}")
    with open(os.path.join(d, "meta.json")) as fh:
        volume_of = json.load(fh)["volume_of"]
    equal = 0
    for i, ((_, t), vol) in enumerate(zip(flatten(whole), volume_of)):
        if rank == 0:
            with np.load(os.path.join(d, f"arrays_{vol:02d}.npz")) as z:
                want = torch.as_tensor(z[f"a{i}"])
            equal += int(t.dtype == want.dtype and torch.equal(t.cpu(), want))
    out.update(equal=equal if rank == 0 else None, leaves=len(volume_of))
    del whole
    torch.cuda.empty_cache()
    dist.barrier()          # rank 0 compared alone: the timed step starts together
    step = make_train_step(cfg.replace(dtype="float32"), AdamWConfig(lr=3e-4), mesh=mesh,
                           total_steps=6, warmup=1)
    ops.reset_launch_counts()
    mesh.stats.reset()
    combines0 = flash_attention.flash_attention.combine_launches
    with holding_flash(torch) as rec:
        (_, mets), secs = wall(torch, lambda: step(state, batch))
    out.update(mets=(float(mets["loss"]), float(mets["grad_norm"])), step_ms=secs * 1e3,
               transport_ms=mesh.stats.seconds * 1e3, staged=mesh.stats.staged_bytes,
               flash=ops.launch_counts()["flash_attention"], per_call=rec["errs"],
               flash_shape=", ".join(f"q {q} k {k}" for q, k in sorted(rec["shapes"])),
               combines=flash_attention.flash_attention.combine_launches - combines0,
               peak=torch.cuda.max_memory_allocated())
    return out


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

# -- phase 18: the multi-pod dry run and the H100 roofline ---------------------------

# (a) the dry run's cells on the host, one process each: args, and the
# record files each must leave with their status
DRYRUN_CELLS = (
    (["--arch", "llama3.2-1b", "--shape", "train_4k", "--single-pod-only"], "main",
     {"llama3.2-1b__train_4k__16x16": "ok"}),
    (["--arch", "llama3.2-1b", "--shape", "train_4k", "--single-pod-only",
      "--override", "attn_impl=flash"], "flash", {"llama3.2-1b__train_4k__16x16": "ok"}),
    (["--arch", "gemma-7b", "--shape", "train_4k", "--single-pod-only"], "main",
     {"gemma-7b__train_4k__16x16": "ok"}),
    (["--arch", "internvl2-1b", "--shape", "train_4k", "--single-pod-only"], "main",
     {"internvl2-1b__train_4k__16x16": "ok"}),
    (["--arch", "jamba-v0.1-52b", "--shape", "decode_32k", "--single-pod-only"], "main",
     {"jamba-v0.1-52b__decode_32k__16x16": "ok"}),
    (["--arch", "xlstm-350m", "--shape", "long_500k"], "main",
     {"xlstm-350m__long_500k__16x16": "ok", "xlstm-350m__long_500k__2x16x16": "ok"}),
    (["--arch", "llama3.2-1b", "--shape", "long_500k"], "main",
     {"llama3.2-1b__long_500k__16x16": "skip", "llama3.2-1b__long_500k__2x16x16": "skip"}),
)


def roofline_phase(torch, dev, smi):
    """Phase 18: (a) the dry run on the host over `DRYRUN_CELLS` and its
    report; (b) llama3.2-1b FULL's train step and whisper-large-v3 FULL's
    prefill counted on the card over real tensors and over fake copies of the
    same arguments."""
    from repro_torch.launch import report

    t_phase = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"), OMP_NUM_THREADS="1")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        procs = []
        for args, sub, _ in DRYRUN_CELLS:
            out = os.path.join(tmp, sub)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", *args, "--device", "cuda",
                 "--out", out], cwd=HERE, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        lines, mems = [], {}
        for p, (args, sub, want) in zip(procs, DRYRUN_CELLS):
            out, err = p.communicate(timeout=400)
            check(p.returncode == 0, f"dryrun {args}: exit {p.returncode}\n{out[-2000:]}"
                                     f"\n{err[-2000:]}")
            lines += [ln for ln in out.splitlines() if ln[:4] in ("OK  ", "SKIP", "FAIL")]
            for stem, status in want.items():
                with open(os.path.join(tmp, sub, stem + ".json")) as fh:
                    rec = json.load(fh)
                check(rec["status"] == status, f"dryrun {stem}: {rec['status']} "
                                               f"{rec.get('error', '')}")
                if status == "ok":
                    mems[f"{stem}{' (flash)' if sub == 'flash' else ''}"] = rec["memory"]
        dry_s = time.perf_counter() - t0
        for ln in lines:
            print(f"  {ln}")
        print(f"dry run of {len(lines)} cells on the host (fake CUDA tensors, {len(procs)} "
              f"processes at once): {dry_s:.1f} s")
        # the logits stay sharded on the mesh: a rank's counted peak of the
        # llama3.2-1b train_4k step fits the card
        card = torch.cuda.get_device_properties(0).total_memory
        for stem, m in mems.items():
            print(f"  memory a rank, {stem}: temp_bytes {m['temp_bytes']}, peak_bytes "
                  f"{m['peak_bytes']} ({m['peak_bytes'] / 1e9:.2f} GB; argument_bytes "
                  f"{m['argument_bytes']}, output_bytes {m['output_bytes']})")
        peak = mems["llama3.2-1b__train_4k__16x16"]["peak_bytes"]
        check(peak < card, f"dryrun llama3.2-1b__train_4k__16x16: peak_bytes {peak} a rank "
                           f"over the card's {card} bytes")
        print(f"  llama3.2-1b x train_4k: counted peak a rank {peak / 1e9:.2f} GB under the "
              f"card's {card / 1e9:.2f} GB ({smi})")
        print(report.table(os.path.join(tmp, "main"), md=True))
        print(report.table(os.path.join(tmp, "flash"), md=True).splitlines()[-1]
              + "  <- attn_impl=flash")

    launches, combines = {}, {}
    for tag, build in (("llama_train_counted", _llama_counted),
                       ("whisper_prefill_counted", _whisper_counted)):
        launches[tag], combines[tag] = _counted_on_card(torch, dev, smi, tag, *build(torch, dev))
    _flash_op_host_cost(torch, dev, smi)
    print(f"roofline phase {time.perf_counter() - t_phase:.2f} s")
    return {"launches": launches, "combine_launches": combines}


def _llama_counted(torch, dev):
    """llama3.2-1b FULL with flash, one train step at batch 8 x seq 128 from
    seeded weights: (cfg, fn, args, model FLOPs, the forward whose flash
    calls are held, (flash launches, combines, flash calls of the forward)):
    under remat each layer's flash runs again in the backward."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, _synthesize
    from repro_torch.launch import train
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import init_params
    from repro_torch.optim import AdamWConfig, adamw_init

    cfg = get_config("llama3.2-1b").replace(attn_impl="flash")
    params = init_params(T.abstract_params(cfg), torch.Generator(device=dev).manual_seed(0))
    state = {"params": params, "opt": adamw_init(params)}
    batch = train.device_batch(_synthesize(DataConfig(vocab=cfg.vocab, seq_len=128,
                                                      global_batch=8, seed=0), 0), cfg, dev)
    step = make_train_step(cfg, AdamWConfig(lr=3e-4), total_steps=6, warmup=5)
    return (cfg, step, (state, batch), 6.0 * cfg.active_param_count() * 8 * 128,
            lambda: T.loss(state["params"], batch, cfg), (2 * cfg.n_layers, 0, cfg.n_layers))


def _whisper_counted(torch, dev):
    """whisper-large-v3 FULL with flash, one prefill at batch 4 (prompt 32)
    from a bf16 serving copy of seeded weights, into a cache of 32: the
    encoder's self-attention and the decoder's cross-attention take flash
    (the cross-attention's keys split, so a combine each), the decoder's
    cached self-attention the plain path."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import init_params

    cfg = get_config("whisper-large-v3").replace(attn_impl="flash")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = T.cast_params(init_params(T.abstract_params(cfg), gen), cfg.cdtype)
    batch = {"tokens": torch.randint(0, cfg.vocab, (4, 32), generator=gen, device=dev),
             "frames": torch.randn((4, cfg.enc_seq, cfg.d_frontend), generator=gen,
                                   device=dev).to(cfg.cdtype)}
    cache = T.init_cache(cfg, 4, 32, device=dev)

    def fn(p, b, c):
        return T.prefill(p, b, cfg, c)
    return (cfg, fn, (params, batch, cache), 2.0 * cfg.active_param_count() * 4 * 32,
            lambda: fn(params, batch, cache),
            (cfg.n_enc_layers + cfg.n_layers, cfg.n_layers, cfg.n_enc_layers + cfg.n_layers))


def _counted_on_card(torch, dev, smi, tag, cfg, fn, args, mflops, forward, expect):
    """Count ``fn(*args)`` over the real CUDA tensors (launch counters reset
    just before, read just after) and over fake copies of the same
    arguments; hold them equal, the counted kernel ops to the launches, and
    every flash call of ``forward`` to its plain version; print the synced
    wall beside the H100 roofline terms.  -> (flash launches, combines)."""
    from repro_torch._tree import leaves, unflatten
    from repro_torch.kernels import flash_attention, ops
    from repro_torch.launch import dryrun
    from repro_torch.launch import roofline as RL

    fm = dryrun.fake_mode()
    fake_args = unflatten(list(args), [fm.from_tensor(t) if isinstance(t, torch.Tensor) else t
                                       for t in leaves(list(args))])
    with fm:
        t0 = time.perf_counter()
        fake = dryrun.count(fn, fake_args)[0]
        fake_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    (real, _), counted_s = wall(torch, lambda: dryrun.count(fn, args))
    n_launch = ops.launch_counts()["flash_attention"]
    n_comb = flash_attention.flash_attention.combine_launches
    rt, ft = real.totals(), fake.totals()
    check(rt == ft and real.ops == fake.ops,
          f"{tag}: the count over real tensors {rt} differs from the fake count {ft}; ops "
          f"only real {real.ops - fake.ops}, only fake {fake.ops - real.ops}")
    k_ops = real.ops["repro_torch.flash_attention"]
    check(k_ops == n_launch == expect[0] and n_comb == expect[1],
          f"{tag}: counted flash ops {k_ops}, launches {(n_launch, n_comb)}, "
          f"expected {expect[:2]}")
    walls = [wall(torch, lambda: fn(*args))[1] for _ in range(4)][1:]
    (_, per_call) = held_flash_calls(torch, forward)
    worst = max(per_call)
    check(len(per_call) == expect[2] and worst <= 1e-2,
          f"{tag}: {len(per_call)} flash calls held, worst max |diff| / max |out| {worst:.3e}")
    roof = RL.analyze(rt, n_chips=1, model_flops_global=mflops)
    fused_ms = rt["bytes"] / RL.HBM_BW * 1e3
    med = statistics.median(walls)
    print(f"{tag}: the count over real CUDA tensors equals the count over fake copies of the "
          f"same arguments: flops {rt['flops']:.6e}, bytes {rt['bytes']:.6e}, raw bytes "
          f"{rt['bytes_raw']:.6e}, {sum(real.ops.values())} ops of {len(real.ops)} kinds "
          f"(fake run {fake_s:.2f} s, counted real run {counted_s:.2f} s); flash ops "
          f"{k_ops} = launches {n_launch}, {n_comb} of them with a combine launch; every "
          f"flash call of the forward ({len(per_call)}) held to the plain version, worst max "
          f"|diff| / max |out| {worst:.3e} (limit 1e-2)")
    print(f"  {tag}: synced wall {med * 1e3:.3f} ms (median of 3 after a warm-up; "
          f"{', '.join(f'{w * 1e3:.3f}' for w in walls)}) against the H100 roofline terms: "
          f"compute {roof.compute_s * 1e3:.3f} ms, memory {fused_ms:.3f} ms fusion-aware / "
          f"{roof.memory_s * 1e3:.3f} ms raw, collective {roof.collective_s * 1e3:.3f} ms; "
          f"model FLOPs {mflops:.4e} = {roof.useful_flops_frac:.3f} of the counted; "
          f"wall / max(compute, fusion-aware memory) "
          f"{med / max(roof.compute_s, fused_ms / 1e3):.2f} ({smi})")
    return n_launch, n_comb


def _flash_op_host_cost(torch, dev, smi):
    """Host microseconds a flash call spends in the custom-op dispatch, at
    llama3.2-1b's training shape (no split) and whisper's cross-attention
    shape (3 splits and a combine, in the op's one C call): the op
    (``torch.ops.repro_torch.flash_attention``) against its function called
    directly, and the wrapper the models call (its checks around the op);
    5 interleaved rounds of 1000 calls each."""
    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(18)
    for what, (B, Hq, Hkv, S, T, D), causal in (("llama train", (8, 32, 8, 128, 128, 64), True),
                                               ("whisper cross", (4, 20, 20, 32, 1500, 64), False)):
        q = torch.randn((B, Hq, S, D), generator=g, device=dev).to(torch.bfloat16)
        k = torch.randn((B, Hkv, T, D), generator=g, device=dev).to(torch.bfloat16)
        v = torch.randn((B, Hkv, T, D), generator=g, device=dev).to(torch.bfloat16)
        n = fa.num_splits(B, Hq, S, T, fa._build.sm_count(dev), D)
        calls = {"wrapper": lambda: fa.flash_attention(q, k, v, causal),
                 "op": lambda: torch.ops.repro_torch.flash_attention.default(q, k, v, causal),
                 "direct": lambda: fa._flash_forward._init_fn(q, k, v, causal)}
        want = calls["direct"]()
        check(all(torch.equal(f(), want) for f in calls.values()),
              f"flash through the custom op differs from the direct launch at {what}")
        per = {name: [] for name in calls}
        for _ in range(5):
            for name, f in calls.items():
                for _ in range(50):
                    f()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(1000):
                    f()
                per[name].append((time.perf_counter() - t0) / 1000 * 1e6)
                torch.cuda.synchronize()
        added = [o - d for o, d in zip(per["op"], per["direct"])]
        ms = timed(torch, calls["wrapper"])
        print(f"flash custom op at {what} ({B}, {Hq}:{Hkv}, {S}, {T}, {D}) bf16, {n} split(s), "
              f"host us a call by round: " + "; ".join(
                  f"{name} {', '.join(f'{x:.2f}' for x in xs)}" for name, xs in per.items())
              + f"; the dispatch adds {', '.join(f'{x:.2f}' for x in added)} (median "
              f"{statistics.median(added):.2f}); the call's device time {ms:.4f} ms, "
              f"L2 warm ({smi})")


def _to(x, device):
    """A copy on ``device`` (the train step updates its params in place)."""
    if isinstance(x, dict):
        return {k: _to(v, device) for k, v in x.items()}
    return x.to(device, copy=True)



if __name__ == "__main__":
    sys.exit(main())
