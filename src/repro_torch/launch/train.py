"""End-to-end training driver (counterpart of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b --smoke \\
        --device cpu --steps 200 --batch 8 --seq 128 --ckpt /tmp/ckpt

Runs on one device (``--device``, default ``cuda``; it raises without a GPU
unless ``--device cpu`` is given) with the substrate engaged: the sharded
deterministic data pipeline, AdamW under the cosine schedule, remat, and
checkpoint/restart through the resilient runner.

``--model-parallel N`` trains on a ``("data", "model")`` mesh of every rank
(`launch.mesh.make_host_mesh(model=N)`), started by torchrun:

    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \
        --model-parallel 2 --dist-backend gloo --device cpu --smoke --steps 6

Each rank joins over ``--dist-backend`` (required with more than one rank),
keeps its blocks of the params and of AdamW's state, and runs the step on
the whole batch (`launch.steps.make_train_step(mesh=)`: the batch split over
``data``, the weights over ``model``); rank 0 prints and writes the
checkpoint, the gathered global tree in the one-device files, and a restore
cuts it for any mesh.  ``--pod-sync {auto,serdes}`` is passed to
`launch.steps.make_train_step`, as in the reference: the host mesh has no
``pod`` axis, so both take the same path (the cross-pod exchange runs on a
mesh with one, through `make_train_step(pod_sync="serdes", serdes=...)`).

``--metrics PATH`` turns on the telemetry metrics registry: each step's wall
clock lands in the ``train.step.seconds`` histogram (p50/p99/p99.9 printed at
the end), bracketed by ``torch.cuda.synchronize()`` on a GPU, and the step's
metrics publish through ``record_step_metrics`` (an MoE model's
``moe_drops`` and ``moe_peak_occupancy`` land on ``noc.moe.drops`` and
``noc.moe.peak_occupancy``); the JSON snapshot is written to PATH ('-' =
stdout).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .._device import resolve_device, synchronize
from ..checkpoint import CheckpointConfig, CheckpointManager
from ..configs import ALL_ARCHS, get_config
from ..core.partition import mesh_shape
from ..data import DataConfig, ShardedTokenPipeline
from ..models import transformer as T
from ..models.layers import init_params
from ..optim import AdamWConfig, adamw_init
from ..runtime import FTConfig, ResilientRunner
from ..telemetry.metrics import disable_metrics, enable_metrics
from .mesh import add_mesh_args, mesh_from_args
from .steps import make_train_step, state_shardings


def build_state(cfg, seed: int = 0, device="cuda", mesh=None) -> dict:
    """Params drawn from ``seed`` and a fresh AdamW state on ``device``.  The
    draws come from a CPU generator, so a seed gives the same model on every
    device (as the reference's ``jax.random.key`` does); on a ``mesh`` each
    rank keeps its blocks."""
    dev = resolve_device(device)
    params = init_params(T.abstract_params(cfg), torch.Generator().manual_seed(seed), dev,
                         mesh=mesh)
    return {"params": params, "opt": adamw_init(params)}


def device_batch(batch: dict, cfg, device) -> dict:
    """A pipeline batch (numpy int32) as int64 tensors on ``device``, with the
    zero frames an encdec model reads and the zero patches a vlm model
    reads, as the reference feeds them."""
    out = {k: torch.as_tensor(np.asarray(v), device=device).long() for k, v in batch.items()}
    B = out["tokens"].shape[0]
    if cfg.family == "encdec":
        out["frames"] = torch.zeros((B, cfg.enc_seq, cfg.d_frontend), dtype=cfg.cdtype,
                                    device=device)
    if cfg.family == "vlm":
        out["patches"] = torch.zeros((B, cfg.n_patches, cfg.d_frontend), dtype=cfg.cdtype,
                                     device=device)
    return out


def run(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b", choices=ALL_ARCHS)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--pod-sync", default="auto", choices=["auto", "serdes"])
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    ap.add_argument("--metrics", default=None, metavar="PATH",
                    help="enable the telemetry metrics registry; write the "
                         "JSON snapshot here ('-' prints to stdout)")
    add_mesh_args(ap)
    args = ap.parse_args(argv)

    dev, mesh, joined = mesh_from_args(args, ap)
    try:
        return _train(args, dev, mesh)
    finally:
        if joined:
            import torch.distributed as dist

            dist.destroy_process_group()


def _train(args, dev, mesh):
    say = print if mesh is None or mesh.node == 0 else (lambda *a, **k: None)
    cfg = get_config(args.arch, smoke=args.smoke)
    opt_cfg = AdamWConfig(lr=args.lr)
    step_fn = make_train_step(cfg, opt_cfg, mesh=mesh, pod_sync=args.pod_sync,
                              total_steps=args.steps, warmup=max(args.steps // 20, 5))
    state = build_state(cfg, args.seed, dev, mesh=mesh)
    where = f"device={dev}" if mesh is None else f"mesh={mesh_shape(mesh)} device={dev}"
    say(f"arch={cfg.name} params={cfg.param_count():,} {where} "
        f"tokens/step={args.batch * args.seq}")

    reg = enable_metrics() if args.metrics else None
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch,
                      seed=args.seed)
    pipeline = ShardedTokenPipeline(dcfg)
    losses = []

    def wrapped(state, batch):
        tb = device_batch(batch, cfg, dev)
        if reg is not None:
            synchronize(dev)
        ts = time.perf_counter()
        state, mets = step_fn(state, tb)
        loss = float(mets["loss"])   # waits for the step's results
        if reg is not None:
            synchronize(dev)
            reg.histogram("train.step.seconds").observe(time.perf_counter() - ts)
            reg.record_step_metrics(mets)
        losses.append(loss)
        n = len(losses)
        if n % args.log_every == 0 or n == 1:
            say(f"step {n:5d}  loss {losses[-1]:.4f}  "
                f"gnorm {float(mets['grad_norm']):.3f}")
        return state

    try:
        start = 0
        if args.ckpt:
            cm = CheckpointManager(CheckpointConfig(args.ckpt, keep_last=2), mesh=mesh,
                                   specs=state_shardings(cfg, mesh) if mesh else None)
            runner = ResilientRunner(wrapped, cm, FTConfig(checkpoint_every=args.ckpt_every))
            start = cm.latest_step() or 0
            if start:
                state, start, _ = cm.restore(state)
                say(f"restored from step {start}")
            t0 = time.monotonic()
            state, _ = runner.run(state, pipeline, args.steps, start)
        else:
            t0 = time.monotonic()
            for s in range(args.steps):
                state = wrapped(state, pipeline.batch_at(s))
        dt = time.monotonic() - t0
    finally:
        pipeline.close()
    tok_s = (args.steps - start) * args.batch * args.seq / max(dt, 1e-9)
    summary = f"loss {losses[0]:.4f} -> {losses[-1]:.4f}" if losses else "no steps left"
    say(f"done: {args.steps - start} steps in {dt:.1f}s ({tok_s:,.0f} tok/s) on {dev}; "
        f"{summary}")
    if reg is not None:
        h = reg.histogram("train.step.seconds")
        say(f"step time: p50 {h.p50 * 1e3:.1f}ms  p99 {h.p99 * 1e3:.1f}ms  "
            f"p99.9 {h.p999 * 1e3:.1f}ms")
        # any NoC engine profiled in-process publishes noc.latency.*;
        # surface it next to the step times (logical-clock ticks)
        for key, hh in reg.histograms("noc.latency.").items():
            say(f"{key}: n={hh.count} p50 {hh.p50:.0f}  p99 {hh.p99:.0f}  "
                f"p99.9 {hh.p999:.0f} ticks")
        snap = json.dumps(reg.snapshot(), indent=1, sort_keys=True)
        if args.metrics == "-":
            say(snap)
        elif mesh is None or mesh.node == 0:
            with open(args.metrics, "w") as fh:
                fh.write(snap + "\n")
            say(f"metrics snapshot -> {args.metrics}")
        disable_metrics()
    return losses


if __name__ == "__main__":
    run()
