"""Serving driver: batched prefill + greedy decode (counterpart of
``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b --smoke \\
        --device cpu --requests 16 --batch 4 --prompt-len 32 --gen 16

Requests are grouped into fixed-size batches; each batch is prefilled once,
then decoded token by token against a shared cache (greedy sampling).  Eager
PyTorch.  ``--arch`` takes the archs the port registers (default
llama3.2-1b, as in the reference).

``--model-parallel N`` serves on a ``("data", "model")`` mesh of every rank
(`launch.mesh.make_host_mesh(model=N)`), started by torchrun:

    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.serve \
        --model-parallel 2 --dist-backend gloo --device cpu --smoke

Each rank joins the group over ``--dist-backend`` (required with more than
one rank: the transport never picks one), draws each leaf on the CPU
generator and keeps only its block (`models.layers.init_params(mesh=)`), and
serves every batch with the others; rank 0 prints.  ``--model-parallel 1``
without torchrun is the one-device path.

``--metrics PATH`` turns on the telemetry metrics registry: prefill and
per-token decode wall clock land in the ``serve.prefill.seconds`` /
``serve.decode.seconds`` histograms; the JSON snapshot (with p50/p99/p99.9)
is written to PATH ('-' = stdout).  Each sample starts and ends with the
device idle (``torch.cuda.synchronize()`` on a GPU), so it times finished
work, not kernel launches.
"""
from __future__ import annotations

import argparse
import json
import time
from contextlib import nullcontext

import numpy as np
import torch

from .._device import resolve_device, synchronize
from ..configs import ALL_ARCHS, get_config
from ..core.collectives import use_mesh
from ..core.partition import mesh_shape
from ..models import transformer as T
from ..models.layers import init_params
from ..telemetry.metrics import disable_metrics, enable_metrics
from .mesh import add_mesh_args, mesh_from_args


def serve_batch(params, cfg, prompts, gen: int, *, frames=None,
                device="cuda", reg=None, mesh=None) -> np.ndarray:
    """One batch: prefill once, decode token by token; (B, S) prompts →
    (B, gen) greedy tokens.  ``frames`` (B, enc_seq, d_frontend) feed the
    encoder of an encdec model, zeros by default as in the reference; a vlm
    model's prefill reads zero patches (B, n_patches, d_frontend), as in the
    reference, and its cache holds ``n_patches + S + gen`` positions (the
    reference sizes it ``S + gen``, which its prefill overflows).  Weights
    are read in ``cfg.cdtype`` (a no-op for params already cast with
    ``T.cast_params``).

    ``reg``: an optional telemetry `MetricsRegistry` — the prefill's wall
    clock is observed into ``serve.prefill.seconds`` once and each decode
    step's into ``serve.decode.seconds``.  Each sample is bracketed by device
    synchronizations, so it bounds the real latency of that step; without
    ``reg`` nothing is synchronized.

    ``mesh``: a `launch.mesh` mesh entered for the batch, as the reference's
    ``serve_batch`` enters its mesh (every rank of it calls ``serve_batch``
    on the same prompts, with the params cut to the rank's blocks,
    `models.layers.shard_params`; the cache holds the rank's block); None
    keeps the caller's ambient mesh.  Every rank returns the same tokens."""
    dev = resolve_device(device)
    params = T.cast_params(params, cfg.cdtype)
    B, S = prompts.shape
    n_pre = cfg.n_patches if cfg.family == "vlm" else 0
    batch = {"tokens": torch.as_tensor(np.asarray(prompts), device=dev)}
    if n_pre:
        batch["patches"] = torch.zeros((B, n_pre, cfg.d_frontend), dtype=cfg.cdtype,
                                       device=dev)
    if cfg.family == "encdec":
        shape = (B, cfg.enc_seq, cfg.d_frontend)
        batch["frames"] = (torch.zeros(shape, dtype=cfg.cdtype, device=dev) if frames is None
                           else torch.as_tensor(frames, device=dev).to(cfg.cdtype))
        if tuple(batch["frames"].shape) != shape:
            raise ValueError(f"frames must be {shape}, got {tuple(batch['frames'].shape)}")
    with torch.inference_mode(), (use_mesh(mesh) if mesh is not None else nullcontext()):
        cache = T.init_cache(cfg, B, n_pre + S + gen, device=dev)
        if reg is not None:
            synchronize(dev)
        ts = time.perf_counter()
        logits, cache = T.prefill(params, batch, cfg, cache)
        tok = logits[:, -1].argmax(-1)
        out = [tok]
        if reg is not None:
            synchronize(dev)
            reg.histogram("serve.prefill.seconds").observe(time.perf_counter() - ts)
        for _ in range(gen - 1):
            ts = time.perf_counter()
            logits, cache = T.decode_step(params, {"tokens": tok[:, None]}, cfg, cache)
            tok = logits.argmax(-1)
            out.append(tok)
            if reg is not None:
                synchronize(dev)
                reg.histogram("serve.decode.seconds").observe(time.perf_counter() - ts)
    return torch.stack(out, 1).cpu().numpy()


def run(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b", choices=ALL_ARCHS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    ap.add_argument("--metrics", default=None, metavar="PATH",
                    help="enable the telemetry metrics registry; write the "
                         "JSON snapshot here ('-' prints to stdout)")
    add_mesh_args(ap)
    args = ap.parse_args(argv)

    dev, mesh, joined = mesh_from_args(args, ap)
    try:
        return _serve(args, dev, mesh)
    finally:
        if joined:
            import torch.distributed as dist

            dist.destroy_process_group()


def _serve(args, dev, mesh):
    say = print if mesh is None or mesh.node == 0 else (lambda *a, **k: None)
    reg = enable_metrics() if args.metrics else None
    cfg = get_config(args.arch, smoke=args.smoke)
    gen = torch.Generator().manual_seed(args.seed)   # the same model on every device
    params = T.cast_params(init_params(T.abstract_params(cfg), gen, dev, mesh=mesh),
                           cfg.cdtype)
    rng = np.random.default_rng(args.seed)
    where = f"{dev}" if mesh is None else f"{dev}, mesh={mesh_shape(mesh)}"

    t0 = time.monotonic()
    done = 0
    all_out = []
    while done < args.requests:
        n = min(args.batch, args.requests - done)
        prompts = rng.integers(0, cfg.vocab, (args.batch, args.prompt_len)).astype(np.int64)
        out = serve_batch(params, cfg, prompts, args.gen, device=dev, reg=reg, mesh=mesh)
        all_out.append(out[:n])
        done += n
        say(f"served {done}/{args.requests} requests "
            f"(batch decode tok/s so far: {done * args.gen / (time.monotonic() - t0):,.1f})")
    dt = time.monotonic() - t0
    say(f"done: {args.requests} requests × {args.gen} tokens in {dt:.1f}s on {where}")
    if reg is not None:
        d = reg.histogram("serve.decode.seconds")
        say(f"decode/token: p50 {d.p50 * 1e3:.1f}ms  "
            f"p99 {d.p99 * 1e3:.1f}ms  p99.9 {d.p999 * 1e3:.1f}ms")
        # any NoC engine profiled in-process publishes noc.latency.*;
        # surface it next to the serve latencies (logical-clock ticks)
        for key, h in reg.histograms("noc.latency.").items():
            say(f"{key}: n={h.count} p50 {h.p50:.0f}  p99 {h.p99:.0f}  "
                f"p99.9 {h.p999:.0f} ticks")
        snap = json.dumps(reg.snapshot(), indent=1, sort_keys=True)
        if args.metrics == "-":
            say(snap)
        elif mesh is None or mesh.node == 0:
            with open(args.metrics, "w") as fh:
                fh.write(snap + "\n")
            say(f"metrics snapshot -> {args.metrics}")
        disable_metrics()
    return np.concatenate(all_out)


if __name__ == "__main__":
    run()
