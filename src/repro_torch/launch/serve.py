"""Serving driver: batched prefill + greedy decode (counterpart of
``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b --smoke \\
        --device cpu --requests 16 --batch 4 --prompt-len 32 --gen 16

Requests are grouped into fixed-size batches; each batch is prefilled once,
then decoded token by token against a shared cache (greedy sampling).  Eager
PyTorch.  ``--model-parallel`` waits for the mesh slice, and ``--arch`` takes
the archs the port registers (default llama3.2-1b, as in the reference).

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

import numpy as np
import torch

from .._device import resolve_device, synchronize
from ..configs import ALL_ARCHS, get_config
from ..models import transformer as T
from ..models.layers import init_params
from ..telemetry.metrics import disable_metrics, enable_metrics


def serve_batch(params, cfg, prompts, gen: int, *, frames=None,
                device="cuda", reg=None) -> np.ndarray:
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
    ``reg`` nothing is synchronized."""
    dev = resolve_device(device)
    params = T.cast_params(params, cfg.cdtype)
    B, S = prompts.shape
    n_pre = cfg.n_patches if cfg.family == "vlm" else 0
    cache = T.init_cache(cfg, B, n_pre + S + gen, device=dev)
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
    with torch.inference_mode():
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
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    reg = enable_metrics() if args.metrics else None
    cfg = get_config(args.arch, smoke=args.smoke)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = T.cast_params(init_params(T.abstract_params(cfg), gen), cfg.cdtype)
    rng = np.random.default_rng(args.seed)

    t0 = time.monotonic()
    done = 0
    all_out = []
    while done < args.requests:
        n = min(args.batch, args.requests - done)
        prompts = rng.integers(0, cfg.vocab, (args.batch, args.prompt_len)).astype(np.int64)
        out = serve_batch(params, cfg, prompts, args.gen, device=dev, reg=reg)
        all_out.append(out[:n])
        done += n
        print(f"served {done}/{args.requests} requests "
              f"(batch decode tok/s so far: {done * args.gen / (time.monotonic() - t0):,.1f})")
    dt = time.monotonic() - t0
    print(f"done: {args.requests} requests × {args.gen} tokens in {dt:.1f}s on {dev}")
    if reg is not None:
        d = reg.histogram("serve.decode.seconds")
        print(f"decode/token: p50 {d.p50 * 1e3:.1f}ms  "
              f"p99 {d.p99 * 1e3:.1f}ms  p99.9 {d.p999 * 1e3:.1f}ms")
        # any NoC engine profiled in-process publishes noc.latency.*;
        # surface it next to the serve latencies (logical-clock ticks)
        for key, h in reg.histograms("noc.latency.").items():
            print(f"{key}: n={h.count} p50 {h.p50:.0f}  p99 {h.p99:.0f}  "
                  f"p99.9 {h.p999:.0f} ticks")
        snap = json.dumps(reg.snapshot(), indent=1, sort_keys=True)
        if args.metrics == "-":
            print(snap)
        else:
            with open(args.metrics, "w") as fh:
                fh.write(snap + "\n")
            print(f"metrics snapshot -> {args.metrics}")
        disable_metrics()
    return np.concatenate(all_out)


if __name__ == "__main__":
    run()
