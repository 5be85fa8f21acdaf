#!/usr/bin/env python3
"""Two trees of the repo timed end to end on one GPU, on the two paths whose
flash calls a change to the flash wrapper's dispatch moves: whisper-large-v3
FULL's prefill (batch 4, prompt 32, a bf16 serving copy of seeded weights, 64
flash calls) and llama3.2-1b FULL's train step (batch 8 x seq 128, 32 flash
calls under remat), both with ``attn_impl=flash``.

    python3 scripts/flash_op_paired.py PARENT . . PARENT

Each ROOT named runs in a process of its own, in the order given, importing
``repro_torch`` from ``ROOT/src`` (which builds its kernels there).  A worker
warms each path up, then times ``--reps`` calls of each, every call between
two device synchronizes, and prints one line a path: the median, the
quartiles and the extremes in ms, and the flash launches of one call (which
must be more than 0).  Then the card's name and power limit.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def worker(root, reps):
    sys.path.insert(0, os.path.join(os.path.abspath(root), "src"))
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, _synthesize
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import init_params
    from repro_torch.optim import AdamWConfig, adamw_init

    dev = torch.device("cuda")
    cfg = get_config("whisper-large-v3").replace(attn_impl="flash")
    gen = torch.Generator(device=dev).manual_seed(0)
    wparams = T.cast_params(init_params(T.abstract_params(cfg), gen), cfg.cdtype)
    wbatch = {"tokens": torch.randint(0, cfg.vocab, (4, 32), generator=gen, device=dev),
              "frames": torch.randn((4, cfg.enc_seq, cfg.d_frontend), generator=gen,
                                    device=dev).to(cfg.cdtype)}
    wcache = T.init_cache(cfg, 4, 32, device=dev)
    wcfg = cfg

    cfg = get_config("llama3.2-1b").replace(attn_impl="flash")
    params = init_params(T.abstract_params(cfg), torch.Generator(device=dev).manual_seed(0))
    state = {"params": params, "opt": adamw_init(params)}
    batch = train.device_batch(_synthesize(DataConfig(vocab=cfg.vocab, seq_len=128,
                                                      global_batch=8, seed=0), 0), cfg, dev)
    step = make_train_step(cfg, AdamWConfig(lr=3e-4), total_steps=reps + 10, warmup=5)

    paths = {"whisper_prefill": lambda: T.prefill(wparams, wbatch, wcfg, wcache),
             "llama_train_step": lambda: step(state, batch)}
    res = {}
    for name, fn in paths.items():
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        fn()
        torch.cuda.synchronize()
        launches = ops.launch_counts()["flash_attention"]
        if launches == 0:
            raise SystemExit(f"{name}: no flash launch in {root}")
        ms = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        q = statistics.quantiles(ms, n=4)
        res[name] = dict(median=statistics.median(ms), q1=q[0], q3=q[2], min=min(ms),
                         max=max(ms), launches=launches)
    print(json.dumps(res))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--worker", action="store_true")
    args = ap.parse_args()
    if args.worker:
        worker(args.roots[0], args.reps)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("flash_op_paired: no CUDA device is available", file=sys.stderr)
        return 1
    for i, root in enumerate(args.roots):
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker",
                              "--reps", str(args.reps), root], capture_output=True, text=True,
                             timeout=900)
        if out.returncode:
            print(out.stdout[-2000:], out.stderr[-4000:], file=sys.stderr)
            return out.returncode
        res = json.loads(out.stdout.strip().splitlines()[-1])
        for name, r in res.items():
            print(f"run {i} {root}: {name} median {r['median']:.3f} ms (quartiles "
                  f"{r['q1']:.3f}-{r['q3']:.3f}, range {r['min']:.3f}-{r['max']:.3f}; "
                  f"{args.reps} synced calls), {r['launches']} flash launches a call",
                  flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
