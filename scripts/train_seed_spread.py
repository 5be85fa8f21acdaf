#!/usr/bin/env python3
"""How far SMOKE training losses move under other weights or under rounding,
on the CPU.

    PYTHONPATH=src python3 scripts/train_seed_spread.py [--steps 25]

For llama3.2-1b SMOKE (batch 8 × seq 32, the quickstart's run) and
qwen3-moe-235b-a22b SMOKE (batch 8 × seq 64, ``examples/train_lm_torch.py``'s
run), at lr 2e-3 on the train driver's schedule and the same batches:

- the step-1 loss under weights drawn with seeds 0–7: the spread that a card
  and a CPU drawing different weights would show;
- the loss at ``--steps`` with the seed-0 weights scaled by 1 + eps × N(0, 1)
  for eps = 1e-7 (float32 rounding) and 1e-6, against the unperturbed run:
  how far rounding alone carries the card's losses from the CPU's.

Prints one JSON line per arch.
"""
import argparse
import json

import numpy as np
import torch

from repro_torch._tree import leaves
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, ShardedTokenPipeline
from repro_torch.launch import train
from repro_torch.launch.steps import make_train_step
from repro_torch.optim import AdamWConfig, adamw_init

RUNS = {"llama3.2-1b": 32, "qwen3-moe-235b-a22b": 64}


def losses(cfg, seq, seed, eps, steps):
    state = train.build_state(cfg, seed, "cpu")
    if eps:
        g = torch.Generator().manual_seed(1)
        with torch.no_grad():
            for p in leaves(state["params"]):
                p.mul_(1 + eps * torch.randn(p.shape, generator=g))
        state["opt"] = adamw_init(state["params"])
    step = make_train_step(cfg, AdamWConfig(lr=2e-3), total_steps=100, warmup=5)
    pipe = ShardedTokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=8, seed=0))
    out = []
    try:
        for s in range(steps):
            state, m = step(state, train.device_batch(pipe.batch_at(s), cfg, "cpu"))
            out.append(float(m["loss"]))
    finally:
        pipe.close()
    return np.array(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=25)
    args = ap.parse_args(argv)
    for arch, seq in RUNS.items():
        cfg = get_config(arch, smoke=True)
        first = np.array([losses(cfg, seq, s, 0.0, 1)[0] for s in range(8)])
        base = losses(cfg, seq, 0, 0.0, args.steps)
        moved = {eps: float(np.abs(losses(cfg, seq, 0, eps, args.steps) - base).max())
                 for eps in (1e-7, 1e-6)}
        print(json.dumps({
            "arch": arch, "step1_loss_by_seed": first.round(4).tolist(),
            "step1_spread_rel": float((first.max() - first.min()) / first.mean()),
            "steps": args.steps,
            "max_loss_moved_by_eps": {f"{k:g}": v for k, v in moved.items()}}))


if __name__ == "__main__":
    main()
