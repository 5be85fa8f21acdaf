#!/usr/bin/env python3
"""What llama3.2-1b FULL's bf16 train step costs a rank in memory and
transport on a (2, 2) ``("data", "model")`` mesh of 4 gloo ranks sharing
one GPU: ``chip_smoke.py`` phase 15 (b)'s step (seed-0 weights, batch 8 x
seq 128, remat, flash on the rank's head block), three steps.

    python3 scripts/tp_logits_memory.py [--src DIR --label NAME]...

For each ``--src`` (a checkout's ``src``; default this one's) in the order
given, a world of 4 ranks imports ``repro_torch`` from it and prints one
JSON line a rank: per step the loss, the synced wall, the bytes staged
through the host, the bytes of the collectives' outputs by kind (counted
by ``core.collectives.count_collectives``; an all-reduce's inner gather is
not counted apart) and the peak memory allocated.  Give two trees (an older
commit unpacked with ``git archive`` under the gitignored ``build/``, then
this one) to compare them on one card in one call.  The parent process
imports no ``repro_torch``.
"""
import argparse
import datetime
import json
import os
import pickle
import shutil
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD, STEPS = 4, 3


class CollectiveBytes:
    """A `core.collectives.count_collectives` counter: the bytes of the
    collectives' outputs by kind."""

    def __init__(self):
        self.bytes = {}

    def collective(self, kind, out):
        self.bytes[kind] = self.bytes.get(kind, 0) + out.numel() * out.element_size()

    def suspended(self):
        import contextlib
        return contextlib.nullcontext()


def _rank(rank, tmp, src):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    sys.path.insert(0, src)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(tmp, "store"), WORLD),
                            rank=rank, world_size=WORLD, timeout=datetime.timedelta(seconds=300))
    try:
        from repro_torch.configs import get_config
        from repro_torch.core import collectives as coll
        from repro_torch.data.pipeline import DataConfig, _synthesize
        from repro_torch.kernels import _build
        from repro_torch.launch import train
        from repro_torch.launch.mesh import join_process_group, make_host_mesh
        from repro_torch.launch.steps import make_train_step
        from repro_torch.models import transformer as T
        from repro_torch.models.layers import init_params
        from repro_torch.optim import AdamWConfig, adamw_init

        dev = join_process_group("gloo", "cuda")
        if rank == 0:               # one build a tree, before the others load it
            _build.library()
        dist.barrier()
        _build.library()
        mesh = make_host_mesh(model=2)
        cfg = get_config("llama3.2-1b").replace(attn_impl="flash")
        masters = init_params(T.abstract_params(cfg), torch.Generator(device=dev).manual_seed(0),
                              dev, mesh=mesh)
        state = {"params": masters, "opt": adamw_init(masters)}
        del masters
        step = make_train_step(cfg, AdamWConfig(lr=3e-4), mesh=mesh, total_steps=6, warmup=5)
        data = DataConfig(vocab=cfg.vocab, seq_len=128, global_batch=8, seed=0)
        batches = [train.device_batch(_synthesize(data, s), cfg, dev) for s in range(STEPS)]
        steps = []
        for bt in batches:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            mesh.stats.reset()
            counted = CollectiveBytes()
            t0 = time.perf_counter()
            with coll.count_collectives(counted):
                state, mets = step(state, bt)
            torch.cuda.synchronize()
            steps.append(dict(loss=float(mets["loss"]), ms=(time.perf_counter() - t0) * 1e3,
                              staged=mesh.stats.staged_bytes, collective_bytes=counted.bytes,
                              peak=torch.cuda.max_memory_allocated()))
        out = dict(rank=rank, device=torch.cuda.get_device_name(dev), steps=steps)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"{rank}.pkl"), "wb") as fh:
        pickle.dump(out, fh)


def run_world(src, deadline=600.0):
    import torch.multiprocessing as mp

    os.environ.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo")
    tmp = tempfile.mkdtemp(prefix="tp_logits_memory_")
    t0 = time.perf_counter()
    try:
        ctx = mp.start_processes(_rank, args=(tmp, src), nprocs=WORLD, join=False,
                                 start_method="spawn")
        try:
            while not ctx.join(timeout=1.0):
                if time.perf_counter() - t0 > deadline:
                    raise TimeoutError(f"the ranks still run after {deadline:.0f} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(10)
        res = []
        for r in range(WORLD):
            with open(os.path.join(tmp, f"{r}.pkl"), "rb") as fh:
                res.append(pickle.load(fh))
        return res
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description="llama3.2-1b FULL's train step on a (2, 2) "
                                             "mesh of 4 ranks: memory and transport a rank")
    ap.add_argument("--src", action="append", help="a checkout's src (repeatable)")
    ap.add_argument("--label", action="append", help="a name for each --src")
    args = ap.parse_args(argv)
    srcs = [os.path.abspath(s) for s in (args.src or [os.path.join(HERE, "src")])]
    labels = args.label or [os.path.relpath(s, HERE) for s in srcs]
    if len(labels) != len(srcs):
        ap.error("give one --label for each --src")
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: this script measures the card", file=sys.stderr)
        return 1
    for label, src in zip(labels, srcs):
        for r in run_world(src):
            print(json.dumps(dict(r, label=label, src=os.path.relpath(src, HERE))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
