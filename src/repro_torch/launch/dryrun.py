"""Multi-pod dry run: prove the distribution config is coherent without
hardware (counterpart of ``repro/launch/dryrun.py``).

For every (architecture × input shape) cell, run rank 0 of the production
mesh on fake tensors and count its program (`launch.roofline.CostCounter`):

    single-pod: (data=16, model=16)        = 256 ranks
    multi-pod:  (pod=2, data=16, model=16) = 512 ranks

The world is a no-op process group of 256 or 512 ranks in this one process
(torch's ``"fake"`` backend and ``FakeStore``, from the private module
``torch.testing._internal.distributed.fake_pg``): making the mesh's groups
and every collective return at once, moving nothing.  The state, batch and
cache are ``FakeTensor``\\ s on ``--device`` (the rank's blocks: shapes and
dtypes, no storage), so a cell at full size needs no memory and no card.
On a torch built without CUDA a fake CUDA tensor cannot be indexed, so there
the dry run takes ``--device cpu``; on the CPU the flash kernel is never
called (its wrapper takes the plain version), on ``cuda`` its custom op
is counted.

Each cell runs its step once at full depth: eager dispatch counts every trip
of every loop, so that one count is exact and needs none of the reference's
depth-1/depth-2 trip-count correction.  ``roofline`` is `roofline.analyze`
of it and ``roofline_corrected`` `roofline.extrapolate` of it at one period
(the reference's fields, memory from the fusion-aware bytes), so a record
has the reference's keys and either package's ``report`` reads the other's
directory.  In a record, ``lower_s`` is the seconds to build the cell's mesh,
step and fake arguments and ``compile_s`` the seconds of the counted
full-depth run (nothing is compiled).  ``memory`` comes from the fake run:
``argument_bytes`` the rank's state, batch and cache, ``output_bytes`` the
step's outputs (an output the step updates in place counts, as XLA counts a
donated one), ``temp_bytes`` the high-water mark of the live storages the
step allocated, ``peak_bytes`` the arguments plus that.  A cell whose
program cannot run on fake tensors (an op whose output shape depends on
values, a value read back to the host) ends ``FAIL`` with the error.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out results/dryrun --device cpu
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback

import torch
import torch.distributed as dist

from .._tree import leaves
from ..configs import ALL_ARCHS, SHAPES, cell_supported, get_config
from ..core.partition import NO_TP, rules_override
from . import roofline as RL
from .mesh import make_production_mesh
from .steps import jit_decode, jit_prefill, jit_train_step, param_blocks


def _arch_overrides(cfg, shape):
    """Per-cell config adjustments: long-context decode shards KV/state
    sequence over 'data'."""
    if shape.name == "long_500k":
        cfg = cfg.replace(seq_shard_kv=True)
    return cfg


@contextlib.contextmanager
def fake_world(world_size: int):
    """This process as rank 0 of a no-op process group of ``world_size``
    ranks, torn down on exit (so a test process can go on)."""
    if dist.is_initialized():
        raise RuntimeError("the dry run makes its own process group: a default group "
                           "is initialized already")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def fake_mode():
    """A ``FakeTensorMode`` that also takes the real tensors a program makes
    as constants."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode(allow_non_fake_inputs=True)


def build_cell(cfg, shape, mesh, step_kw=None, device="cpu"):
    """-> (fn, args): the cell's step and its arguments on ``device``
    (fake, under the caller's ``FakeTensorMode``, or real)."""
    if shape.kind == "train":
        step, state, batch = jit_train_step(cfg, mesh, shape, device=device, **(step_kw or {}))
        return step, (state, batch)
    params = param_blocks(cfg, mesh, device, serve=True)
    if shape.kind == "prefill":
        fn, batch, cache = jit_prefill(cfg, mesh, shape, device)
    else:
        fn, batch, cache = jit_decode(cfg, mesh, shape, device)
    return fn, (params, batch, cache)


def count(fn, args):
    """-> (counter, outputs): ``fn(*args)`` run once under a fresh
    `roofline.CostCounter`, the arguments registered."""
    counter = RL.CostCounter()
    with counter:
        counter.add_arguments(list(args))
        out = fn(*args)
    return counter, out


def _output_bytes(out) -> int:
    seen, total = set(), 0
    for t in leaves(out):
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            if st._cdata not in seen:
                seen.add(st._cdata)
                total += st.nbytes()
    return total


def dryrun_cell(arch: str, shape_name: str, *, multi_pod: bool,
                overrides: dict | None = None, device="cuda") -> dict:
    shape = SHAPES[shape_name]
    cfg = get_config(arch)
    ok, why = cell_supported(cfg, shape)
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "2x16x16" if multi_pod else "16x16", "status": "skip",
           "reason": why}
    if not ok:
        return rec
    cfg = _arch_overrides(cfg, shape)
    no_tp = False
    sp = False
    step_kw = {}
    if overrides:
        overrides = dict(overrides)
        no_tp = overrides.pop("no_tp", False)
        sp = overrides.pop("sp", False)
        if overrides.pop("pod_sync_serdes", False):
            from ..core.serdes import QuasiSerdesConfig
            step_kw = dict(pod_sync="serdes", serdes=QuasiSerdesConfig(compress="bf16"))
        cfg = cfg.replace(**overrides)
    device = torch.device(device)
    if no_tp:
        rules_ctx = rules_override(**NO_TP)
    elif sp:  # sequence parallelism: activations seq-sharded over 'model'
        rules_ctx = rules_override(seq="model")
    else:
        rules_ctx = contextlib.nullcontext()
    try:
        if device.type == "cuda" and not torch.backends.cuda.is_built():
            raise RuntimeError("this torch is built without CUDA: a fake CUDA tensor cannot "
                               "be indexed here; run the dry run with --device cpu")
        with fake_world(512 if multi_pod else 256), rules_ctx:
            t0 = time.monotonic()
            mesh = make_production_mesh(multi_pod=multi_pod)
            n_chips = mesh.size
            with fake_mode():
                fn, args = build_cell(cfg, shape, mesh, step_kw, device)
                t_lower = time.monotonic() - t0
                counter, out = count(fn, args)
                t_compile = time.monotonic() - t0 - t_lower
                out_bytes = _output_bytes(out)
            del fn, args, out
            mf = RL.model_flops(cfg, shape)
            totals = counter.totals()
            roof = RL.analyze(totals, n_chips=n_chips, model_flops_global=mf)
            # the reference's corrected fields (single-pod only: the roofline
            # table is single-pod; the multi-pod pass proves the 'pod' axis shards)
            if multi_pod:
                corrected = {"error": "n/a (roofline table is single-pod)"}
            else:
                corrected = RL.extrapolate(totals, totals, 1, n_chips=n_chips,
                                           model_flops_global=mf)
            rec.update(
                status="ok",
                lower_s=round(t_lower, 1),
                compile_s=round(t_compile, 1),
                params=cfg.param_count(),
                active_params=cfg.active_param_count(),
                roofline=roof.as_dict(),
                roofline_corrected=corrected,
                memory={
                    "argument_bytes": counter.argument_bytes,
                    "output_bytes": out_bytes,
                    "temp_bytes": counter.temp_peak_bytes,
                    "peak_bytes": counter.temp_peak_bytes + counter.argument_bytes,
                },
            )
    except Exception as e:
        rec.update(status="FAIL", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-2000:])
    return rec


def format_line(rec: dict) -> str:
    """The line the CLI prints for a record."""
    tag = f"{rec['arch']} × {rec['shape']} × {rec['mesh']}"
    if rec["status"] == "ok":
        r = rec.get("roofline_corrected") or rec["roofline"]
        if "error" in r:
            r = rec["roofline"]
        return (f"OK   {tag}: compile {rec['compile_s']}s, "
                f"dominant={r['dominant']} "
                f"c/m/coll = {r['compute_s']:.4f}/{r['memory_s']:.4f}/"
                f"{r['collective_s']:.4f}s  peak_frac={r['peak_fraction']:.3f}")
    if rec["status"] == "skip":
        return f"SKIP {tag}: {rec['reason']}"
    return f"FAIL {tag}: {rec['error']}"


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--out", default=None, help="directory for per-cell json")
    ap.add_argument("--override", action="append", default=[],
                    help="cfg override key=value (e.g. moe_impl=noc)")
    ap.add_argument("--device", default="cuda",
                    help="device of the fake tensors (cuda, or cpu on a torch without CUDA)")
    args = ap.parse_args(argv)

    overrides = {}
    for kv in args.override:
        k, v = kv.split("=", 1)
        try:
            v = json.loads(v)
        except Exception:
            pass
        overrides[k] = v

    archs = [args.arch] if args.arch else list(ALL_ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = []
    if not args.multi_pod_only:
        meshes.append(False)
    if not args.single_pod_only:
        meshes.append(True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    n_fail = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                if args.out:  # resume: skip cells already recorded OK
                    fn = f"{arch}__{shape}__{'2x16x16' if mp else '16x16'}.json".replace("/", "_")
                    fp = os.path.join(args.out, fn)
                    if os.path.exists(fp):
                        try:
                            with open(fp) as fh:
                                old = json.load(fh)
                            if old.get("status") in ("ok", "skip"):
                                print(f"SKIP(cached) {arch} × {shape} × {old['mesh']}")
                                continue
                        except Exception:
                            pass
                rec = dryrun_cell(arch, shape, multi_pod=mp, overrides=overrides or None,
                                  device=args.device)
                n_fail += rec["status"] == "FAIL"
                print(format_line(rec), flush=True)
                if args.out:
                    fn = f"{arch}__{shape}__{rec['mesh']}.json".replace("/", "_")
                    with open(os.path.join(args.out, fn), "w") as f:
                        json.dump(rec, f, indent=1)
    print(f"\ndone; failures: {n_fail}")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
