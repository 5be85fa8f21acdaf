"""The cross-pod gradient exchange and elastic rescale: the cases of
tests/test_torch_pod_sync.py and tests/test_torch_elastic.py (not collected
itself).

The rank-side functions import neither jax nor the reference: they run in
gloo worlds of single-threaded ranks (`tests/torch_spmd_worlds.py`).  The
reference's side (:func:`run_reference`) runs in a subprocess with 4 fake
CPU devices, every call under ``jax.jit``; both read the same pickled
inputs (:func:`write_inputs`).
"""
from __future__ import annotations

import pickle

import numpy as np

PODS = (2, 4)
COMPRESS = ("plain", "none", "bf16", "int8")    # plain: cfg=None (a pmean)
SERIALIZED = (True, False)
# a tree of leaves whose sizes are no multiple of the int8 block (256) nor of
# the lanes' words
LEAVES = {"a": (5, 7), "b": {"c": (300,), "d": (2, 3, 129)}}
N_LEAVES = 3
TRAIN_MESHES = ((2, 2, 1), (2, 1, 2))
VARIANTS = ("auto", "none", "bf16", "int8")
ARCH, MOE_ARCH = "llama3.2-1b", "qwen3-moe-235b-a22b"
B, S, LR, TOTAL, WARMUP, STEPS = 8, 16, 1e-3, 10, 1, 2
ELASTIC_STEPS = 4
AXES = ("pod", "data", "model")


def _leaf_paths(tree, prefix=()):
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _leaf_paths(tree[k], prefix + (k,))]
    return [(prefix, tree)]


def _put(tree, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def pod_trees(n_pods, seed):
    """A tree of (n_pods, *shape) float32 leaves, pod ``i``'s contribution at
    index ``i``, with scales that differ by leaf and by pod."""
    rng = np.random.default_rng(seed)
    out = {}
    for i, (path, shape) in enumerate(_leaf_paths(LEAVES)):
        scale = np.exp(rng.normal(size=(n_pods,) + (1,) * len(shape)) + i)
        _put(out, path, (rng.normal(size=(n_pods,) + shape) * scale).astype(np.float32))
    return out


def train_batches(vocab, n=STEPS, rows=B):
    """Seeded (rows, S) tokens and labels, one batch a step."""
    rng = np.random.default_rng(29)
    return [{"tokens": rng.integers(0, vocab, (rows, S)).astype(np.int32),
             "labels": rng.integers(0, vocab, (rows, S)).astype(np.int32)} for _ in range(n)]


def write_inputs(path) -> dict:
    """The exchange's trees (two calls a pod count), llama3.2-1b SMOKE's
    params (the port's init, seed 0) and the train batches."""
    import torch

    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import init_params

    cfg = get_config(ARCH, smoke=True)
    params = init_params(T.abstract_params(cfg), torch.Generator().manual_seed(0))
    data = {"trees": {n: (pod_trees(n, 10 * n), pod_trees(n, 10 * n + 1)) for n in PODS},
            "params": convert.model_params_to_numpy(params),
            "batches": train_batches(cfg.vocab)}
    with open(path, "wb") as fh:
        pickle.dump(data, fh)
    return data


# ---------------------------------------------------------------------------
# the reference, in a process with 4 fake CPU devices
# ---------------------------------------------------------------------------

def _ref_exchange(n, compress, serialized, trees):
    """Both calls of the reference's ``cross_pod_mean`` under ``shard_map``
    over a ("pod",) mesh of ``n`` devices: (out1, res1, out2, res2) with a
    leading pod axis, int8's residuals (n, numel), 0.0 fillers as 0.0."""
    import jax
    from jax.sharding import Mesh, PartitionSpec as P

    from repro.compat import shard_map
    from repro.core.partition import cross_pod_mean
    from repro.core.serdes import QuasiSerdesConfig

    mesh = Mesh(np.array(jax.devices()[:n]), ("pod",))
    cfg = None if compress == "plain" else QuasiSerdesConfig(compress=compress)
    spec = jax.tree.map(lambda _: P("pod"), trees[0])
    results = []
    for i, tree in enumerate(trees):
        carried = results[1] if i == 1 and compress == "int8" else None

        def call(tree, res, second=i == 1):
            tree = jax.tree.map(lambda g: g[0], tree)
            if res is not None:
                res = jax.tree.map(lambda r: r[0], res)
            elif second and compress in ("none", "bf16"):
                res = jax.tree.map(lambda _: 0.0, tree)     # the first call's fillers
            out, new = cross_pod_mean(tree, "pod", cfg, res, n_pods=n, serialized=serialized)
            out = jax.tree.map(lambda g: g[None], out)
            if compress == "int8":
                return out, jax.tree.map(lambda r: r[None], new)
            assert (new is None if compress == "plain"
                    else all(f == 0.0 for f in jax.tree.leaves(new))), new
            return out, None

        fn = jax.jit(shard_map(call, mesh=mesh,
                               in_specs=(spec, spec if carried is not None else None),
                               out_specs=(spec, spec if compress == "int8" else None),
                               check_vma=False))
        out, new = fn(tree, carried)
        results += [jax.tree.map(np.asarray, out),
                    jax.tree.map(np.asarray, new) if new is not None else
                    (jax.tree.map(lambda _: 0.0, out) if compress in ("none", "bf16") else None)]
    return results


def _ref_train(params, batches, shape, variant):
    """The reference's ``make_train_step`` on a ("pod", "data", "model") mesh
    of ``shape``: per-step metrics and the state after :data:`STEPS` steps."""
    import jax
    from jax.sharding import Mesh

    from repro.configs import get_config
    from repro.core.serdes import QuasiSerdesConfig
    from repro.launch.mesh import set_mesh
    from repro.launch.steps import make_train_step
    from repro.optim import AdamWConfig, adamw_init

    cfg = get_config(ARCH, smoke=True)
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(shape), AXES)
    kw = (dict(pod_sync="auto") if variant == "auto" else
          dict(pod_sync="serdes", serdes=QuasiSerdesConfig(compress=variant)))
    with set_mesh(mesh):
        step = jax.jit(make_train_step(cfg, mesh, AdamWConfig(lr=LR), total_steps=TOTAL,
                                       warmup=WARMUP, **kw))
        p = jax.tree.map(jax.numpy.asarray, params)
        state, mets = {"params": p, "opt": adamw_init(p)}, []
        for b in batches:
            state, m = step(state, {k: jax.numpy.asarray(v) for k, v in b.items()})
            mets.append({k: float(v) for k, v in m.items()})
    return mets, jax.tree.map(np.asarray, state)


REFERENCE_PARTS = ("exchange",) + TRAIN_MESHES


def run_reference(in_path, out_path, part):
    """One part of the reference's results (:data:`REFERENCE_PARTS`: the
    exchange cases, or the train steps on one mesh shape), pickled."""
    with open(in_path, "rb") as fh:
        data = pickle.load(fh)
    out = {}
    if part == "exchange":
        for n in PODS:
            for c in COMPRESS:
                for ser in SERIALIZED:
                    out[("exchange", n, c, ser)] = _ref_exchange(n, c, ser, data["trees"][n])
    else:
        for v in VARIANTS:
            out[("train", part, v)] = _ref_train(data["params"], data["batches"], part, v)
    with open(out_path, "wb") as fh:
        pickle.dump(out, fh)


# ---------------------------------------------------------------------------
# the port, in one rank of a gloo world of 4
# ---------------------------------------------------------------------------

def _numpy(tree):
    import torch

    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.cpu().numpy() if isinstance(tree, torch.Tensor) else tree


def _exchange_results(rank, device, trees):
    """Both calls of ``cross_pod_mean`` per case on ("pod",) meshes: two
    meshes of 2 ranks side by side and one of 4.  The axis is named through
    the ambient mesh when the frame is sent whole, passed as a `MeshAxis`
    when serialized.  -> {case: (pod coordinate, out1, res1, out2, res2)}."""
    from repro_torch.core import collectives as coll
    from repro_torch.core.partition import cross_pod_mean
    from repro_torch.core.serdes import QuasiSerdesConfig

    halves = [coll.make_mesh((("pod", 2),), range(h, h + 2)) for h in (0, 2)]
    meshes = {2: halves[rank // 2], 4: coll.make_mesh((("pod", 4),), range(4))}
    res = {}
    for n in PODS:
        mesh = meshes[n]
        ax = mesh.axis("pod")
        local = [{k: _local(v, ax.coord, device) for k, v in t.items()} for t in trees[n]]
        for c in COMPRESS:
            cfg = None if c == "plain" else QuasiSerdesConfig(compress=c)
            for ser in SERIALIZED:
                got, r = [], None
                for tree in local:
                    with coll.use_mesh(mesh):
                        o, r = cross_pod_mean(tree, ax if ser else "pod", cfg, r, n_pods=n,
                                              serialized=ser)
                    got += [_numpy(o), _numpy(r)]
                res[("exchange", n, c, ser)] = (ax.coord, *got)
    return res


def _local(x, coord, device):
    import torch

    if isinstance(x, dict):
        return {k: _local(v, coord, device) for k, v in x.items()}
    return torch.as_tensor(x[coord]).to(device)


def _mesh(shape, groups=True):
    from repro_torch.core import collectives as coll

    return coll.make_mesh(tuple(zip(AXES, shape)), range(4), axis_groups=groups)


def _steps(cfg, whole, batches, mesh, device, pod_sync, serdes):
    """:data:`STEPS` steps of ``make_train_step`` on ``mesh`` from the whole
    state ``whole``: per-step metrics and the gathered state (numpy)."""
    import torch

    from repro_torch import convert
    from repro_torch import optim as toptim
    from repro_torch.launch.steps import make_train_step, state_shardings
    from repro_torch.models.layers import gather_params, shard_params

    sspecs = state_shardings(cfg, mesh)
    state = shard_params(whole, sspecs, mesh)
    step = make_train_step(cfg, toptim.AdamWConfig(lr=LR), mesh=mesh, pod_sync=pod_sync,
                           serdes=serdes, total_steps=TOTAL, warmup=WARMUP)
    mets = []
    for b in batches:
        state, m = step(state, {k: torch.as_tensor(v).long().to(device) for k, v in b.items()})
        mets.append({k: float(v) for k, v in m.items()})
    g = gather_params(state, sspecs, mesh)
    return mets, {"params": convert.model_params_to_numpy(g["params"]),
                  "opt": convert.opt_state_to_numpy(g["opt"])}


def _int8_blocks(device, trees):
    """``launch.steps._pod_sync``'s int8 exchange on the (2, 1, 2) mesh, one
    leaf at a time: pod ``p``'s leaf "b/c" of the exchange's first call
    (300,) split over ``model`` (blocks of 150, which split int8's blocks of
    256, so it goes whole) and a seeded (2, 512) leaf split on its last dim
    (each row's block 256 long, so the blocks go as they are).  -> {leaf:
    (pod, model coordinate, the rank's result, its block of the whole
    leaf's `cross_pod_mean`)}."""
    import torch

    from repro_torch.core import collectives as coll
    from repro_torch.core.partition import block, cross_pod_mean
    from repro_torch.core.serdes import QuasiSerdesConfig
    from repro_torch.launch.steps import _pod_sync

    mesh = _mesh((2, 1, 2))
    pod, model = mesh.axis("pod").coord, mesh.axis("model").coord
    cfg = QuasiSerdesConfig(compress="int8")
    rows = np.random.default_rng(7).normal(size=(2, 2, 512)).astype(np.float32)
    out = {}
    for name, whole, spec in (("c", trees[0]["b"]["c"][pod], ("model",)),
                              ("rows", rows[pod], (None, "model"))):
        whole = torch.as_tensor(whole).to(device)
        flat = [block(whole, spec, mesh).clone()]
        _pod_sync(flat, [spec], mesh, 2, cfg)
        with coll.use_mesh(mesh):
            mean, _ = cross_pod_mean(whole, "pod", cfg, n_pods=2)
        out[name] = (pod, model, _numpy(flat[0]), _numpy(block(mean, spec, mesh).contiguous()))
    return out


def _variant(v):
    from repro_torch.core.serdes import QuasiSerdesConfig

    return ("auto", None) if v == "auto" else ("serdes", QuasiSerdesConfig(compress=v))


def pod_sync_results(rank, world, device, in_path):
    """Each rank's own: the exchange cases (:func:`_exchange_results`) and
    llama3.2-1b SMOKE under every variant on :data:`TRAIN_MESHES` (a ring
    exchange adds the pods' gradients in another order on each pod, and a
    lossy one rounds another pod's on each); the same on every rank:
    qwen3-moe SMOKE on (2, 1, 2)
    under ``auto`` and ``serdes`` ``none``, llama on a pod axis of 1, and the
    errors of a mesh with no axis groups and of a batch that does not
    split."""
    from repro_torch import convert
    from repro_torch import optim as toptim
    from repro_torch.configs import get_config
    from repro_torch.launch.train import build_state

    with open(in_path, "rb") as fh:
        data = pickle.load(fh)
    mine = _exchange_results(rank, device, data["trees"])
    mine["int8 blocks"] = _int8_blocks(device, data["trees"][2])
    cfg = get_config(ARCH, smoke=True)
    params = convert.model_params_to_torch(data["params"], device)
    whole = {"params": params, "opt": toptim.adamw_init(params)}
    same = {}
    for shape in TRAIN_MESHES:       # a lossy ring leaves each pod its own sums
        mesh = _mesh(shape)
        for v in VARIANTS:
            mine[("train", shape, v)] = _steps(cfg, whole, data["batches"], mesh, device,
                                               *_variant(v))
    mesh = _mesh((1, 2, 2))
    for v in ("auto", "none"):
        same[("pod1", v)] = _steps(cfg, whole, data["batches"], mesh, device, *_variant(v))
    qcfg = get_config(MOE_ARCH, smoke=True)
    qwhole = build_state(qcfg, 0, device)
    qbatches = train_batches(qcfg.vocab)
    mesh = _mesh((2, 1, 2))
    for v in ("auto", "none"):
        same[("moe", v)] = _steps(qcfg, qwhole, qbatches, mesh, device, *_variant(v))
    for case, shape, batches, groups in (
            ("no groups", (2, 1, 2), data["batches"], False),
            ("batch of 6", (2, 2, 1), train_batches(cfg.vocab, 1, 6), True)):
        try:
            _steps(cfg, whole, batches, _mesh(shape, groups), device, *_variant("none"))
            same[("error", case)] = None
        except ValueError as e:
            same[("error", case)] = str(e)
    return {"same": same, "rank": mine}


# ---------------------------------------------------------------------------
# elastic rescale: a world of 4 saves, a world of 2 restores
# ---------------------------------------------------------------------------

def elastic_save(rank, world, device, ckpt_dir):
    """llama3.2-1b SMOKE (seed 0) trained :data:`ELASTIC_STEPS` steps on a
    (2, 2) ``("data", "model")`` mesh of 4 ranks and saved from it."""
    import torch

    from repro_torch import optim as toptim
    from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import make_train_step, state_shardings
    from repro_torch.launch.train import build_state

    cfg = get_config(ARCH, smoke=True)
    mesh = make_host_mesh(model=2)
    state = build_state(cfg, 0, device, mesh=mesh)
    step = make_train_step(cfg, toptim.AdamWConfig(lr=LR), mesh=mesh, total_steps=TOTAL,
                           warmup=WARMUP)
    losses = []
    for b in train_batches(cfg.vocab, ELASTIC_STEPS):
        state, m = step(state, {k: torch.as_tensor(v).long().to(device) for k, v in b.items()})
        losses.append(float(m["loss"]))
    CheckpointManager(CheckpointConfig(ckpt_dir, async_save=False), mesh,
                      state_shardings(cfg, mesh)).save(ELASTIC_STEPS, state)
    return {"losses": losses}


def elastic_restore(rank, world, device, ckpt_dir):
    """A world of 2 ranks: the mesh of ``factor_mesh(2, prefer_model=2)``,
    the checkpoint restored through ``restore(shardings=remesh_plan(...))``,
    each restored block against the saved array cut by ``block`` (bit for
    bit), the rank's leaf shapes, and one step on the batch after the saved
    ones."""
    import torch

    from repro_torch import optim as toptim
    from repro_torch._tree import flatten
    from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.core.partition import block, spec_leaves
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import build_state
    from repro_torch.models import transformer as T
    from repro_torch.runtime import factor_mesh, remesh_plan
    from repro_torch.runtime.elastic import make_mesh_from_devices

    cfg = get_config(ARCH, smoke=True)
    shape, axes = factor_mesh(world, prefer_model=2)
    mesh = make_mesh_from_devices(range(world), shape, axes)
    plan = remesh_plan(T.abstract_params(cfg), mesh)
    shardings = {"params": plan, "opt": {"m": plan, "v": plan, "step": None}}
    proto = build_state(cfg, 1, device, mesh=mesh)
    cm = CheckpointManager(CheckpointConfig(ckpt_dir, async_save=False))
    state, step_no, _ = cm.restore(proto, shardings=shardings)
    equal = {}
    for (path, t), sh, want in zip(flatten(state), spec_leaves(shardings),
                                   saved_arrays(ckpt_dir, step_no)):
        want = torch.as_tensor(want)
        want = want if sh is None else block(want, sh.spec, sh.mesh)
        equal["/".join(map(str, path))] = (t.dtype == want.dtype and t.shape == want.shape
                                           and torch.equal(t.cpu(), want))
    step = make_train_step(cfg, toptim.AdamWConfig(lr=LR), mesh=mesh, total_steps=TOTAL,
                           warmup=WARMUP)
    b = train_batches(cfg.vocab, ELASTIC_STEPS + 1)[-1]
    _, m = step(state, {k: torch.as_tensor(v).long().to(device) for k, v in b.items()})
    return {"mesh": (shape, axes), "step": step_no, "equal": equal,
            "shapes": {"/".join(map(str, p)): tuple(t.shape) for p, t in flatten(state)},
            "mets": {k: float(v) for k, v in m.items()}}



def saved_arrays(ckpt_dir, step) -> list:
    """The leaves a checkpoint step holds, read straight from its files."""
    import json
    import os

    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "meta.json")) as fh:
        meta = json.load(fh)
    out = []
    for i, vol in enumerate(meta["volume_of"]):
        with np.load(os.path.join(d, f"arrays_{vol:02d}.npz")) as z:
            out.append(z[f"a{i}"])
    return out
