"""The MoE layer's mesh cases, shared by tests/test_torch_moe_mesh.py (not
collected itself): the oracles of tests/test_distributed.py:9 and :46 and
tests/test_moe_noc.py:100, :140, :181 and :227, on weights and inputs made
from seeds, with

* :func:`write_inputs` — every case's weights and inputs as numpy, drawn
  with the port's ``init_params`` (the reference's init rules: the router
  ``small``, the experts fan-in) and numpy generators;
* :func:`run_reference` — the reference's results, in a process with 8 fake
  CPU devices, each call under ``jax.jit`` (an eager ``shard_map`` of the
  noc engine compiles for 10–40 s a call on this host, a jitted one in under
  a second), on meshes built as ``Mesh(devices.reshape(...), ("data",
  "model"))`` with Auto axes (under ``jax.make_mesh``'s Explicit axes the
  reference's gather engine raises);
* :func:`port_results` — the port's results in one rank of a gloo world of 8
  (`tests/torch_spmd_worlds.py`): the (2, 4) and (1, 8) meshes of
  ``make_host_mesh``, and two (1, 4) meshes side by side (ranks 0–3 and
  4–7), so every rank returns the same result.

A case's result is ``(out, aux, stats, warnings)``: the output and aux as
numpy, ``MoEDispatchStats.as_dict()`` with ``drops`` and ``peak_occupancy``
as ints, and the ``moe_apply`` warnings' messages in order.
"""
from __future__ import annotations

import dataclasses
import pickle
import warnings

import numpy as np

TOPOS = ("fattree", "ring", "mesh2d", "torus2d")
DEPTHS = (1, 2, 4, 8)
LM_ARCH = "qwen3-moe-235b-a22b"
LM_KW = dict(moe_impl="noc", moe_topology="mesh2d", moe_flit_buffer_depth=1)


def _layer(E, d, f, seed):
    """One MoE layer's weights (numpy), drawn with the port's init rules."""
    import torch

    from repro_torch.models import moe as M
    from repro_torch.models.layers import init_params

    p = init_params(M.moe_specs(M.MoEConfig(d, E, 2, f)), torch.Generator().manual_seed(seed))
    return {k: v.numpy() for k, v in p.items()}


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# (name, mesh shape, weights (E, d, f, seed), x (shape, seed), [(tag, cfg kwargs)])
def cases():
    eng = [("dense", dict(impl="dense", capacity_factor=8.0)),
           ("gather", dict(impl="gather", capacity_factor=8.0))]
    eng += [(f"noc-{t}", dict(impl="noc", noc_topology=t, capacity_factor=8.0)) for t in TOPOS]
    counters = [("dense", dict(impl="dense"))]
    counters += [(f"noc-{t}", dict(impl="noc", noc_topology=t, depth=4)) for t in TOPOS]
    parity = []
    for depth in DEPTHS:
        parity += [(f"gather-{depth}", dict(impl="gather", depth=depth)),
                   (f"noc-{depth}", dict(impl="noc", noc_topology="torus2d", depth=depth))]
    one = [("gather", dict(impl="gather")), ("gather-2", dict(impl="gather", depth=2))]
    one += [(f"noc-{t}", dict(impl="noc", noc_topology=t)) for t in TOPOS]
    one += [("noc-torus2d-2", dict(impl="noc", noc_topology="torus2d", depth=2))]
    return [
        ("engines", (2, 4), (8, 32, 64, 0), ((4, 16, 32), 0), eng),
        ("ring", (1, 4), (8, 32, 64, 0), ((2, 8, 32), 1),
         [("dense", dict(impl="dense", capacity_factor=8.0)),
          ("noc-ring", dict(impl="noc", noc_topology="ring", capacity_factor=8.0))]),
        ("counters", (1, 8), (16, 32, 48, 0), ((2, 32, 32), 2), counters),
        ("parity", (2, 4), (8, 32, 64, 0), ((4, 16, 32), 1), parity),
        ("fallback-experts", (1, 4), (6, 32, 64, 0), ((2, 8, 32), 3),
         [("gather", dict(impl="gather"))]),
        ("fallback-decode", (1, 4), (8, 32, 64, 0), ((2, 2, 32), 3),
         [("noc", dict(impl="noc"))]),
        ("one-rank", (1, 1), (8, 32, 64, 0), ((2, 8, 32), 4), one),
    ]


def moe_cfg(M, NoCConfig, E, d, f, kw):
    kw = dict(kw)
    depth = kw.pop("depth", 0)
    return M.MoEConfig(d, E, 2, f, noc=NoCConfig(flit_buffer_depth=depth) if depth else None,
                       **kw)


def lm_inputs(vocab):
    rng = np.random.default_rng(5)
    return {"tokens": rng.integers(0, vocab, (2, 16)).astype(np.int32),
            "labels": rng.integers(0, vocab, (2, 16)).astype(np.int32),
            "prompts": rng.integers(0, vocab, (2, 8)).astype(np.int32)}


def write_inputs(path) -> None:
    """Every case's numpy weights and input, and qwen3-moe SMOKE's params
    (the port's init, in the reference's tree) and batch, pickled."""
    import torch

    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as TT
    from repro_torch.models.layers import init_params

    data = {}
    for name, _, w, (xs, xseed), _ in cases():
        data[name] = (_layer(*w), _x(xs, xseed))
    cfg = get_config(LM_ARCH, smoke=True).replace(**LM_KW)
    lm = init_params(TT.abstract_params(cfg), torch.Generator().manual_seed(0))
    data["lm"] = (convert.model_params_to_numpy(lm), lm_inputs(cfg.vocab))
    data["grad"] = (_layer(*GRAD_LAYER), _x(GRAD_X, 7))
    with open(path, "wb") as fh:
        pickle.dump(data, fh)


def _moe_messages(caught) -> list[str]:
    return [str(m.message) for m in caught if "moe_apply" in str(m.message)]


# ---------------------------------------------------------------------------
# the reference (a process with 8 fake CPU devices)
# ---------------------------------------------------------------------------

def run_reference(in_path, out_path) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro.configs import get_config
    from repro.core.noc import NoCConfig
    from repro.launch import serve as jserve
    from repro.launch.mesh import set_mesh
    from repro.models import moe as M
    from repro.models import transformer as JT

    with open(in_path, "rb") as fh:
        data = pickle.load(fh)

    def mesh_of(shape):
        n = int(np.prod(shape))
        return Mesh(np.array(jax.devices()[:n]).reshape(shape), ("data", "model"))

    def apply(w, x, c, mesh):
        box = []

        def f(w, x):
            out, aux, st = M.moe_apply(w, x, c)
            box.append(st)
            return out, aux, st.drops, st.peak_occupancy

        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            with set_mesh(mesh):
                out, aux, drops, peak = jax.jit(f)(w, x)
        st = dataclasses.replace(box[0], drops=int(drops), peak_occupancy=int(peak))
        return np.asarray(out), float(aux), st.as_dict(), _moe_messages(caught)

    res = {}
    for name, shape, (E, d, f, _), _, cfgs in cases():
        w, x = data[name]
        w = {k: jnp.asarray(v) for k, v in w.items()}
        for tag, kw in cfgs:
            res[(name, tag)] = apply(w, jnp.asarray(x), moe_cfg(M, NoCConfig, E, d, f, kw),
                                     mesh_of(shape))

    # tests/test_moe_noc.py:227 through loss, and serve_batch, on a (1, 4) mesh
    params, batch = data["lm"]
    cfg = get_config(LM_ARCH, smoke=True).replace(**LM_KW)
    params = jax.tree.map(jnp.asarray, params)
    mesh = mesh_of((1, 4))
    with set_mesh(mesh):
        loss, mets = jax.jit(lambda p, b: JT.loss(p, b, cfg))(
            params, {k: jnp.asarray(batch[k]) for k in ("tokens", "labels")})
    res["lm-loss"] = (float(loss), {k: float(v) for k, v in mets.items()})
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        toks = jserve.serve_batch(params, cfg, batch["prompts"], 4, mesh)
    res["lm-serve"] = (np.asarray(toks), sorted(set(_moe_messages(caught))))
    with open(out_path, "wb") as fh:
        pickle.dump(res, fh)


# ---------------------------------------------------------------------------
# the port, in one rank of a gloo world of 8
# ---------------------------------------------------------------------------

def port_apply(M, w, x, c):
    """The port's ``moe_apply`` on weights ``w`` (tensors) and a numpy input,
    with no grad."""
    import torch

    with warnings.catch_warnings(record=True) as caught, torch.no_grad():
        warnings.simplefilter("always")
        out, aux, st = M.moe_apply(w, torch.as_tensor(x), c)
    st = dataclasses.replace(st, drops=int(st.drops), peak_occupancy=int(st.peak_occupancy))
    return out.numpy(), float(aux), st.as_dict(), _moe_messages(caught)


def _raises(fn):
    try:
        fn()
    except Exception as e:      # the type and message are what the test reads
        return f"{type(e).__name__}: {e}"
    return None


def port_results(rank, world, device, in_path):
    import torch

    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.core import collectives as coll
    from repro_torch.core.noc import NoCConfig
    from repro_torch.core.partition import DEFAULT_RULES, mesh_shape
    from repro_torch.launch import serve as tserve
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh, set_mesh
    from repro_torch.launch.steps import shardings_for_params
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as TT
    from repro_torch.models.layers import param_pspecs, shard_params

    with open(in_path, "rb") as fh:
        data = pickle.load(fh)
    # every rank makes every mesh, in the same order (making a group is collective)
    halves = [coll.make_mesh((("data", 1), ("model", 4)), range(h, h + 4), axis_groups=True)
              for h in (0, 4)]
    meshes = {(2, 4): make_host_mesh(model=4), (1, 8): make_host_mesh(model=8),
              (1, 4): halves[rank // 4]}
    res, mine = {}, {}      # results equal on every rank, and this rank's own
    for name, shape, (E, d, f, _), _, cfgs in cases():
        if shape not in meshes:
            continue
        w, x = data[name]
        with set_mesh(meshes[shape]):
            # the rank's block of experts, as a serving caller hands it over
            # (dense_ref reads every expert)
            mesh = meshes[shape]
            specs = param_pspecs(M.moe_specs(M.MoEConfig(d, E, 2, f)), DEFAULT_RULES,
                                 mesh.axis_names, mesh_shape(mesh))
            wl = shard_params(_torch(w), specs, mesh)
            for tag, kw in cfgs:
                res[(name, tag)] = port_apply(M, _torch(w) if tag == "dense" else wl, x,
                                              moe_cfg(M, NoCConfig, E, d, f, kw))
            res[(name, "expert-rows")] = int(wl["gate"].shape[0])

    # the LM on a (1, 4) mesh: loss (no grad), serve_batch(mesh=)
    params, batch = data["lm"]
    cfg = get_config(LM_ARCH, smoke=True).replace(**LM_KW)
    full = convert.model_params_to_torch(params, device)
    mesh = meshes[(1, 4)]
    with set_mesh(mesh):
        tparams = shard_params(full, shardings_for_params(cfg, mesh), mesh)
        tb = {k: torch.as_tensor(batch[k]).long() for k in ("tokens", "labels")}
        with torch.no_grad():
            loss, mets = TT.loss(tparams, tb, cfg)
        res["lm-loss"] = (float(loss), {k: float(v) for k, v in mets.items()})
        for k in ("gate", "up", "down"):
            mine[("lm-cut", k)] = tparams["blocks"]["0"]["moe"][k].numpy()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        toks = tserve.serve_batch(tparams, cfg, batch["prompts"], 4, device=device,
                                  mesh=meshes[(1, 4)])
    res["lm-serve"] = (np.asarray(toks), sorted(set(_moe_messages(caught))))

    # gradients through the engines on a mesh against the one-rank engine
    w, x = data["grad"]
    for shape in GRAD_MESHES:
        for impl in ("gather", "noc"):
            mine[("grad", shape, impl)] = grad_errors(M, _torch(w), x, impl, meshes[shape])

    # the collectives over each axis set of the (2, 4) mesh, on rank-valued rows
    mesh = meshes[(2, 4)]
    row = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * rank
    for names in (("data",), ("model",), ("data", "model"), ("model", "data")):
        ax = mesh.axis(names)
        mine[("coll", names)] = (ax.ranks, coll.all_gather(row, ax).numpy(),
                                 coll.psum(row, ax).numpy(), coll.pmean(row, ax).numpy(),
                                 coll.pmax(row, ax).numpy())
    ax = mesh.axis("model")
    cube = torch.arange(4 * 5, dtype=torch.int32).reshape(4, 5) + 100 * rank
    mine["a2a-model"] = (ax.ranks, coll.all_to_all(cube, ax).numpy())
    mine["transport"] = dataclasses.asdict(mesh.stats)
    res["mesh-errors"] = (_raises(lambda: make_host_mesh(model=3)),
                          _raises(make_production_mesh),
                          _raises(lambda: make_production_mesh(multi_pod=True)))
    return {"same": res, "rank": mine}


# the gradient cases: one layer (E, d, f, seed) on x (4, 16, d), drop free
GRAD_LAYER = (8, 32, 48, 2)
GRAD_X = (4, 16, 32)
GRAD_MESHES = ((1, 4), (2, 4))


def grad_errors(M, w, x, impl, mesh):
    """``moe_apply`` with ``impl`` on ``mesh`` (the rank's experts) and the
    one-rank engine with every expert, through the backward of ``sum(out · r)
    + aux`` (r seeded): max |diff| of the output and of the gradients of x,
    the router and the rank's experts, each over max(1, max |one-rank|)."""
    import torch

    from repro_torch.core import collectives as coll
    from repro_torch.core.partition import DEFAULT_RULES, block, mesh_shape
    from repro_torch.models.layers import param_pspecs

    E, d, f, _ = GRAD_LAYER
    c = M.MoEConfig(d, E, 2, f, capacity_factor=16.0, impl=impl, noc_topology="mesh2d")
    r = torch.as_tensor(_x(x.shape, 8))
    specs = param_pspecs(M.moe_specs(c), DEFAULT_RULES, mesh.axis_names, mesh_shape(mesh))

    def run(weights, m):
        xs = torch.as_tensor(x).requires_grad_()
        ws = {k: v.clone().requires_grad_() for k, v in weights.items()}
        with coll.use_mesh(m):
            out, aux, st = M.moe_apply(ws, xs, c)
        ((out * r).sum() + aux).backward()
        grads = {k: v.grad for k, v in ws.items()}
        return out.detach(), dict(grads, x=xs.grad), int(st.drops)

    mine = {k: block(v, specs[k], mesh).clone() for k, v in w.items()}
    out, g, drops = run(mine, mesh)
    out1, g1, drops1 = run(w, None)
    errs = {"out": float((out - out1).abs().max() / max(1.0, float(out1.abs().max())))}
    for k in g:
        want = g1[k] if k == "x" else block(g1[k], specs[k], mesh)
        errs[k] = float((g[k] - want).abs().max() / max(1.0, float(want.abs().max())))
    return errs, drops, drops1


def _torch(w):
    import torch

    return {k: torch.as_tensor(v) for k, v in w.items()}
