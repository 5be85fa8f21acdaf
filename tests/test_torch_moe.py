"""The port's MoE layer and MoE family (phi3.5-moe, qwen3-moe) against the JAX
package, on the CPU.

* Capacity, exactly: ``dispatch_capacity`` and ``effective_capacity_factor``
  on the cases of tests/test_moe_noc.py (the floor of 8, the clamp, the flit
  buffer depth as the knob) and a grid around them; ``MoEDispatchStats``.
* The dispatch, exactly: ``_dispatch_slots`` keeps the reference's packets in
  the reference's slots over random routings, one and two source blocks.
* The layer: ``impl="gather"`` (one rank) against the reference's
  ``moe_apply`` under a one-device ``("data", "model")`` mesh with Auto axes
  (the context the reference's gather engine runs in; under
  ``make_host_mesh()``'s Explicit axes it raises) at ``moe_flit_buffer_depth``
  1, 2 and 0 (the ``capacity_factor`` formula): drops and peak occupancy
  equal, the dropped packets and the tokens left with no expert equal, the
  outputs within 1e-5 × max(|out|, 1), the gradients of x and of every
  weight within 1e-5 of their scale; ``impl="dense"`` against ``dense_ref``
  within 1e-5; ``impl="noc"`` with no mesh (the one-rank noc engine) against
  the reference's noc under the same mesh, on the four topologies.  The
  engines on meshes of many ranks are in tests/test_torch_moe_mesh.py.
* The models: forward, prefill + 4 decode logits and serve tokens under
  naive/blocked/flash at SMOKE (``moe_impl="dense"``), and the gather engine
  through the whole stack under the Auto-axis mesh, within 2e-3 ×
  max(|logit|, 1) with the stack's drops and peak equal; three train steps'
  loss within rtol 1e-4 and grad norm within rtol 1e-4 (qwen3-moe) or 5e-4
  (phi3.5-moe, its float32 noise), the reference's loss and grads taken
  under the mesh of its forward; the drops of a depth-1 phi3.5-moe run
  through ``loss``, the train CLI's ``--metrics`` and ``noc.moe.*``.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.noc import NoCConfig as JNoCConfig  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.launch.mesh import make_host_mesh, set_mesh  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import ALL_ARCHS  # noqa: E402
from repro_torch.configs import get_config as torch_config  # noqa: E402
from repro_torch.core.noc import NoCConfig as TNoCConfig  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.telemetry import MetricsRegistry  # noqa: E402
from tests import torch_lm_oracle as O  # noqa: E402

ARCHS = ["phi3.5-moe-42b-a6.6b", "qwen3-moe-235b-a22b"]
IMPLS = ["naive", "blocked", "flash"]


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Keep this file's CPU load small beside the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _mcfgs(E=8, k=2, d=16, f=24, depth=0, **kw):
    jn = JNoCConfig(flit_buffer_depth=depth) if depth else None
    tn = TNoCConfig(flit_buffer_depth=depth) if depth else None
    return JM.MoEConfig(d, E, k, f, noc=jn, **kw), TM.MoEConfig(d, E, k, f, noc=tn, **kw)


# -- capacity and stats, exactly ----------------------------------------------------

@pytest.mark.parametrize("tokens", [1, 2, 4, 16, 33, 64, 1000])
@pytest.mark.parametrize("kw", [dict(capacity_factor=1.0), dict(capacity_factor=100.0),
                                dict(capacity_factor=1.25, k=1), dict(depth=1),
                                dict(depth=3), dict(depth=100, E=4, k=2)])
def test_dispatch_capacity_matches_reference(tokens, kw):
    jc, tc = _mcfgs(**kw)
    assert TM.dispatch_capacity(tokens, tc) == JM.dispatch_capacity(tokens, jc)
    assert TM.effective_capacity_factor(tokens, tc) == JM.effective_capacity_factor(tokens, jc)


def test_dispatch_capacity_cases_of_the_reference():
    """tests/test_moe_noc.py:30, against the port."""
    c = TM.MoEConfig(d_model=8, n_experts=8, top_k=2, d_ff=16, capacity_factor=1.0)
    assert TM.dispatch_capacity(64, c) == 64 * 2 * 1.0 / 8
    assert TM.dispatch_capacity(16, c) == 8       # the floor of 8 slots
    assert TM.dispatch_capacity(2, c) == 2 * 2    # ... clamped to every packet
    big = TM.MoEConfig(8, 8, 2, 16, capacity_factor=100.0)
    assert TM.dispatch_capacity(4, big) == 4 * 2
    cd = TM.MoEConfig(8, 8, 2, 16, capacity_factor=1.0, noc=TNoCConfig(flit_buffer_depth=3))
    assert TM.dispatch_capacity(16, cd) == 3
    assert TM.effective_capacity_factor(16, cd) == 3 * 8 / (16 * 2)
    assert TM.effective_capacity_factor(64, c) == 1.0
    assert TM.effective_capacity_factor(16, c) == 2.0


def test_moe_stats_as_dict_fields():
    kw = dict(engine="gather", topology=None, fallback=None, capacity=4, capacity_factor=1.0,
              flits=0, rounds=0, link_bytes=0, drops=2, peak_occupancy=5)
    assert TM.MoEDispatchStats(**kw).as_dict() == JM.MoEDispatchStats(**kw).as_dict()


def test_moe_stats_publish_to_the_registry():
    reg = MetricsRegistry()
    TM.MoEDispatchStats("gather", None, None, 4, 1.0, 0, 0, 0, torch.tensor(3),
                        torch.tensor(7)).publish(reg)
    snap = reg.snapshot()
    assert snap["counters"]["noc.moe.drops{engine=gather}"] == 3
    assert snap["gauges"]["noc.moe.peak_occupancy{engine=gather}"] == 7
    assert snap["gauges"]["noc.moe.capacity{engine=gather}"] == 4


@pytest.mark.parametrize("n_blocks", [1, 2])
@pytest.mark.parametrize("cap", [1, 3, 8, 40])
def test_dispatch_slots_match_reference(n_blocks, cap):
    rng = np.random.default_rng(cap + n_blocks)
    E, P = 8, 64
    dst = rng.integers(0, E, P).astype(np.int32)
    blk = rng.integers(0, n_blocks, P).astype(np.int32)
    js, jv = JM._dispatch_slots(jnp.asarray(dst), jnp.asarray(blk), jnp.arange(E), n_blocks, cap)
    ts, tv = TM._dispatch_slots(torch.as_tensor(dst).long(), torch.as_tensor(blk).long(), E,
                                n_blocks, cap)
    js, jv = np.asarray(js), np.asarray(jv)
    assert tv.shape == (E, n_blocks, cap) and np.array_equal(tv.numpy(), jv)
    assert np.array_equal(ts.numpy()[jv], js[jv])
    jc = np.asarray(JM._dispatch_counts(jnp.asarray(dst), jnp.asarray(blk), E, n_blocks))
    tc = TM._dispatch_counts(torch.as_tensor(dst).long(), torch.as_tensor(blk).long(), E,
                             n_blocks)
    assert np.array_equal(tc.numpy(), jc)
    for n_ranks in (1, 2, 4):
        jd, jp = JM._drops_and_peak(jnp.asarray(jc), cap, n_ranks)
        td, tp = TM._drops_and_peak(tc, cap, n_ranks)
        assert (int(td), int(tp)) == (int(jd), int(jp))


@pytest.mark.parametrize("n_ranks", [2, 4])
@pytest.mark.parametrize("cap", [1, 3, 8])
def test_dispatch_slots_of_a_ranks_experts_match_reference(n_ranks, cap):
    """The multi-rank gather engine's dispatch: rank r's experts ``r·epr +
    arange(epr)`` over two source blocks, the reference's slots exactly."""
    rng = np.random.default_rng(10 * n_ranks + cap)
    E, P = 8, 64
    dst = rng.integers(0, E, P).astype(np.int32)
    blk = rng.integers(0, 2, P).astype(np.int32)
    epr = E // n_ranks
    for r in range(n_ranks):
        ids = r * epr + np.arange(epr)
        js, jv = JM._dispatch_slots(jnp.asarray(dst), jnp.asarray(blk), jnp.asarray(ids), 2, cap)
        ts, tv = TM._dispatch_slots(torch.as_tensor(dst).long(), torch.as_tensor(blk).long(),
                                    torch.as_tensor(ids), 2, cap)
        js, jv = np.asarray(js), np.asarray(jv)
        assert tv.shape == (epr, 2, cap) and np.array_equal(tv.numpy(), jv)
        assert np.array_equal(ts.numpy()[jv], js[jv])


# -- the layer ------------------------------------------------------------------------

T_B, T_S = 2, 16


@pytest.fixture(scope="module")
def layer():
    """Weights and input of one MoE layer (numpy): 8 experts top-2, d 16."""
    rng = np.random.default_rng(0)
    E, d, f = 8, 16, 24
    return {"router": (rng.normal(size=(d, E)) * 0.5).astype(np.float32),
            "gate": (rng.normal(size=(E, d, f)) / 4).astype(np.float32),
            "up": (rng.normal(size=(E, d, f)) / 4).astype(np.float32),
            "down": (rng.normal(size=(E, f, d)) / 5).astype(np.float32),
            "x": rng.normal(size=(T_B, T_S, d)).astype(np.float32),
            "r": rng.normal(size=(T_B, T_S, d)).astype(np.float32)}


def _weights(layer):
    return {k: v for k, v in layer.items() if k not in ("x", "r")}


def _close(a, b, tol=1e-5):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape
    err = np.abs(a - b).max()
    assert err <= tol * max(1.0, float(np.abs(b).max())), err


def _jax_engine(layer, jc):
    """The reference's engine (``jc.impl``) under the Auto-axis mesh: out,
    aux, stats, and the gradients of <out, r> + aux."""
    w = {k: jnp.asarray(v) for k, v in _weights(layer).items()}
    x, r = jnp.asarray(layer["x"]), jnp.asarray(layer["r"])

    traced = []     # the stats as traced: their static fields are plain values

    def f(w, x):
        out, aux, st = JM.moe_apply(w, x, jc)
        traced.append(dataclasses.replace(st, drops=None, peak_occupancy=None))
        return jnp.sum(out * r) + aux, (out, aux, st.drops, st.peak_occupancy)

    with set_mesh(O.auto_mesh()):
        (_, (out, aux, drops, peak)), grads = jax.jit(jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True))(w, x)
    return out, aux, traced[0], int(drops), int(peak), grads


def _torch_apply(layer, tc):
    w = {k: torch.as_tensor(v).requires_grad_() for k, v in _weights(layer).items()}
    x = torch.as_tensor(layer["x"]).requires_grad_()
    out, aux, st = TM.moe_apply(w, x, tc)
    ((out * torch.as_tensor(layer["r"])).sum() + aux).backward()
    return out.detach(), aux.detach(), st, ({k: v.grad for k, v in w.items()}, x.grad)


@pytest.mark.parametrize("depth", [1, 2, 0])
def test_gather_matches_reference_engine(layer, depth):
    jc, tc = _mcfgs(depth=depth, impl="gather")
    jout, jaux, jst, jdrops, jpeak, (jgw, jgx) = _jax_engine(layer, jc)
    out, aux, st, (gw, gx) = _torch_apply(layer, tc)
    T = T_B * T_S
    cap = TM.dispatch_capacity(T, tc)
    assert st.engine == "gather" and jst.engine == "gather" and st.capacity == cap
    assert dict(st.as_dict(), drops=None, peak_occupancy=None) == jst.as_dict()
    assert (int(st.drops), int(st.peak_occupancy)) == (jdrops, jpeak)
    if depth:
        assert jdrops > 0      # depth 1 and 2 drop at T=32, k=2, E=8
    _close(out, jout)
    assert abs(float(aux) - float(jaux)) <= 1e-6 * max(1.0, abs(float(jaux)))
    _close(gx, jgx)
    for k in gw:
        _close(gw[k], jgw[k])
    # the same routing, the same kept packets, the same tokens left with no expert
    x_flat = layer["x"].reshape(T, -1)
    _, jidx, _, _ = JM._router(jnp.asarray(x_flat), jnp.asarray(layer["router"]), jc)
    _, tidx, _, _ = TM._router(torch.as_tensor(x_flat), torch.as_tensor(layer["router"]), tc)
    assert np.array_equal(tidx.numpy(), np.asarray(jidx))
    flat = np.asarray(jidx).reshape(-1)
    js, jv = JM._dispatch_slots(jnp.asarray(flat), jnp.zeros_like(jnp.asarray(flat)),
                                jnp.arange(8), 1, cap)
    ts, tv = TM._dispatch_slots(torch.tensor(flat).long(), torch.zeros(flat.size).long(),
                                8, 1, cap)
    kept_j = set(np.asarray(js)[np.asarray(jv)].tolist())
    kept_t = set(ts[tv].tolist())
    assert kept_t == kept_j and len(kept_t) == flat.size - jdrops
    orphan = sorted(set(range(T)) - {p // 2 for p in kept_t})
    jrows = np.abs(np.asarray(jout).reshape(T, -1)).max(1)
    trows = out.reshape(T, -1).abs().amax(1).numpy()
    assert np.flatnonzero(trows == 0).tolist() == np.flatnonzero(jrows == 0).tolist() == orphan


def test_gather_without_drops_equals_dense(layer):
    """With room for every packet the gather engine computes dense_ref's sum."""
    _, tc = _mcfgs(capacity_factor=100.0, impl="gather")
    out, aux, st, _ = _torch_apply(layer, tc)
    dense, daux, dst, _ = _torch_apply(layer, TM.MoEConfig(16, 8, 2, 24, impl="dense"))
    assert int(st.drops) == 0 and dst.engine == "dense" and dst.capacity == 0
    _close(out, dense)
    assert float(aux) == float(daux)


def test_dense_matches_dense_ref(layer):
    jc, tc = _mcfgs(impl="dense")
    jout, jaux = JM.dense_ref({k: jnp.asarray(v) for k, v in _weights(layer).items()},
                              jnp.asarray(layer["x"]), jc)
    out, aux, st, _ = _torch_apply(layer, tc)
    assert st.as_dict() == JM.moe_apply(
        {k: jnp.asarray(v) for k, v in _weights(layer).items()}, jnp.asarray(layer["x"]),
        jc)[2].as_dict()
    _close(out, jout)
    assert abs(float(aux) - float(jaux)) <= 1e-6 * max(1.0, abs(float(jaux)))


def test_router_keeps_the_activation_dtype(layer):
    """bf16 operands, float32 logits; weights come back in x's dtype and the
    cotangent reaching x stays bf16."""
    _, tc = _mcfgs()
    x = torch.as_tensor(layer["x"].reshape(-1, 16)).bfloat16().requires_grad_()
    w, idx, aux, (me, ce) = TM._router(x, torch.as_tensor(layer["router"]), tc)
    assert w.dtype == torch.bfloat16 and me.dtype == torch.float32 and idx.shape == (32, 2)
    (w.float().sum() + aux).backward()
    assert x.grad.dtype == torch.bfloat16


@pytest.mark.parametrize("topo", ["fattree", "ring", "mesh2d", "torus2d"])
def test_noc_engine_waits_for_the_mesh(layer, topo):
    """With no mesh, ``impl="noc"`` runs the one-rank noc engine (the cube
    stays local): the reference's noc under the one-device Auto-axis mesh,
    stats, drops, peak, outputs and gradients (depth 2, so packets drop).
    An unknown impl raises."""
    jc, tc = _mcfgs(depth=2, impl="noc", noc_topology=topo)
    jout, jaux, jst, jdrops, jpeak, (jgw, jgx) = _jax_engine(layer, jc)
    out, aux, st, (gw, gx) = _torch_apply(layer, tc)
    assert st.engine == jst.engine == "noc" and st.topology == topo
    assert dict(st.as_dict(), drops=None, peak_occupancy=None) == jst.as_dict()
    assert (int(st.drops), int(st.peak_occupancy)) == (jdrops, jpeak) and jdrops > 0
    _close(out, jout)
    assert abs(float(aux) - float(jaux)) <= 1e-6 * max(1.0, abs(float(jaux)))
    _close(gx, jgx)
    for k in gw:
        _close(gw[k], jgw[k])
    with pytest.raises(ValueError):
        _torch_apply(layer, _mcfgs(impl="ring")[1])


# -- the models -----------------------------------------------------------------------

@pytest.fixture(scope="module")
def params():
    done = {}

    def get(arch):
        if arch not in done:
            done[arch] = O.ref_params(arch)
        return done[arch]
    return get


@pytest.fixture(scope="module")
def reference(params):
    """(arch, impl, depth) → the reference's logits and stack stats; depth
    None is the SMOKE config (moe_impl="dense"), otherwise the gather engine
    at that flit buffer depth under the Auto-axis mesh."""
    done = {}

    def get(arch, impl, depth=None):
        key = (arch, impl, depth)
        if key not in done:
            kw = {} if depth is None else dict(moe_impl="gather", moe_flit_buffer_depth=depth)
            jcfg, _ = O.cfgs(arch, impl, **kw)
            done[key] = O.jax_logits(params(arch), jcfg, O.inputs(jcfg),
                                     None if depth is None else O.auto_mesh())
        return done[key]
    return get


def test_moe_archs_registered():
    for arch in ARCHS:
        assert arch in ALL_ARCHS
        cfg = torch_config(arch)
        assert cfg.active_param_count() < cfg.param_count()


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_match_reference(arch, impl, params, reference):
    _, tcfg = O.cfgs(arch, impl)
    full_j, serve_j, st_j = reference(arch, impl)
    full_t, serve_t, st_t = O.torch_logits(params(arch), tcfg, O.inputs(tcfg))
    assert full_t.shape == (O.B, O.S, tcfg.vocab)
    assert np.abs(full_t - full_j).max() < O.tol(full_j)
    assert np.abs(serve_t - serve_j).max() < O.tol(full_j)
    assert st_t == st_j == {"moe_drops": 0, "moe_peak_occupancy": 0}


@pytest.mark.parametrize("arch,depth", [("phi3.5-moe-42b-a6.6b", 1), ("qwen3-moe-235b-a22b", 2),
                                        ("qwen3-moe-235b-a22b", 0)])
def test_gather_stack_matches_reference_under_its_mesh(arch, depth, params, reference):
    _, tcfg = O.cfgs(arch, "naive", moe_impl="gather", moe_flit_buffer_depth=depth)
    full_j, serve_j, st_j = reference(arch, "naive", depth)
    full_t, serve_t, st_t = O.torch_logits(params(arch), tcfg, O.inputs(tcfg))
    assert np.abs(full_t - full_j).max() < O.tol(full_j)
    assert np.abs(serve_t - serve_j).max() < O.tol(full_j)
    assert st_t == st_j and st_t["moe_peak_occupancy"] == O.B * O.S * tcfg.top_k
    if depth:
        assert st_t["moe_drops"] > 0


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_batch_tokens_equal_reference(arch, impl, params):
    """The reference's serve_batch (under its host mesh, SMOKE's dense MoE)
    against the port's; with a cache flash takes the plain path, so the
    port's flash tokens are held to the reference's naive ones."""
    jcfg, _ = O.cfgs(arch, "naive" if impl == "flash" else impl)
    _, tcfg = O.cfgs(arch, impl)
    prompts = np.random.default_rng(5).integers(0, jcfg.vocab, (O.B, O.PRE)).astype(np.int32)
    want = jserve.serve_batch(jax.tree.map(jnp.asarray, params(arch)), jcfg, prompts, 4,
                              make_host_mesh())
    got = tserve.serve_batch(convert.model_params_to_torch(params(arch), "cpu"), tcfg,
                             prompts, 4, device="cpu")
    assert np.array_equal(got, np.asarray(want))


def test_gather_serve_tokens_equal_reference(params):
    arch = "qwen3-moe-235b-a22b"
    jcfg, tcfg = O.cfgs(arch, "naive", moe_impl="gather", moe_flit_buffer_depth=2)
    prompts = np.random.default_rng(6).integers(0, jcfg.vocab, (O.B, O.PRE)).astype(np.int32)
    want = O.jax_greedy(params(arch), jcfg, prompts, 4, O.auto_mesh())
    got = tserve.serve_batch(convert.model_params_to_torch(params(arch), "cpu"), tcfg,
                             prompts, 4, device="cpu")
    assert np.array_equal(got, want)


@pytest.mark.parametrize("arch,kw", [
    ("phi3.5-moe-42b-a6.6b", {}), ("qwen3-moe-235b-a22b", {}),
    ("phi3.5-moe-42b-a6.6b", dict(moe_impl="gather", moe_flit_buffer_depth=1)),
    ("qwen3-moe-235b-a22b", dict(moe_impl="gather"))])
def test_train_steps_match_reference(arch, kw, params):
    """qwen3-moe's grad norm within rtol 1e-4 (measured 1.2e-7); phi3.5-moe's
    within 5e-4, its float32 noise: at the second step the two packages'
    grad norms differ by 1.03e-4 (7.4e-5 with the gather engine), and the
    reference's embedding gradient is 2.4e-4 off a float64 run of the port
    where the port's float32 one is 1.2e-7 off it."""
    jcfg, tcfg = O.cfgs(arch, "naive", **kw)
    states, mets = O.jax_train(params(arch), jcfg, O.auto_mesh() if kw else None)
    got = O.check_train_steps(tcfg, states, mets,
                              gnorm_rtol=5e-4 if arch.startswith("phi") else 1e-4)
    assert all(m["aux"] > 0 for m in got)
    if kw.get("moe_flit_buffer_depth") == 1:
        assert all(m["moe_drops"] > 0 for m in got)


def test_drops_reach_loss_and_the_train_cli(params, capsys, monkeypatch):
    """The one-rank counterpart of tests/test_moe_noc.py:227: a depth-1
    phi3.5-moe run drops packets, and the drops reach ``loss``, the train
    CLI's --metrics snapshot and the noc.moe.* names."""
    arch = "phi3.5-moe-42b-a6.6b"
    _, tcfg = O.cfgs(arch, "naive", moe_impl="gather", moe_flit_buffer_depth=1)
    p = convert.model_params_to_torch(params(arch), "cpu")
    _, mets = TT.loss(p, O._tbatch(O.train_batch(tcfg, 0)), tcfg)
    assert float(mets["moe_drops"]) > 0 and float(mets["moe_peak_occupancy"]) > 0
    assert mets["moe_drops"].dtype == torch.float32
    orig = ttrain.get_config
    monkeypatch.setattr(ttrain, "get_config", lambda a, smoke=False: orig(a, smoke).replace(
        moe_impl="gather", moe_flit_buffer_depth=1))
    ttrain.run(["--arch", arch, "--smoke", "--steps", "2", "--batch", "4", "--seq", "16",
                "--device", "cpu", "--metrics", "-", "--log-every", "100"])
    out = capsys.readouterr().out
    snap = json.loads(out[out.index("{"):])
    assert snap["counters"]["noc.moe.drops"] > 0
    assert snap["gauges"]["noc.moe.peak_occupancy"] == 4 * 16 * 2


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_follows_reference(arch):
    O.check_param_tree(arch)
