"""The MoE layer on a device mesh (``impl="gather"`` and ``"noc"`` over
``(data, model)`` meshes of gloo ranks, the ambient mesh, the axis
collectives) against the JAX package, on the CPU.

One gloo world of 8 single-threaded ranks (`tests/torch_spmd_worlds.py`)
runs every port case (`tests/torch_moe_mesh_cases.py`) while one process with
8 fake CPU devices computes the reference's results; both read the same
seeded weights and inputs.  Every rank must return the same result.

* The oracles of tests/test_distributed.py:9 and :46 and tests/test_moe_noc.py
  :100, :140, :181 and :227 on (2, 4), (1, 4) and (1, 8) meshes: outputs
  within the reference tests' tolerances (1e-4 against dense, 1e-5 between
  engines, and 1e-5 against the reference's same engine); ``drops``,
  ``peak_occupancy``, ``capacity``, ``engine``, ``fallback``, ``rounds``,
  ``flits``, ``link_bytes`` and the warnings exactly equal to the reference's.
* With no mesh, the one-rank engines (``noc`` too) against the reference
  under a (1, 1) mesh with Auto axes.
* qwen3-moe SMOKE through ``loss`` and ``serve_batch(mesh=)`` on a (1, 4)
  mesh; the expert leaves cut by ``shard_params``; gradients through the
  engines on (1, 4) and (2, 4) meshes equal the one-rank engine's; the
  collectives over each axis set; the mesh factories' errors.
"""
import os
import pickle
import subprocess
import sys
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import routing as troute  # noqa: E402
from repro_torch.core.topology import make_topology  # noqa: E402
from repro_torch.core.noc import NoCConfig as TNoCConfig  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from tests import torch_moe_mesh_cases as C  # noqa: E402
from tests import torch_spmd_worlds as W  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = {name: (shape, w, x, dict(cfgs)) for name, shape, w, x, cfgs in C.cases()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference results, the port's common results, each rank's own)."""
    tmp = tmp_path_factory.mktemp("moe_mesh")
    inputs, out = str(tmp / "inputs.pkl"), str(tmp / "reference.pkl")
    C.write_inputs(inputs)
    world = W.World("moe_mesh", 8, tmp / "world", args=(inputs,), timeout=240.0)
    try:
        # 8 fake CPU devices, one XLA and one OpenMP thread (beside the ranks)
        env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
                   XLA_FLAGS="--xla_force_host_platform_device_count=8 "
                             "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1",
                   PYTHONPATH=os.pathsep.join([ROOT, os.path.join(ROOT, "src")]))
        run = subprocess.run([sys.executable, "-c", "from tests.torch_moe_mesh_cases import "
                              f"run_reference; run_reference({inputs!r}, {out!r})"],
                             capture_output=True, text=True, timeout=240, env=env)
        assert run.returncode == 0, f"the reference failed:\n{run.stdout}\n{run.stderr}"
        with open(out, "rb") as fh:
            ref = pickle.load(fh)
        res = world.results()
    finally:
        world.close()
    for r, other in enumerate(res[1:], 1):
        assert W.same(res[0]["same"], other["same"]), f"rank {r} differs from rank 0"
    with open(inputs, "rb") as fh:
        data = pickle.load(fh)
    return ref, res[0]["same"], [r["rank"] for r in res], data


def _err(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


def _same_as_reference(port, ref, tol=1e-5):
    """Stats and warnings exactly the reference's, the output within tol."""
    out, aux, st, msgs = port
    rout, raux, rst, rmsgs = ref
    assert st == rst
    assert msgs == rmsgs
    assert out.shape == rout.shape and _err(out, rout) < tol
    assert abs(aux - raux) < tol


# -- tests/test_distributed.py:9 and :46 ------------------------------------------------

@pytest.mark.parametrize("tag", ["gather"] + [f"noc-{t}" for t in C.TOPOS])
def test_engines_agree_across_mesh(runs, tag):
    """gather and noc on four topologies == dense on a (2, 4) mesh,
    drop-free at capacity_factor 8."""
    ref, port, _, _ = runs
    out, aux, st, _ = port[("engines", tag)]
    dense_out, dense_aux, _, _ = ref[("engines", "dense")]
    assert _err(out, dense_out) < 1e-4
    assert abs(aux - dense_aux) < 1e-4
    assert st["drops"] == 0 and st["fallback"] is None
    if tag.startswith("noc"):
        assert st["engine"] == "noc" and st["topology"] == tag[4:]
        assert st["rounds"] > 0 and st["flits"] > 0 and st["link_bytes"] > 0
    _same_as_reference(port[("engines", tag)], ref[("engines", tag)])
    assert _err(out, port[("engines", "gather")][0]) < 1e-5


def test_noc_ring_schedule(runs):
    ref, port, _, _ = runs
    out, _, st, _ = port[("ring", "noc-ring")]
    assert _err(out, ref[("ring", "dense")][0]) < 1e-4
    assert st["rounds"] == 2 * 3           # ring(4) unidirectional: 3 rounds out + 3 back
    _same_as_reference(port[("ring", "noc-ring")], ref[("ring", "noc-ring")])


# -- tests/test_moe_noc.py:100, :140, :181 ------------------------------------------------

@pytest.mark.parametrize("topo", C.TOPOS)
def test_noc_counters_match_route_program_stats(runs, topo):
    """(1, 8) mesh, flit buffer depth 4: rounds and link bytes are twice the
    compiled program's, flits frame all n^2 cubes twice."""
    ref, port, _, _ = runs
    _, _, st, _ = port[("counters", f"noc-{topo}")]
    n, E, d = 8, 16, 32
    prog = troute.compile_routes(make_topology(topo, n))
    msg = (E // n) * st["capacity"] * d * 4
    ss = troute.route_program_stats(prog, n * n * msg)
    assert st["rounds"] == 2 * ss.rounds and st["link_bytes"] == 2 * ss.link_bytes
    assert st["flits"] == 2 * n * n * TNoCConfig(flit_buffer_depth=4).flits_for(msg)
    assert st["capacity"] == 4 and st["engine"] == "noc"
    _same_as_reference(port[("counters", f"noc-{topo}")], ref[("counters", f"noc-{topo}")])


@pytest.mark.parametrize("depth", C.DEPTHS)
def test_capacity_parity_gather_vs_noc(runs, depth):
    """The same flit buffer depth drops the same tokens in both engines on a
    (2, 4) mesh; drops shrink with depth, and depth 8 drops none."""
    ref, port, _, _ = runs
    og, _, sg, _ = port[("parity", f"gather-{depth}")]
    on, _, sn, _ = port[("parity", f"noc-{depth}")]
    assert sg["capacity"] == sn["capacity"] == depth
    assert sg["drops"] == sn["drops"] and sg["peak_occupancy"] == sn["peak_occupancy"]
    assert _err(og, on) < 1e-5
    drops = [port[("parity", f"noc-{k}")][2]["drops"] for k in C.DEPTHS]
    assert drops == sorted(drops, reverse=True) and drops[-1] == 0 and drops[0] > 0
    for tag in (f"gather-{depth}", f"noc-{depth}"):
        _same_as_reference(port[("parity", tag)], ref[("parity", tag)])


@pytest.mark.parametrize("case,tag,engine,words", [
    ("fallback-experts", "gather", "dense", "not divisible"),
    ("fallback-decode", "noc", "gather", "decode-shaped"),
])
def test_fallback_reasons_and_warnings(runs, case, tag, engine, words):
    ref, port, _, _ = runs
    out, _, st, msgs = port[(case, tag)]
    assert st["engine"] == engine and words in st["fallback"]
    assert len(msgs) == 1 and words in msgs[0]
    _same_as_reference(port[(case, tag)], ref[(case, tag)])


def test_expert_leaves_hold_the_ranks_block(runs):
    _, port, _, _ = runs
    assert port[("engines", "expert-rows")] == 8 // 4
    assert port[("counters", "expert-rows")] == 16 // 8
    assert port[("fallback-experts", "expert-rows")] == 6       # E = 6 on 4 ranks: all of them


# -- no mesh: the one-rank engines --------------------------------------------------------

@pytest.mark.parametrize("tag", list(CASES["one-rank"][3]))
def test_one_rank_engines_equal_the_reference_on_one_device(runs, tag):
    """With no ambient mesh, gather and noc run on one rank with every expert
    local: the reference's engines under a (1, 1) Auto-axis mesh, stats
    included (noc: rounds 0, link bytes 0 but the fat-tree's fused round, the
    flits of the one cube out and back), with no warning."""
    ref, _, _, data = runs
    shape, (E, d, f, _), _, cfgs = CASES["one-rank"]
    w, x = data["one-rank"]
    got = C.port_apply(TM, C._torch(w), x, C.moe_cfg(TM, TNoCConfig, E, d, f, cfgs[tag]))
    assert got[2]["fallback"] is None and got[3] == []
    _same_as_reference(got, ref[("one-rank", tag)])
    if tag == "noc-torus2d":
        st = got[2]
        assert (st["engine"], st["rounds"], st["link_bytes"], st["flits"]) == ("noc", 0, 0, 8192)


# -- tests/test_moe_noc.py:227, serve_batch, gradients on a mesh --------------------------

def test_moe_stats_thread_through_transformer(runs):
    """qwen3-moe SMOKE on noc/mesh2d at depth 1 on a (1, 4) mesh: the loss
    within rtol 1e-4, and the stack's drops and peak equal to the reference's
    (nonzero)."""
    ref, port, _, _ = runs
    loss, mets = port["lm-loss"]
    rloss, rmets = ref["lm-loss"]
    assert np.isfinite(loss) and abs(loss - rloss) <= 1e-4 * abs(rloss)
    assert mets["moe_drops"] == rmets["moe_drops"] > 0
    assert mets["moe_peak_occupancy"] == rmets["moe_peak_occupancy"] > 0


def test_serve_batch_under_a_mesh(runs):
    """serve_batch(mesh=) on the (1, 4) mesh: the reference's tokens; the
    prefill takes noc and the decode steps demote to gather with its warning."""
    ref, port, _, _ = runs
    toks, msgs = port["lm-serve"]
    rtoks, rmsgs = ref["lm-serve"]
    assert toks.shape == (2, 4) and np.array_equal(toks, rtoks)
    assert msgs == rmsgs and len(msgs) == 1 and "decode-shaped" in msgs[0]


@pytest.mark.parametrize("impl", ["gather", "noc"])
@pytest.mark.parametrize("shape", C.GRAD_MESHES)
def test_grad_through_a_mesh_equals_the_one_rank_engine(runs, shape, impl):
    """Through the backward on a mesh, in the same world: the output and the
    gradients of x, the router and the rank's experts equal the one-rank
    engine's within 1e-5 x scale on every rank, drop free on both."""
    _, _, mine, _ = runs
    for rank, res in enumerate(mine):
        errs, drops, drops1 = res[("grad", shape, impl)]
        assert drops == drops1 == 0
        assert set(errs) == {"out", "x", "router", "gate", "up", "down"}
        assert max(errs.values()) < 1e-5, (rank, errs)


def test_shard_experts_cuts_each_ranks_block(runs):
    """Stacked (L, E, ...) leaves cut on the expert axis to rank r's block
    (rank r of each (1, 4) mesh: model coordinate r % 4)."""
    _, _, mine, data = runs
    moe = data["lm"][0]["blocks"]["0"]["moe"]
    for rank, got in enumerate(mine):
        for k in ("gate", "up", "down"):
            full = moe[k]
            epr = full.shape[1] // 4
            m = rank % 4
            assert np.array_equal(got[("lm-cut", k)], full[:, m * epr:(m + 1) * epr])


# -- the collectives and the mesh factories ----------------------------------------------

@pytest.mark.parametrize("names", [("data",), ("model",), ("data", "model"), ("model", "data")])
def test_axis_collectives(runs, names):
    """all_gather, psum, pmean and pmax over each axis set of the (2, 4) mesh
    (rank = 4·data + model), in the axis's order, on every rank."""
    _, _, mine, _ = runs
    rows = {r: np.arange(6, dtype=np.float32).reshape(2, 3) + 10 * r for r in range(8)}
    for rank, res in enumerate(mine):
        ranks, gathered, s, mean, mx = res[("coll", names)]
        d, m = divmod(rank, 4)
        want = {("data",): (m, m + 4), ("model",): tuple(range(4 * d, 4 * d + 4)),
                ("data", "model"): tuple(range(8)),
                ("model", "data"): tuple(r + 4 * dd for r in range(4) for dd in range(2))}
        assert ranks == want[names]
        stack = np.stack([rows[r] for r in ranks])
        assert np.array_equal(gathered, stack)
        assert np.allclose(s, stack.sum(0)) and np.allclose(mean, stack.mean(0))
        assert np.array_equal(mx, stack.max(0))


def test_all_to_all_over_a_row_of_the_mesh(runs):
    """all_to_all over ``model`` on the (2, 4) mesh runs in each row's own
    group: row d of rank r arrives at rank 4·(r // 4) + d as its row r % 4."""
    _, _, mine, _ = runs
    for rank, res in enumerate(mine):
        ranks, got = res["a2a-model"]
        for s, src in enumerate(ranks):
            want = np.arange(20, dtype=np.int32).reshape(4, 5)[rank % 4] + 100 * src
            assert np.array_equal(got[s], want)
        assert res["transport"]["calls"] > 0


def test_mesh_factories_raise_when_the_world_does_not_hold_them(runs):
    _, port, _, _ = runs
    host, prod, multi = port["mesh-errors"]
    assert host.startswith("ValueError") and "model=3" in host
    assert prod.startswith("ValueError") and "(16, 16)" in prod
    assert multi.startswith("ValueError") and "(2, 16, 16)" in multi


def test_no_mesh_without_a_process_group():
    """Without a mesh the ambient mesh is None; the factories need a group."""
    from repro_torch.core import collectives as coll

    assert coll.current_mesh() is None
    with pytest.raises(RuntimeError, match="join_process_group"):
        tmesh.make_host_mesh()
    with tmesh.set_mesh(None):
        assert coll.current_mesh() is None
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        x = torch.zeros(1, 4, 16)
        w = {k: torch.as_tensor(v) for k, v in C._layer(8, 16, 8, 0).items()}
        TM.moe_apply(w, x, TM.MoEConfig(16, 8, 2, 8, impl="noc"))
