"""Device-mesh execution of the port (``mode="spmd"``, the route programs on a
mesh, the bridged lowering, ``bmvm.iterate_spmd``) against the reference, on
the CPU over gloo.

The ranks run in spawned gloo worlds (`tests/torch_spmd_worlds.py`), each
rank single-threaded, joined through a ``FileStore``: one world of 8 runs
every scenario, started when the module's first test starts, while the
reference's results are computed, and two worlds of 2 fail on purpose.
Every rank must return the same result.  The parent holds the results
against the reference in process: its ``mode="sim"`` (which
``tests/test_spmd_engine.py`` holds equal to its own ``spmd``),
``software_ref`` and the transpose.  The reference's
12-node cases run at 8 nodes here (the host has 8 cores)."""
import functools
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro.apps import bmvm as jbmvm  # noqa: E402
from repro.apps import ldpc as jldpc  # noqa: E402
from repro.apps import particle_filter as jpf  # noqa: E402
from repro_torch.apps import bmvm as tbmvm  # noqa: E402
from repro_torch.apps import particle_filter as tpf  # noqa: E402
from repro_torch.telemetry import Tracer  # noqa: E402
from tests import torch_spmd_worlds as W  # noqa: E402

TOPOLOGIES = list(W.TOPOLOGIES)
CPU = "cpu"
LDPC_CUTS = [(0,) * 4 + (1,) * 4, (0, 1) * 4, (0, 0, 1, 1, 2, 2, 3, 3)]
HALVES_AND_INTERLEAVED = [(0,) * 4 + (1,) * 4, (0, 1) * 4]


@pytest.fixture(scope="module", autouse=True)
def main_world(tmp_path_factory):
    """The world of 8 that runs every scenario, started before the module's
    first test; the reference's results are computed while it runs."""
    w = W.World("main", 8, tmp_path_factory.mktemp("main"))
    _compute_references()
    yield w
    w.close()


@pytest.fixture(scope="module")
def world(main_world):
    """world(name): scenario ``name``'s result, held equal on all 8 ranks."""
    return lambda name: W.one_result(main_world)[name]


@pytest.fixture(scope="module")
def failing_worlds(tmp_path_factory):
    """Two worlds of 2 in which rank 1 raises or hangs, started together."""
    started = {how: W.World("fail", 2, tmp_path_factory.mktemp(how), args=(how,),
                            timeout=30.0, pg_timeout=2.0)
               for how in ("raises", "hangs")}
    yield started
    for w in started.values():
        w.close()


# -- the reference's results, each computed once ------------------------------------

@functools.lru_cache(maxsize=None)
def _jdiamond():
    """One reference diamond for every case: its PE bodies are jitted once."""
    return W.diamond(jcore)


@functools.lru_cache(maxsize=None)
def _ref_diamond(name, seed):
    """The reference's sim (run, run_batch) and direct run of a diamond case."""
    placement, pods = W.diamond_case(seed)
    g = _jdiamond()
    ex = jcore.NoCExecutor(g, jcore.make_topology(name, 6), placement=placement,
                           plan=jcore.cut(g, placement, pods))
    x = {"src.x": jnp.asarray(W.DIAMOND_X)}
    sim, st = ex.run(x, mode="sim")
    bsim, stb = ex.run_batch({"src.x": W.DIAMOND_BATCH}, mode="sim")
    return sim, st.as_dict(), bsim, stb.as_dict(), g.run(x)


@functools.lru_cache(maxsize=None)
def _ref_bmvm(name, pods=None):
    A, v = W.bmvm_inputs()
    cfg = jbmvm.BMVMConfig(n=64, k=8, fold=2)
    out, st = jbmvm.iterate_noc_sim(jbmvm.preprocess(A, cfg), v, cfg, 3, topology=name,
                                    pods=None if pods is None else list(pods))
    return np.asarray(out), st.as_dict()


@functools.lru_cache(maxsize=None)
def _ref_ldpc(name, pods=None):
    bits, post, st = jldpc.decode_on_noc(jldpc.fano_plane_H(), W.ldpc_llr(), 5, topology=name,
                                         n_nodes=8, pods=None if pods is None else list(pods))
    return np.asarray(bits), np.asarray(post), st.as_dict()


@functools.lru_cache(maxsize=None)
def _ref_pf(name, pods=None):
    """The port's sim tracks (the port draws its motion noise from its own
    seed) and the reference's NoCStats."""
    cfg, frames = W.pf_inputs()
    pods = None if pods is None else list(pods)
    c_sim, _ = tpf.track_on_noc(frames, cfg, n_pe=4, topology=name, n_nodes=8, pods=pods,
                                device=CPU)
    jcfg = jpf.PFConfig(img=64, roi=16, n_particles=64, n_bins=16)
    _, st_j = jpf.track_on_noc(frames, jcfg, n_pe=4, topology=name, n_nodes=8, pods=pods)
    return c_sim, st_j.as_dict()


@functools.lru_cache(maxsize=None)
def _ref_trace():
    """The port's traced sim run of BMVM n=64 on the mesh: NoCStats and events."""
    A, v = W.bmvm_inputs()
    cfg = tbmvm.BMVMConfig(n=64, k=8, fold=2)
    tracer = Tracer()
    _, st = tbmvm.iterate_noc_sim(tbmvm.preprocess(A, cfg, device=CPU), v, cfg, 2,
                                  topology="mesh", tracer=tracer, device=CPU)
    return st.as_dict(), [(e.ts, e.name, e.track, e.kind, e.dur, e.value,
                           {k: a for k, a in (e.args or {}).items() if k != "mode"})
                          for e in tracer.events()]


def _compute_references():
    for name in TOPOLOGIES:
        for seed in (0, 1, 2):
            _ref_diamond(name, seed)
        _ref_bmvm(name), _ref_ldpc(name), _ref_pf(name)
    for name in ("mesh", "ring", "fattree"):
        for pods in LDPC_CUTS:
            _ref_ldpc(name, pods)
    for pods in HALVES_AND_INTERLEAVED:
        for name in ("mesh", "torus"):
            _ref_bmvm(name, pods)
        for name in ("mesh", "fattree"):
            _ref_pf(name, pods)
    _ref_trace()


def _assert_outputs_equal(got: dict, want: dict, what):
    assert got.keys() == set(want), what
    for k, v in want.items():
        assert np.array_equal(got[k], np.asarray(v)), (what, k)


# -- the executor: mode="spmd" == the reference's mode="sim" ----------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", TOPOLOGIES)
def test_spmd_executor_diamond_all_topologies(world, name, seed):
    """test_spmd_engine.py:140 — random placement, 2-pod cut, run and
    run_batch, 6 nodes on 8 ranks: outputs and NoCStats equal the
    reference's sim (and direct)."""
    sim, st_sim, bsim, stb_sim, direct = _ref_diamond(name, seed)
    out, st, bout, stb = world("executor")[("diamond", name, seed)]
    _assert_outputs_equal(out, sim, (name, seed))
    _assert_outputs_equal(out, direct, (name, seed))
    assert st == st_sim
    _assert_outputs_equal(bout, bsim, (name, seed, "batch"))
    assert stb == stb_sim


@pytest.mark.parametrize("name", TOPOLOGIES)
def test_spmd_differential_bmvm(world, name):
    """test_spmd_engine.py:197 — BMVM n=64 (4 PEs on 8 nodes), r=3."""
    A, v = W.bmvm_inputs()
    out_sim, st_sim = _ref_bmvm(name)
    out, st = world("executor")[("bmvm", name)]
    assert np.array_equal(out, out_sim)
    assert np.array_equal(out.reshape(1, -1), jbmvm.software_ref(A, v[None], 3))
    assert st == st_sim


@pytest.mark.parametrize("name", TOPOLOGIES)
def test_spmd_differential_ldpc(world, name):
    """test_spmd_engine.py:222 — the Fano LDPC, 5 iterations on 8 nodes."""
    bits_sim, post_sim, st_sim = _ref_ldpc(name)
    bits, post, st = world("executor")[("ldpc", name)]
    assert np.array_equal(bits, bits_sim) and np.array_equal(post, post_sim)
    assert st == st_sim


@pytest.mark.parametrize("name", TOPOLOGIES)
def test_spmd_differential_particle_filter(world, name):
    """test_spmd_engine.py:245 — the PF NoC (4 PEs on 8 nodes), 4 frames:
    the tracks equal the port's sim, the NoCStats the reference's."""
    c_sim, st_j = _ref_pf(name)
    c, st = world("executor")[("pf", name)]
    assert np.array_equal(c, c_sim)
    assert st == st_j


def test_spmd_trace_matches_sim_trace(world):
    """A traced spmd run: trace_stats folds back into its NoCStats, and the
    events are the traced sim run's, event for event (but the mode)."""
    st_sim, events_sim = _ref_trace()
    st, folded, events = world("executor")["traced"]
    assert st == folded == st_sim
    assert events == events_sim


# -- partitioned: mode="spmd" under a plan == the reference's partitioned sim -------------

@pytest.mark.parametrize("pods", LDPC_CUTS)
@pytest.mark.parametrize("name", ["mesh", "ring", "fattree"])
def test_spmd_partitioned_differential_ldpc(world, name, pods):
    """test_interchip.py:487 — outputs and NoCStats (bridge counters
    included) equal the reference's partitioned sim; outputs and the
    non-bridge counters equal its uncut run."""
    _, ref_post, ref_st = _ref_ldpc(name)
    _, post_s, st_s = _ref_ldpc(name, pods)
    bits, post, st = world("partitioned")[("ldpc", name, pods)]
    assert np.array_equal(post, post_s) and np.array_equal(post, ref_post)
    assert st == st_s and st["bridge_beats"] > 0
    for k, val in ref_st.items():
        if not k.startswith(("bridge_", "cross_pod_")):
            assert st[k] == val, (name, pods, k)


@pytest.mark.parametrize("pods", HALVES_AND_INTERLEAVED)
@pytest.mark.parametrize("name", ["mesh", "torus"])
def test_spmd_partitioned_differential_bmvm(world, name, pods):
    """test_interchip.py:520."""
    A, v = W.bmvm_inputs()
    out_s, st_s = _ref_bmvm(name, pods)
    out, st = world("partitioned")[("bmvm", name, pods)]
    assert np.array_equal(out, out_s)
    assert np.array_equal(out.reshape(1, -1), jbmvm.software_ref(A, v[None], 3))
    assert st == st_s


@pytest.mark.parametrize("pods", HALVES_AND_INTERLEAVED)
@pytest.mark.parametrize("name", ["mesh", "fattree"])
def test_spmd_partitioned_differential_particle_filter(world, name, pods):
    """test_interchip.py:546 (tracks against the port's sim, as above)."""
    c_sim, st_j = _ref_pf(name, pods)
    c, st = world("partitioned")[("pf", name, pods)]
    assert np.array_equal(c, c_sim)
    assert st == st_j and st["bridge_beats"] > 0


# -- bmvm.iterate_spmd -----------------------------------------------------------------

@pytest.mark.parametrize("name", TOPOLOGIES)
def test_iterate_spmd_matches_software(world, name):
    """test_apps.py:134 (ring and fattree there; mesh and torus too here):
    A^3·V over 8 ranks, one LUT column block each, equals software_ref."""
    A, V = W.bmvm_spmd_inputs()
    assert np.array_equal(world("iterate_spmd")[name], jbmvm.software_ref(A, V, 3))


# -- route programs on the mesh --------------------------------------------------

@pytest.mark.parametrize("n", [4, 8])
@pytest.mark.parametrize("name", TOPOLOGIES)
def test_run_route_program_matches_transpose(world, name, n):
    """test_spmd_engine.py:108 — the compiled program on its own axes equals
    the transpose; 4 nodes run on half of the 8 ranks."""
    assert np.array_equal(world("routes")[("own", name, n)], W.route_cube(n).swapaxes(0, 1))


@pytest.mark.parametrize("n", [4, 8])
@pytest.mark.parametrize("name", TOPOLOGIES)
def test_linearized_route_program_matches_transpose(world, name, n):
    """test_moe_noc.py:66 — the same program over one flat ``model`` axis
    (float32 rows) equals the fused transpose."""
    flat = np.random.default_rng(n).normal(size=(n, n, 3)).astype(np.float32)
    got = world("routes")[("linearized", name, n)]
    assert got.dtype == np.float32 and np.array_equal(got, flat.swapaxes(0, 1))


@pytest.mark.parametrize("n", [4, 8])
@pytest.mark.parametrize("name", TOPOLOGIES)
def test_handwritten_schedules_match_transpose(world, name, n):
    """test_routing.py:35 — all_to_all_for's schedule and the fused
    transpose_oracle equal the transpose."""
    res = world("routes")
    want = W.route_cube(n).swapaxes(0, 1)
    assert np.array_equal(res[("schedule", name, n)], want)
    assert np.array_equal(res[("oracle", name, n)], want)


@pytest.mark.parametrize("pods", W.CUTS8)
@pytest.mark.parametrize("name", TOPOLOGIES)
def test_bridged_route_program_matches_transpose(world, name, pods):
    """test_interchip.py:445 — run_bridged_program over the blocked
    ``(pod, node)`` mesh and over irregular cuts equals the transpose."""
    res = world("routes")
    assert np.array_equal(res[("bridged", name, pods)], W.route_cube(8).swapaxes(0, 1))
    blocked = pods == (0,) * 4 + (1,) * 4
    axes = tcore.topology_axes(tcore.make_topology(name, 8))
    assert res[("bridged_axes", name, pods)] == (
        (("pod", "node"), (2, 4)) if blocked else
        (tuple(a for a, _ in axes), tuple(s for _, s in axes)))


# -- the errors --------------------------------------------------------------------

def test_mesh_needs_enough_ranks(world):
    """test_spmd_engine.py:290 and test_interchip.py:428: too few ranks, or
    no process group at all, fail fast with the torchrun hint."""
    msg = world("routes")["too_few"]
    assert "needs 16 ranks" in msg and "torchrun --nproc-per-node 16" in msg
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 64"):
        tcore.mesh_for_topology(tcore.make_topology("ring", 64))
    plan = tcore.PartitionPlan({}, (0, 0, 1, 1), (), ())
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 4"):
        tcore.mesh_for_partition(tcore.make_topology("ring", 4), plan)


def test_spmd_without_a_process_group_raises():
    g = W.diamond(tcore)
    ex = tcore.NoCExecutor(g, tcore.make_topology("mesh", 4), device=CPU)
    for call, x in ((ex.run, {"src.x": W.DIAMOND_X}), (ex.run_batch, {"src.x": W.DIAMOND_BATCH})):
        with pytest.raises(RuntimeError, match="no torch.distributed process group"):
            call(x, mode="spmd")


@pytest.mark.parametrize("name", TOPOLOGIES)
def test_transfer_requires_linearized_execution(name):
    """routing.py:276-285: transfer= without axis_name, or on a fused
    program, is an error before anything moves."""
    prog = tcore.compile_routes(tcore.make_topology(name, 4))
    x = torch.zeros((4, 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match="requires linearized execution"):
        tcore.run_route_program(x, prog, None, transfer=lambda b, p: b)
    if prog.fused:
        with pytest.raises(ValueError, match="not supported for fused programs"):
            tcore.run_route_program(x, prog, None, axis_name="noc", transfer=lambda b, p: b)


def test_placement_to_device_coords():
    """test_spmd_engine.py:269, against the reference's coordinates."""
    from repro.apps import ldpc as jl
    from repro_torch.apps import ldpc as tl

    gt, _ = tl.build_ldpc_graph(tl.fano_plane_H())
    gj, _ = jl.build_ldpc_graph(jl.fano_plane_H())
    topo_t, topo_j = tcore.make_topology("mesh", 16), jcore.make_topology("mesh", 16)
    placement = tcore.optimize_placement(gt, topo_t, iters=300, seed=0)
    assert placement == jcore.optimize_placement(gj, topo_j, iters=300, seed=0)
    coords = tcore.placement_to_device_coords(placement, topo_t)
    assert coords == jcore.placement_to_device_coords(placement, topo_j)
    for pe, node in placement.items():
        assert topo_t.node(coords[pe]["noc_x"], coords[pe]["noc_y"]) == node
    ring = tcore.make_topology("ring", 5)
    assert tcore.node_device_coords(ring, 3) == {"noc": 3}
    with pytest.raises(ValueError):
        tcore.node_device_coords(ring, 7)


# -- a rank that fails or hangs fails the world within its timeout ----------------------

@pytest.mark.parametrize("how", ["raises", "hangs"])
def test_a_failing_rank_fails_the_world(failing_worlds, how):
    """Rank 1 raises, or hangs while rank 0 waits on it in the ring's first
    hop: the world fails (rank 0's wait ends when its peer's connection
    closes or at the group's 2 s timeout), within its 30 s deadline, and no
    rank is left running."""
    w = failing_worlds[how]
    with pytest.raises((mp.ProcessRaisedException, mp.ProcessExitedException, TimeoutError)):
        w.results()
    assert time.monotonic() - w.t0 < 40.0
    assert not any(p.is_alive() for p in w.ctx.processes)
