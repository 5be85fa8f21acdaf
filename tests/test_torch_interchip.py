"""Partitioned execution of the port against the reference, on the CPU: the
compiled route programs, the pod cut and its bridges, the bridged simulator
and its analytic stats, the quasi-SERDES endpoints, the placement search and
pod-cut co-optimizer, and the three apps cut into pods.

The same seeded inputs go through ``repro`` and ``repro_torch``.  Everything
is compared exactly (``==``) except the int8 serdes path, whose decoded
values and residuals are held within 1e-6 x the block scale of the
reference's (its codes and every none/bf16 wire word are compared bit for
bit)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro.apps import bmvm as jbmvm  # noqa: E402
from repro.apps import ldpc as jldpc  # noqa: E402
from repro.apps import particle_filter as jpf  # noqa: E402
from repro.core import serdes as jserdes  # noqa: E402
from repro_torch.apps import bmvm as tbmvm  # noqa: E402
from repro_torch.apps import ldpc as tldpc  # noqa: E402
from repro_torch.apps import particle_filter as tpf  # noqa: E402
from repro_torch.core import interchip as tinter  # noqa: E402
from repro_torch.core import serdes as tserdes  # noqa: E402

TOPOLOGIES = ["ring", "mesh", "torus", "fattree"]
CPU = "cpu"


def _plans(pods, wire_bits=16, lanes=4):
    return (tcore.PartitionPlan({}, tuple(pods), (), (),
                                tcore.QuasiSerdesConfig(wire_bits=wire_bits, lanes=lanes)),
            jcore.PartitionPlan({}, tuple(pods), (), (),
                                jcore.QuasiSerdesConfig(wire_bits=wire_bits, lanes=lanes)))


def _pod_patterns(n):
    rng = np.random.default_rng(n)
    return {"halves": tuple(i // ((n + 1) // 2) for i in range(n)),
            "interleaved": tuple(i % 2 for i in range(n)),
            "random3": tuple(int(x) for x in rng.integers(0, 3, n))}


def _bridge_cfgs(wire_bits=16, lanes=2, fifo_depth=4):
    return (tcore.BridgeConfig(tcore.QuasiSerdesConfig(wire_bits=wire_bits, lanes=lanes),
                               fifo_depth),
            jcore.BridgeConfig(jcore.QuasiSerdesConfig(wire_bits=wire_bits, lanes=lanes),
                               fifo_depth))


def _fields(x):
    """A dataclass tree as plain tuples and dicts (compares across packages)."""
    if dataclasses.is_dataclass(x):
        return tuple((f.name, _fields(getattr(x, f.name))) for f in dataclasses.fields(x))
    if isinstance(x, (tuple, list)):
        return tuple(_fields(v) for v in x)
    if isinstance(x, dict):
        return {k: _fields(v) for k, v in x.items()}
    return x


# -- route programs ---------------------------------------------------------------

@pytest.mark.parametrize("name", TOPOLOGIES)
@pytest.mark.parametrize("n", [4, 6, 8, 9, 12, 16])
def test_compile_routes_matches_reference(name, n):
    tp = tcore.compile_routes(tcore.make_topology(name, n))
    jp = jcore.compile_routes(jcore.make_topology(name, n))
    assert _fields(tp) == _fields(jp)
    assert (tp.fused, tp.n_rounds) == (jp.fused, jp.n_rounds)
    assert tcore.topology_axes(tcore.make_topology(name, n)) == \
        jcore.topology_axes(jcore.make_topology(name, n))


@pytest.mark.parametrize("name", TOPOLOGIES)
@pytest.mark.parametrize("n,c", [(4, 1), (6, 3), (8, 2), (9, 5), (12, 1), (16, 4)])
def test_route_program_delivers_once_and_conserves_flits(name, n, c):
    """Exactly-once delivery (== transpose == the schedule simulator ==
    the reference's interpreter), flits conserved (the analytic stats count
    what the interpreter moves), and every hop a permutation of neighbours."""
    topo = tcore.make_topology(name, n)
    prog = tcore.compile_routes(topo)
    msgs = np.random.default_rng(n * 10 + c).integers(0, 255, (n, n, c), dtype=np.uint8)
    out, st = tcore.simulate_route_program(prog, torch.as_tensor(msgs))
    out_s, st_s = tcore.simulate_schedule(topo, torch.as_tensor(msgs))
    out_j, st_j = jcore.simulate_route_program(jcore.compile_routes(jcore.make_topology(name, n)),
                                               msgs)
    assert np.array_equal(out.numpy(), msgs.swapaxes(0, 1))
    assert torch.equal(out, out_s) and np.array_equal(out.numpy(), out_j)
    ana = tcore.route_program_stats(prog, msgs.nbytes)
    assert (st.rounds, st.link_bytes) == (st_s.rounds, st_s.link_bytes) == \
        (st_j.rounds, st_j.link_bytes) == (ana.rounds, ana.link_bytes)
    assert st.rounds == prog.n_rounds
    for phase in prog.phases:
        m = phase.sched.size
        for rnd in phase.rounds:
            for mv in rnd.moves:
                srcs, dsts = [s for s, _ in mv.perm], [d for _, d in mv.perm]
                assert len(set(srcs)) == len(srcs) and len(set(dsts)) == len(dsts)
                assert all(min(abs(s - d), m - abs(s - d)) == 1 or m == 2 for s, d in mv.perm)


# -- compile_bridges ------------------------------------------------------------------

@pytest.mark.parametrize("name", TOPOLOGIES)
@pytest.mark.parametrize("n", [4, 6, 8, 9, 12])
@pytest.mark.parametrize("pattern", ["halves", "interleaved", "random3"])
def test_compile_bridges_matches_reference(name, n, pattern):
    """Field for field: bridges, split rounds, per-pod programs, configs;
    and every physical traversal lands in exactly one pod's list or a bridge."""
    pods = _pod_patterns(n)[pattern]
    tplan, jplan = _plans(pods)
    tb = tcore.compile_bridges(tcore.compile_routes(tcore.make_topology(name, n)), tplan)
    jb = jcore.compile_bridges(jcore.compile_routes(jcore.make_topology(name, n)), jplan)
    assert _fields(tb) == _fields(jb)
    assert tb.n_pods == jb.n_pods == max(pods) + 1
    for rnd, (den, pairs) in zip(tb.rounds, tinter._walk_rounds(tb.prog)):
        split = list(rnd.intra) + [(tb.bridges[i].src, tb.bridges[i].dst) for i in rnd.cross]
        assert rnd.den == den and sorted(split) == sorted(pairs)


def test_compile_bridges_rejects_wrong_node_count():
    tplan, _ = _plans([0, 1])
    with pytest.raises(ValueError, match="plan covers"):
        tcore.compile_bridges(tcore.compile_routes(tcore.make_topology("ring", 6)), tplan)
    with pytest.raises(ValueError, match="fifo_depth"):
        tcore.BridgeConfig(fifo_depth=0)


# -- the bridged simulator ------------------------------------------------------------

@pytest.mark.parametrize("name", TOPOLOGIES)
@pytest.mark.parametrize("n,c", [(4, 1), (6, 3), (8, 9), (9, 2), (12, 5)])
@pytest.mark.parametrize("pattern", ["halves", "interleaved", "random3"])
def test_bridged_simulator_matches_reference(name, n, c, pattern):
    """Delivery and ScheduleStats bit-identical to the uncut program; the
    BridgeStats (per bridge included) equal to the reference's simulator and
    to the port's analytic stats."""
    pods = _pod_patterns(n)[pattern]
    msgs = np.random.default_rng(n * 100 + c).integers(0, 255, (n, n, c), dtype=np.uint8)
    tplan, jplan = _plans(pods)
    tcfg, jcfg = _bridge_cfgs()
    tb = tcore.compile_bridges(tcore.compile_routes(tcore.make_topology(name, n)), tplan, tcfg)
    jb = jcore.compile_bridges(jcore.compile_routes(jcore.make_topology(name, n)), jplan, jcfg)
    d, s, b = tcore.simulate_bridged_program(tb, torch.as_tensor(msgs))
    d_j, s_j, b_j = jcore.simulate_bridged_program(jb, msgs)
    d_u, s_u = tcore.simulate_route_program(tb.prog, torch.as_tensor(msgs))
    assert torch.equal(d, d_u) and np.array_equal(d.numpy(), d_j)
    assert (s.rounds, s.link_bytes) == (s_u.rounds, s_u.link_bytes) == (s_j.rounds, s_j.link_bytes)
    assert b.as_dict() == b_j.as_dict() == tcore.bridge_program_stats(tb, msgs.nbytes).as_dict()
    if tb.bridges:
        assert b.beats > 0 and b.wire_bytes > 0


@pytest.mark.parametrize("name", TOPOLOGIES)
def test_bridged_simulator_batched_matches_reference(name):
    rng = np.random.default_rng(7)
    msgs = rng.integers(0, 255, (3, 8, 8, 5), dtype=np.uint8)
    tplan, jplan = _plans([0] * 4 + [1] * 4)
    tb = tcore.compile_bridges(tcore.compile_routes(tcore.make_topology(name, 8)), tplan)
    jb = jcore.compile_bridges(jcore.compile_routes(jcore.make_topology(name, 8)), jplan)
    d, s, b = tcore.simulate_bridged_program(tb, torch.as_tensor(msgs), batched=True)
    d_j, s_j, b_j = jcore.simulate_bridged_program(jb, msgs, batched=True)
    assert np.array_equal(d.numpy(), msgs.swapaxes(1, 2)) and np.array_equal(d.numpy(), d_j)
    assert (s.rounds, s.link_bytes) == (s_j.rounds, s_j.link_bytes)
    assert b.as_dict() == b_j.as_dict()
    _, s1, _ = tcore.simulate_bridged_program(tb, torch.as_tensor(msgs[0]))
    assert s.rounds == s1.rounds and s.link_bytes == 3 * s1.link_bytes


@pytest.mark.parametrize("dtype", [np.float32, np.int16, np.uint32])
def test_non_uint8_payloads_roundtrip_through_bridges(dtype):
    """The wire framing works on the byte view, whatever the cube's dtype."""
    rng = np.random.default_rng(3)
    msgs = (rng.normal(size=(6, 6, 3)) * 1000).astype(dtype)
    tplan, jplan = _plans([0, 1, 0, 1, 0, 1])
    tb = tcore.compile_bridges(tcore.compile_routes(tcore.make_topology("mesh", 6)), tplan)
    jb = jcore.compile_bridges(jcore.compile_routes(jcore.make_topology("mesh", 6)), jplan)
    t = torch.as_tensor(msgs.view(np.int32) if dtype == np.uint32 else msgs)
    t = t.view(torch.uint32) if dtype == np.uint32 else t
    d, _, b = tcore.simulate_bridged_program(tb, t)
    d_j, _, b_j = jcore.simulate_bridged_program(jb, msgs)
    assert d.dtype == t.dtype
    got = d.view(torch.int32).numpy().view(np.uint32) if dtype == np.uint32 else d.numpy()
    assert np.array_equal(got, msgs.swapaxes(0, 1)) and np.array_equal(got, d_j)
    assert b.as_dict() == b_j.as_dict() and b.beats > 0


@pytest.mark.parametrize("depth", [1, 2, 8, 16, 64, 1024])
def test_bridge_fifo_model_matches_reference(depth):
    """FIFO depth bounds the peak occupancy and moves stalls between
    back-pressure and the terminal drain, exactly as in the reference."""
    msgs = np.zeros((4, 4, 10), np.uint8)
    tplan, jplan = _plans([0, 0, 1, 1])
    tcfg, jcfg = _bridge_cfgs(fifo_depth=depth)
    tb = tcore.compile_bridges(tcore.compile_routes(tcore.make_topology("ring", 4)), tplan, tcfg)
    jb = jcore.compile_bridges(jcore.compile_routes(jcore.make_topology("ring", 4)), jplan, jcfg)
    _, _, b = tcore.simulate_bridged_program(tb, torch.as_tensor(msgs))
    _, _, b_j = jcore.simulate_bridged_program(jb, msgs)
    assert b.as_dict() == b_j.as_dict()
    assert 1 <= b.peak_fifo <= depth


@pytest.mark.parametrize("wire_bits", [8, 16, 32])
@pytest.mark.parametrize("lanes", [1, 2, 8])
def test_bridge_stats_scale_with_wire_width(wire_bits, lanes):
    msgs = np.ones((8, 8, 16), np.uint8)
    tcfg, jcfg = _bridge_cfgs(wire_bits=wire_bits, lanes=lanes, fifo_depth=64)
    tplan, jplan = _plans([0] * 4 + [1] * 4)
    tb = tcore.compile_bridges(tcore.compile_routes(tcore.make_topology("mesh", 8)), tplan, tcfg)
    jb = jcore.compile_bridges(jcore.compile_routes(jcore.make_topology("mesh", 8)), jplan, jcfg)
    b = tcore.bridge_program_stats(tb, msgs.nbytes)
    assert b.as_dict() == jcore.bridge_program_stats(jb, msgs.nbytes).as_dict()
    if lanes == 1:
        narrow = tcore.bridge_program_stats(tcore.compile_bridges(
            tb.prog, tplan, _bridge_cfgs(wire_bits=8, lanes=1)[0]), msgs.nbytes)
        assert narrow.beats == wire_bits // 8 * b.beats


# -- executor: sim_python with a plan -------------------------------------------------

def _pair(core):
    g = core.TaskGraph("pair")
    g.add(core.PE("a", lambda x: {"y": x * 2}, (core.Port("x", (5,)),), (core.Port("y", (5,)),)))
    g.add(core.PE("b", lambda y: {"z": y + 1}, (core.Port("y", (5,)),), (core.Port("z", (5,)),)))
    g.connect("a.y", "b.y")
    return g


@pytest.mark.parametrize("name", TOPOLOGIES)
def test_executor_sim_python_bridge_parity(name):
    """The seed loop's analytic bridge counters == the engine's simulated
    ones == the reference's, field for field."""
    placement, pods = {"a": 0, "b": 3}, [0, 0, 1, 1]
    gt, gj = _pair(tcore), _pair(jcore)
    ex = tcore.NoCExecutor(gt, tcore.make_topology(name, 4), placement=placement,
                           plan=tcore.cut(gt, placement, pods), device=CPU)
    exj = jcore.NoCExecutor(gj, jcore.make_topology(name, 4), placement=placement,
                            plan=jcore.cut(gj, placement, pods), verify="off")
    x = np.arange(5.0, dtype=np.float32)
    out_s, st_s = ex.run({"a.x": x}, mode="sim")
    out_p, st_p = ex.run({"a.x": x}, mode="sim_python")
    _, st_j = exj.run({"a.x": jnp.asarray(x)}, mode="sim")
    _, st_jp = exj.run({"a.x": jnp.asarray(x)}, mode="sim_python")
    assert torch.equal(out_s["b.z"], out_p["b.z"])
    assert st_s.as_dict() == st_p.as_dict() == st_j.as_dict() == st_jp.as_dict()
    assert st_s.bridge_beats > 0 and st_s.cross_pod_msgs == 1
    assert st_s.bridge_counters() == st_j.bridge_counters()


def test_executor_plan_run_batch_matches_reference():
    placement, pods = {"a": 0, "b": 3}, [0, 0, 1, 1]
    gt, gj = _pair(tcore), _pair(jcore)
    ex = tcore.NoCExecutor(gt, tcore.make_topology("mesh", 4), placement=placement,
                           plan=tcore.cut(gt, placement, pods), device=CPU)
    exj = jcore.NoCExecutor(gj, jcore.make_topology("mesh", 4), placement=placement,
                            plan=jcore.cut(gj, placement, pods), verify="off")
    xb = np.stack([np.arange(5.0, dtype=np.float32) * (b + 1) for b in range(3)])
    out, st = ex.run_batch({"a.x": xb})
    out_j, st_j = exj.run_batch({"a.x": jnp.asarray(xb)})
    assert np.array_equal(out["b.z"].numpy(), np.asarray(out_j["b.z"]))
    assert st.as_dict() == st_j.as_dict() and st.bridge_beats > 0


# -- the three apps, cut into pods ----------------------------------------------------

def _bridge_only_differ(uncut, cut_):
    a, b = uncut.as_dict(), cut_.as_dict()
    assert {k: v for k, v in a.items() if not k.startswith(("bridge_", "cross_pod_"))} == \
        {k: v for k, v in b.items() if not k.startswith(("bridge_", "cross_pod_"))}


@pytest.mark.parametrize("topology", ["mesh", "torus"])
@pytest.mark.parametrize("pods", [[0] * 8 + [1] * 8, [0, 1] * 8,
                                  [0] * 4 + [1] * 4 + [2] * 4 + [3] * 4])
def test_ldpc_partitioned_matches_reference(topology, pods):
    rng = np.random.default_rng(0)
    llr = tldpc.awgn_llr(np.zeros(7, np.int8), 3.0, rng)
    H = tldpc.fano_plane_H()
    bits0, post0, st0 = tldpc.decode_on_noc(H, llr, 6, topology=topology, device=CPU)
    bits1, post1, st1 = tldpc.decode_on_noc(H, llr, 6, topology=topology, pods=pods,
                                            device=CPU)
    _, post_j, st_j = jldpc.decode_on_noc(jldpc.fano_plane_H(), llr, 6, topology=topology,
                                          pods=pods)
    assert np.array_equal(bits1, bits0) and np.array_equal(post1, post0)
    assert np.array_equal(post1, post_j)
    _bridge_only_differ(st0, st1)
    assert st1.as_dict() == st_j.as_dict() and st1.bridge_beats > 0


@pytest.mark.parametrize("topology", ["mesh", "fattree"])
@pytest.mark.parametrize("pods", [[0] * 4 + [1] * 4, [0, 1, 2, 3] * 2])
def test_bmvm_partitioned_matches_reference(topology, pods):
    rng = np.random.default_rng(0)
    cfg = tbmvm.BMVMConfig(n=64, k=8, fold=2)
    A = rng.integers(0, 2, (64, 64)).astype(np.uint8)
    v = rng.integers(0, 2, (64,)).astype(np.uint8)
    lut = tbmvm.preprocess(A, cfg, device=CPU)
    out0, st0 = tbmvm.iterate_noc_sim(lut, v, cfg, 2, topology=topology, device=CPU)
    out1, st1 = tbmvm.iterate_noc_sim(lut, v, cfg, 2, topology=topology, pods=pods, device=CPU)
    jcfg = jbmvm.BMVMConfig(n=64, k=8, fold=2)
    _, st_j = jbmvm.iterate_noc_sim(jbmvm.preprocess(A, jcfg), v, jcfg, 2, topology=topology,
                                    pods=pods)
    assert np.array_equal(out1, out0)
    assert np.array_equal(out1.reshape(1, -1), jbmvm.software_ref(A, v[None], 2))
    _bridge_only_differ(st0, st1)
    assert st1.as_dict() == st_j.as_dict() and st1.bridge_beats > 0


@pytest.mark.parametrize("pods", [[0] * 4 + [1] * 4, [0, 1] * 4])
def test_particle_filter_partitioned_matches_reference(pods):
    rng = np.random.default_rng(3)
    cfg = tpf.PFConfig(img=64, roi=16, n_particles=64, n_bins=16)
    frames, _ = tpf.synth_video(cfg, 4, rng)
    c0, st0 = tpf.track_on_noc(frames, cfg, n_pe=4, topology="torus", n_nodes=8, device=CPU)
    c1, st1 = tpf.track_on_noc(frames, cfg, n_pe=4, topology="torus", n_nodes=8, pods=pods,
                               device=CPU)
    jcfg = jpf.PFConfig(img=64, roi=16, n_particles=64, n_bins=16)
    _, st_j = jpf.track_on_noc(frames, jcfg, n_pe=4, topology="torus", n_nodes=8, pods=pods)
    assert np.array_equal(c1, c0)
    _bridge_only_differ(st0, st1)
    assert st1.as_dict() == st_j.as_dict() and st1.bridge_beats > 0


def test_serdes_cfg_changes_bridge_counters_not_outputs():
    rng = np.random.default_rng(1)
    llr = tldpc.awgn_llr(np.zeros(7, np.int8), 3.0, rng)
    posts, beats = [], []
    for wb, lanes in [(8, 1), (16, 4), (32, 8)]:
        _, post, st = tldpc.decode_on_noc(
            tldpc.fano_plane_H(), llr, 5, pods=[0] * 8 + [1] * 8, device=CPU,
            serdes_cfg=tcore.QuasiSerdesConfig(wire_bits=wb, lanes=lanes))
        posts.append(post)
        beats.append(st.bridge_beats)
    assert all(np.array_equal(posts[0], p) for p in posts[1:])
    assert len(set(beats)) == 3


# -- placement search and the pod-cut co-optimizer ------------------------------------

def _graphs(which):
    if which == "ldpc":
        return (tldpc.build_ldpc_graph(tldpc.fano_plane_H())[0],
                jldpc.build_ldpc_graph(jldpc.fano_plane_H())[0])
    tcfg, jcfg = tbmvm.BMVMConfig(n=64, k=8, fold=2), jbmvm.BMVMConfig(n=64, k=8, fold=2)
    A = np.random.default_rng(0).integers(0, 2, (64, 64)).astype(np.uint8)
    return (tbmvm.build_bmvm_graph(tbmvm.preprocess(A, tcfg, device=CPU), tcfg)[0],
            jbmvm.build_bmvm_graph(np.asarray(jbmvm.preprocess(A, jcfg)), jcfg)[0])


@pytest.mark.parametrize("which,topology,n", [("ldpc", "mesh", 16), ("ldpc", "torus", 16),
                                              ("bmvm", "mesh", 8), ("bmvm", "ring", 8)])
@pytest.mark.parametrize("cut_", [False, True])
@pytest.mark.parametrize("seed", [0, 3])
def test_optimize_placement_matches_reference(which, topology, n, cut_, seed):
    """The annealer draws from the same seeded generator in the same order:
    the placements are equal dict for dict, and so are their costs."""
    gt, gj = _graphs(which)
    tt, tj = tcore.make_topology(topology, n), jcore.make_topology(topology, n)
    pods = [i * 2 // n for i in range(n)] if cut_ else None
    scfg = dict(wire_bits=8, lanes=8)
    pt = tcore.optimize_placement(gt, tt, pod_of_node=pods, iters=600, seed=seed,
                                  serdes_cfg=tcore.QuasiSerdesConfig(**scfg))
    pj = jcore.optimize_placement(gj, tj, pod_of_node=pods, iters=600, seed=seed,
                                  serdes_cfg=jcore.QuasiSerdesConfig(**scfg))
    assert pt == pj
    ct = tcore.placement_cost(gt, tt, pt, pods, tcore.QuasiSerdesConfig(**scfg))
    assert ct == jcore.placement_cost(gj, tj, pj, pods, jcore.QuasiSerdesConfig(**scfg))
    assert ct <= tcore.placement_cost(gt, tt, tcore.place_round_robin(gt, tt), pods,
                                      tcore.QuasiSerdesConfig(**scfg))
    assert tcore.pair_cut_weights(gt, tcore.QuasiSerdesConfig(**scfg)) == \
        jcore.pair_cut_weights(gj, jcore.QuasiSerdesConfig(**scfg))


@pytest.mark.parametrize("which", ["ldpc", "bmvm"])
def test_resolve_placement_opt_matches_reference(which):
    gt, gj = _graphs(which)
    n = 16 if which == "ldpc" else 8
    tt, tj = tcore.make_topology("mesh", n), jcore.make_topology("mesh", n)
    assert tcore.resolve_placement(gt, tt, "opt") == jcore.resolve_placement(gj, tj, "opt")
    pods = [0] * (n // 2) + [1] * (n // 2)
    assert tcore.resolve_placement(gt, tt, "opt", pod_of_node=pods, seed=2) == \
        jcore.resolve_placement(gj, tj, "opt", pod_of_node=pods, seed=2)
    with pytest.raises(ValueError, match="unknown placement"):
        tcore.resolve_placement(gt, tt, "annealed")


def test_optimize_placement_respects_capacity():
    gt, _ = _graphs("ldpc")
    tt = tcore.make_topology("mesh", 16)
    pl = tcore.optimize_placement(gt, tt, iters=300)
    assert max(np.bincount(list(pl.values()))) <= 1
    with pytest.raises(ValueError, match="max_per_node"):
        tcore.optimize_placement(gt, tt, init={p: 0 for p in gt.pes}, iters=1)


@pytest.mark.parametrize("which,topology,n,n_pods", [("ldpc", "mesh", 16, 2),
                                                     ("ldpc", "ring", 16, 4),
                                                     ("bmvm", "mesh", 8, 2)])
def test_optimize_pod_cut_matches_reference(which, topology, n, n_pods):
    gt, gj = _graphs(which)
    tt, tj = tcore.make_topology(topology, n), jcore.make_topology(topology, n)
    assert tcore.candidate_cuts(tt, n_pods) == jcore.candidate_cuts(tj, n_pods)
    grid = [(wb, ln) for wb in (8, 16) for ln in (1, 8)]
    plan_t, cost_t = tcore.optimize_pod_cut(
        gt, tt, n_pods, [tcore.QuasiSerdesConfig(wire_bits=wb, lanes=ln) for wb, ln in grid],
        iters=300)
    plan_j, cost_j = jcore.optimize_pod_cut(
        gj, tj, n_pods, [jcore.QuasiSerdesConfig(wire_bits=wb, lanes=ln) for wb, ln in grid],
        iters=300)
    assert cost_t == cost_j
    assert dict(plan_t.placement) == dict(plan_j.placement)
    assert plan_t.pod_of_node == plan_j.pod_of_node
    assert dataclasses.asdict(plan_t.serdes_cfg) == dataclasses.asdict(plan_j.serdes_cfg)
    assert [c.key() for c in plan_t.cross] == [c.key() for c in plan_j.cross]
    assert [c.key() for c in plan_t.intra] == [c.key() for c in plan_j.intra]
    for f in ("cut_bytes", "wire_beats", "wire_bytes"):
        assert getattr(plan_t, f)(gt) == getattr(plan_j, f)(gj), f
    naive = tcore.placement_cost(gt, tt, tcore.place_round_robin(gt, tt),
                                 tcore.candidate_cuts(tt, n_pods)[0], tcore.QuasiSerdesConfig())
    assert cost_t <= naive


@pytest.mark.parametrize("n_pods", [2, 3, 4])
@pytest.mark.parametrize("name,n", [("mesh", 16), ("torus", 12), ("ring", 10), ("fattree", 9)])
def test_candidate_cuts_match_reference(name, n, n_pods):
    assert tcore.candidate_cuts(tcore.make_topology(name, n), n_pods) == \
        jcore.candidate_cuts(jcore.make_topology(name, n), n_pods)


@pytest.mark.parametrize("wire_bits", [8, 16, 32])
@pytest.mark.parametrize("lanes", [1, 8])
def test_cut_plan_matches_reference(wire_bits, lanes):
    gt, gj = _graphs("ldpc")
    placement = tcore.place_round_robin(gt, tcore.make_topology("mesh", 16))
    pods = [0, 1] * 8
    pt = tcore.cut(gt, placement, pods, tcore.QuasiSerdesConfig(wire_bits=wire_bits, lanes=lanes))
    pj = jcore.cut(gj, placement, pods, jcore.QuasiSerdesConfig(wire_bits=wire_bits, lanes=lanes))
    assert [c.key() for c in pt.cross] == [c.key() for c in pj.cross]
    assert (pt.n_pods, pt.cut_bytes(gt), pt.wire_beats(gt), pt.wire_bytes(gt)) == \
        (pj.n_pods, pj.cut_bytes(gj), pj.wire_beats(gj), pj.wire_bytes(gj))
    assert pt.wire_bytes(gt) == pt.wire_beats(gt) * pt.serdes_cfg.beat_bytes


# -- quasi-SERDES endpoints -----------------------------------------------------------

def _wire_bytes(words):
    """Wire words of either package as their bytes (bit patterns, not dtypes)."""
    if isinstance(words, torch.Tensor):
        return words.contiguous().view(torch.uint8).numpy().reshape(-1)
    return np.ascontiguousarray(np.asarray(words)).view(np.uint8).reshape(-1)


SERDES_DTYPES = {"float32": np.float32, "int32": np.int32, "uint8": np.uint8, "int16": np.int16}


@pytest.mark.parametrize("compress,dtype", [("none", d) for d in sorted(SERDES_DTYPES)]
                         + [("bf16", "float32")])
@pytest.mark.parametrize("wire_bits", [8, 16, 32])
@pytest.mark.parametrize("lanes", [1, 2, 8])
@pytest.mark.parametrize("n", [1, 67, 300])
def test_encode_decode_match_reference_bit_for_bit(compress, dtype, wire_bits, lanes, n):
    np_dt = SERDES_DTYPES[dtype]
    rng = np.random.default_rng(n * wire_bits + lanes)
    x = (rng.normal(size=(n,)) if dtype == "float32"
         else rng.integers(np.iinfo(np_dt).min, np.iinfo(np_dt).max, size=(n,))).astype(np_dt)
    tcfg = tcore.QuasiSerdesConfig(wire_bits=wire_bits, lanes=lanes, compress=compress)
    jcfg = jcore.QuasiSerdesConfig(wire_bits=wire_bits, lanes=lanes, compress=compress)
    xt = torch.as_tensor(x)
    mt, mj = tserdes.plan(xt.shape, xt.dtype, tcfg), jserdes.plan(x.shape, x.dtype, jcfg)
    assert (mt.n_words, mt.n_scale_words) == (mj.n_words, mj.n_scale_words)
    w, sw, res = tserdes.encode(xt, tcfg, mt)
    w_j, sw_j, _ = jserdes.encode(jnp.asarray(x), jcfg, mj)
    assert w.shape == (lanes, mt.n_words // lanes) == tuple(w_j.shape)
    assert w.element_size() * 8 == wire_bits and res is None
    assert np.array_equal(_wire_bytes(w), _wire_bytes(w_j))
    assert tuple(sw.shape) == tuple(sw_j.shape)
    y, y_j = tserdes.decode(w, sw, tcfg, mt), jserdes.decode(w_j, sw_j, jcfg, mj)
    assert y.dtype == xt.dtype
    assert np.array_equal(y.numpy(), np.asarray(y_j))
    if compress == "none":
        assert torch.equal(y, xt)


def test_odd_payload_padding_is_zero():
    for wire_bits in (8, 16, 32):
        for lanes in (1, 8):
            cfg = tcore.QuasiSerdesConfig(wire_bits=wire_bits, lanes=lanes)
            x = torch.full((5,), 0xAB, dtype=torch.uint8)
            meta = tserdes.plan(x.shape, x.dtype, cfg)
            raw = _wire_bytes(tserdes.encode(x, cfg, meta)[0])
            assert (raw[:5] == 0xAB).all() and (raw[5:] == 0).all()


def _int8_close(got, ref, scale):
    """Within 1e-6 x the block scale of the reference, per element."""
    return np.all(np.abs(got - ref) <= 1e-6 * np.maximum(scale, 1e-30))


@pytest.mark.parametrize("wire_bits", [8, 16, 32])
@pytest.mark.parametrize("lanes", [1, 8])
@pytest.mark.parametrize("block", [16, 256])
@pytest.mark.parametrize("n", [2, 200, 600])
def test_int8_encode_decode_match_reference(wire_bits, lanes, block, n):
    """int8 codes and scale words equal the reference's; decoded values and
    the error-feedback residual within 1e-6 x the block scale."""
    rng = np.random.default_rng(n + block)
    x = (rng.normal(size=(n,)) * 3).astype(np.float32)
    r0 = (rng.normal(size=(n,)) * 0.01).astype(np.float32)
    tcfg = tcore.QuasiSerdesConfig(wire_bits=wire_bits, lanes=lanes, compress="int8", block=block)
    jcfg = jcore.QuasiSerdesConfig(wire_bits=wire_bits, lanes=lanes, compress="int8", block=block)
    mt, mj = tserdes.plan((n,), np.float32, tcfg), jserdes.plan((n,), np.float32, jcfg)
    assert (mt.n_words, mt.n_scale_words) == (mj.n_words, mj.n_scale_words)
    w, sw, res = tserdes.encode(torch.as_tensor(x), tcfg, mt, residual=torch.as_tensor(r0))
    w_j, sw_j, res_j = jserdes.encode(jnp.asarray(x), jcfg, mj, residual=jnp.asarray(r0))
    codes, codes_j = _wire_bytes(w)[:n], _wire_bytes(w_j)[:n]
    bad = np.nonzero(codes != codes_j)[0]
    assert bad.size == 0, f"int8 codes differ at {bad[:10]}"
    assert np.array_equal(_wire_bytes(w), _wire_bytes(w_j))
    assert np.array_equal(_wire_bytes(sw), _wire_bytes(sw_j))
    n_blocks = -(-n // block)
    scale = np.repeat(_wire_bytes(sw_j)[:4 * n_blocks].view(np.float32), block)[:n]
    y = tserdes.decode(w, sw, tcfg, mt).numpy()
    y_j = np.asarray(jserdes.decode(w_j, sw_j, jcfg, mj))
    assert _int8_close(y, y_j, scale) and _int8_close(res.numpy(), np.asarray(res_j), scale)
    assert np.abs(y - x).max() <= np.abs(x + r0).max() / 127 + 1e-5


def test_int8_error_feedback_tracks_the_reference():
    """Error feedback over a drifting signal: the same residual stream as the
    reference, step by step, and no drift of the summed transmission."""
    tcfg = tcore.QuasiSerdesConfig(compress="int8", block=32)
    jcfg = jcore.QuasiSerdesConfig(compress="int8", block=32)
    mt, mj = tserdes.plan((64,), np.float32, tcfg), jserdes.plan((64,), np.float32, jcfg)
    rng = np.random.default_rng(1)
    res = res_j = None
    sent, truth, max_abs = np.zeros(64), np.zeros(64), 0.0
    for step in range(40):
        g = (rng.normal(size=(64,)) * (1 + 0.1 * step)).astype(np.float32)
        max_abs = max(max_abs, float(np.abs(g).max()))
        w, sw, res = tserdes.encode(torch.as_tensor(g), tcfg, mt, residual=res)
        w_j, sw_j, res_j = jserdes.encode(jnp.asarray(g), jcfg, mj, residual=res_j)
        assert np.array_equal(_wire_bytes(w), _wire_bytes(w_j)), step
        assert np.abs(res.numpy() - np.asarray(res_j)).max() <= 1e-6 * max_abs, step
        sent += tserdes.decode(w, sw, tcfg, mt).numpy()
        truth += g
    assert np.abs(sent - truth).max() <= max_abs / 127 * 3 + 1e-5


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.bool])
def test_encode_decode_torch_only_dtypes_roundtrip(dtype):
    """Dtypes with no numpy contract (bf16) or other widths frame by bytes too."""
    x = (torch.randn(37, generator=torch.Generator().manual_seed(0)) > 0).to(dtype)
    for wire_bits in (8, 16, 32):
        cfg = tcore.QuasiSerdesConfig(wire_bits=wire_bits, lanes=4)
        meta = tserdes.plan(x.shape, x.dtype, cfg)
        w, sw, _ = tserdes.encode(x, cfg, meta)
        assert torch.equal(tserdes.decode(w, sw, cfg, meta), x)
