"""The port's NoC framework against the reference: topology copy, the
round-by-round schedule simulator (plain and batched), placement, serdes
accounting, the compiled flit-program executor (direct == sim == sim_python
== run_batch on the diamond and mixed-dtype graphs rebuilt with torch PE
bodies), the golden NoCStats, and the options that later slices port
(``spmd``, ``buffered`` and ``verify=`` have been ported; their cases here
check what they do now, ``spmd`` in a 4-rank gloo world of
`tests/torch_spmd_worlds.py`)."""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro.apps import bmvm as jbmvm  # noqa: E402
from repro.apps import ldpc as jldpc  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.apps import bmvm as tbmvm  # noqa: E402
from repro_torch.apps import ldpc as tldpc  # noqa: E402
from repro_torch.apps import particle_filter as tpf  # noqa: E402
from repro_torch.telemetry import Tracer, trace_stats  # noqa: E402
from tests import torch_spmd_worlds as W  # noqa: E402

TOPOLOGIES = ["ring", "mesh", "torus", "fattree"]
CPU = "cpu"
GOLDEN_LDPC_FANO = dict(
    waves=20, rounds=60, link_bytes=92160, payload_bytes=840, flits=420,
    cross_pod_msgs=0, cross_pod_wire_bytes=0, cross_pod_beats=0,
    bridge_beats=0, bridge_wire_bytes=0, bridge_stall_rounds=0,
    bridge_peak_fifo=0, switch_cycles=0, switch_stall_cycles=0,
    switch_arb_losses=0, switch_max_queue=0, switch_peak_link_flits=0)
GOLDEN_BMVM = dict(
    waves=4, rounds=8, link_bytes=5632, payload_bytes=256, flits=128,
    cross_pod_msgs=0, cross_pod_wire_bytes=0, cross_pod_beats=0,
    bridge_beats=0, bridge_wire_bytes=0, bridge_stall_rounds=0,
    bridge_peak_fifo=0, switch_cycles=0, switch_stall_cycles=0,
    switch_arb_losses=0, switch_max_queue=0, switch_peak_link_flits=0)


# -- topology ------------------------------------------------------------------

@pytest.mark.parametrize("name", TOPOLOGIES)
@pytest.mark.parametrize("n", [4, 6, 9, 16])
def test_topology_copy_matches_reference(name, n):
    t, j = tcore.make_topology(name, n), jcore.make_topology(name, n)
    assert type(t).__name__ == type(j).__name__
    for i in range(n):
        assert sorted(t.neighbors(i)) == sorted(j.neighbors(i))
        assert [t.hops(i, d) for d in range(n)] == [j.hops(i, d) for d in range(n)]
    assert (t.a2a_rounds(), t.n_links(), t.bisection_links(), t.a2a_link_bytes(12)) == \
        (j.a2a_rounds(), j.n_links(), j.bisection_links(), j.a2a_link_bytes(12))
    assert [dataclass_tuple(a) for a in t.axis_schedules()] == \
        [dataclass_tuple(a) for a in j.axis_schedules()]


def dataclass_tuple(a):
    return (a.axis, a.size, a.wrap, a.unidir, a.fwd_pairs(), a.bwd_pairs())


def test_topology_compare_table_matches_reference():
    assert tcore.compare(16, 64) == jcore.compare(16, 64)


# -- routing -------------------------------------------------------------------

@pytest.mark.parametrize("name", TOPOLOGIES)
@pytest.mark.parametrize("n,c", [(2, 1), (4, 3), (6, 5), (9, 2), (12, 4), (16, 1)])
def test_simulate_schedule_matches_reference(name, n, c):
    """Every message delivered exactly once (== transpose), and rounds and
    link_bytes counted exactly as the numpy reference counts them."""
    rng = np.random.default_rng(n * 100 + c)
    msgs = rng.integers(0, 255, size=(n, n, c), dtype=np.uint8)
    out_t, st_t = tcore.simulate_schedule(tcore.make_topology(name, n), torch.as_tensor(msgs))
    out_j, st_j = jcore.simulate_schedule(jcore.make_topology(name, n), msgs)
    assert np.array_equal(out_t.numpy(), msgs.swapaxes(0, 1))
    assert np.array_equal(out_t.numpy(), out_j)
    assert (st_t.rounds, st_t.link_bytes) == (st_j.rounds, st_j.link_bytes)


@pytest.mark.parametrize("name,n", [("ring", 5), ("mesh", 6), ("torus", 8), ("fattree", 7)])
def test_simulate_schedule_batched_matches_reference(name, n):
    rng = np.random.default_rng(0)
    msgs = rng.integers(0, 255, (3, n, n, 4)).astype(np.uint8)
    out_t, st_t = tcore.simulate_schedule(tcore.make_topology(name, n), torch.as_tensor(msgs),
                                          batched=True)
    out_j, st_j = jcore.simulate_schedule(jcore.make_topology(name, n), msgs, batched=True)
    assert np.array_equal(out_t.numpy(), msgs.swapaxes(1, 2))
    assert np.array_equal(out_t.numpy(), out_j)
    assert (st_t.rounds, st_t.link_bytes) == (st_j.rounds, st_j.link_bytes)
    for b in range(3):
        single, _ = tcore.simulate_schedule(tcore.make_topology(name, n), torch.as_tensor(msgs[b]))
        assert torch.equal(out_t[b], single)


def test_round_counts_match_model():
    for name in TOPOLOGIES:
        topo = tcore.make_topology(name, 16)
        _, stats = tcore.simulate_schedule(topo, torch.ones((16, 16, 4), dtype=torch.uint8))
        assert stats.rounds == topo.a2a_rounds(), name


# -- placement and serdes accounting -------------------------------------------

@pytest.mark.parametrize("spec", ["rr", "greedy"])
@pytest.mark.parametrize("name", TOPOLOGIES)
def test_placement_matches_reference(spec, name):
    H = tldpc.fano_plane_H()
    gt, _ = tldpc.build_ldpc_graph(H)
    gj, _ = jldpc.build_ldpc_graph(H)
    pt = tcore.resolve_placement(gt, tcore.make_topology(name, 16), spec)
    pj = jcore.resolve_placement(gj, jcore.make_topology(name, 16), spec)
    assert pt == pj


def test_explicit_placement_is_validated():
    g, _ = tldpc.build_ldpc_graph(tldpc.fano_plane_H())
    topo = tcore.make_topology("mesh", 16)
    with pytest.raises(ValueError, match="missing"):
        tcore.resolve_placement(g, topo, {"chk0": 0})
    with pytest.raises(ValueError, match="out-of-range"):
        tcore.resolve_placement(g, topo, {p: 99 for p in g.pes})


@pytest.mark.parametrize("compress", ["none", "bf16", "int8"])
@pytest.mark.parametrize("wire_bits,lanes", [(8, 1), (16, 8), (32, 4)])
def test_serdes_accounting_matches_reference(compress, wire_bits, lanes):
    ct = tcore.QuasiSerdesConfig(wire_bits=wire_bits, lanes=lanes, compress=compress)
    cj = jcore.QuasiSerdesConfig(wire_bits=wire_bits, lanes=lanes, compress=compress)
    for shape, dtype in [((1,), np.float32), ((7, 3), np.uint32), ((300,), np.int8),
                         ((4, 4, 4), np.float32)]:
        mt, mj = tcore.plan(shape, dtype, ct), jcore.plan(shape, dtype, cj)
        assert (mt.shape, mt.n_words, mt.n_scale_words) == (mj.shape, mj.n_words, mj.n_scale_words)
        assert tcore.link_wire_beats(shape, dtype, ct) == jcore.link_wire_beats(shape, dtype, cj)
        assert tcore.link_bytes_on_wire(shape, dtype, ct) == \
            jcore.link_bytes_on_wire(shape, dtype, cj)
        assert tcore.compression_ratio(shape, dtype, ct) == \
            jcore.compression_ratio(shape, dtype, cj)


def test_serdes_config_validates():
    with pytest.raises(ValueError):
        tcore.QuasiSerdesConfig(wire_bits=12)
    with pytest.raises(ValueError):
        tcore.QuasiSerdesConfig(compress="zip")


@pytest.mark.parametrize("width", [8, 12, 16, 24])
def test_wrapper_overhead_matches_reference(width):
    H = tldpc.fano_plane_H()
    gt, _ = tldpc.build_ldpc_graph(H)
    gj, _ = jldpc.build_ldpc_graph(H)
    assert tcore.wrapper_overhead(gt, tcore.NoCConfig(flit_data_width=width)) == \
        jcore.wrapper_overhead(gj, jcore.NoCConfig(flit_data_width=width))


# -- executor -------------------------------------------------------------------

def _diamond(core, lib):
    g = core.TaskGraph("diamond")
    g.add(core.PE("src", lambda x: {"a": x + 1, "b": x * 3}, (core.Port("x", (4,)),),
                  (core.Port("a", (4,)), core.Port("b", (4,)))))
    g.add(core.PE("l", lambda a: {"o": a * a}, (core.Port("a", (4,)),), (core.Port("o", (4,)),)))
    g.add(core.PE("r", lambda b: {"o": b - 2}, (core.Port("b", (4,)),), (core.Port("o", (4,)),)))
    g.add(core.PE("join", lambda l, r: {"out": l + r},
                  (core.Port("l", (4,)), core.Port("r", (4,))), (core.Port("out", (4,)),)))
    g.connect("src.a", "l.a")
    g.connect("src.b", "r.b")
    g.connect("l.o", "join.l")
    g.connect("r.o", "join.r")
    return g, {"src.x": np.arange(4.0, dtype=np.float32)}


def _mixed(core, lib):
    """Non-float32 contracts through the byte-level framing; ``lib`` is the
    array library of the PE bodies (jnp for the reference, torch for the port)."""
    i32, u8 = (jnp.int32, jnp.uint8) if lib is jnp else (torch.int32, torch.uint8)

    def cast(x, d):
        return x.astype(d) if lib is jnp else x.to(d)
    g = core.TaskGraph("mixed")
    g.add(core.PE("a", lambda x: {"i": cast(x * 2, i32), "u": cast(x + 1, u8)},
                  (core.Port("x", (3,)),),
                  (core.Port("i", (3,), np.int32), core.Port("u", (3,), np.uint8))))
    g.add(core.PE("b", lambda i: {"y": cast(i * i, i32)},
                  (core.Port("i", (3,), np.int32),), (core.Port("y", (3,), np.int32),)))
    g.add(core.PE("c", lambda u: {"z": cast(u + 3, u8)},
                  (core.Port("u", (3,), np.uint8),), (core.Port("z", (3,), np.uint8),)))
    g.connect("a.i", "b.i")
    g.connect("a.u", "c.u")
    return g, {"a.x": np.arange(3.0, dtype=np.float32)}


@pytest.mark.parametrize("builder", [_diamond, _mixed])
@pytest.mark.parametrize("name", TOPOLOGIES)
@pytest.mark.parametrize("seed", [0, 1])
def test_executor_direct_sim_batch_match_reference(builder, name, seed):
    gt, inp = builder(tcore, torch)
    gj, _ = builder(jcore, jnp)
    n_nodes = 6
    rng = np.random.default_rng(seed)
    placement = {p: int(rng.integers(0, n_nodes)) for p in gt.pes}
    ex = tcore.NoCExecutor(gt, tcore.make_topology(name, n_nodes), placement=placement,
                           device=CPU)
    exj = jcore.NoCExecutor(gj, jcore.make_topology(name, n_nodes), placement=placement,
                            verify="off")
    direct, st_d = ex.run(inp, mode="direct")
    sim, st = ex.run(inp, mode="sim")
    seed_loop, st_l = ex.run(inp, mode="sim_python")
    ref_out, st_j = exj.run({k: jnp.asarray(v) for k, v in inp.items()}, mode="sim")
    _, st_jl = exj.run({k: jnp.asarray(v) for k, v in inp.items()}, mode="sim_python")
    assert st_d.as_dict() == tcore.NoCStats().as_dict()
    assert st.as_dict() == st_l.as_dict() == st_j.as_dict() == st_jl.as_dict()
    for k in ref_out:
        assert sim[k].dtype == direct[k].dtype == seed_loop[k].dtype
        assert torch.equal(sim[k], direct[k]) and torch.equal(seed_loop[k], direct[k]), (name, k)
        assert np.array_equal(sim[k].numpy(), np.asarray(ref_out[k])), (name, k)
    B = 3
    binp = {k: np.stack([v * (b + 1) for b in range(B)]) for k, v in inp.items()}
    bouts, st_b = ex.run_batch(binp)
    bdirect, _ = ex.run_batch(binp, mode="direct")
    _, st_bj = exj.run_batch({k: jnp.asarray(v) for k, v in binp.items()})
    assert st_b.as_dict() == st_bj.as_dict()
    assert st_b.rounds == st.rounds and st_b.payload_bytes == B * st.payload_bytes
    for b in range(B):
        d = gt.run({k: torch.as_tensor(v[b]) for k, v in binp.items()})
        for k in d:
            assert torch.equal(bouts[k][b], d[k]) and torch.equal(bdirect[k][b], d[k])


def test_run_iterative_matches_reference():
    gt, inp = _diamond(tcore, torch)
    gj, _ = _diamond(jcore, jnp)
    feedback = [("join.out", "src.x")]
    ex = tcore.NoCExecutor(gt, tcore.make_topology("torus", 4), device=CPU)
    exj = jcore.NoCExecutor(gj, jcore.make_topology("torus", 4), verify="off")
    out_d, _ = ex.run_iterative(inp, feedback, 4, mode="direct")
    out_s, st = ex.run_iterative(inp, feedback, 4, mode="sim")
    out_l, st_l = ex.run_iterative(inp, feedback, 4, mode="sim_python")
    out_j, st_j = exj.run_iterative({"src.x": jnp.asarray(inp["src.x"])}, feedback, 4)
    assert torch.equal(out_s["join.out"], out_d["join.out"])
    assert torch.equal(out_l["join.out"], out_d["join.out"])
    assert np.array_equal(out_s["join.out"].numpy(), np.asarray(out_j["join.out"]))
    assert st.as_dict() == st_l.as_dict() == st_j.as_dict() and st.waves == 4 * 3


def test_contract_violation_is_rejected():
    g = tcore.TaskGraph("bad")
    g.add(tcore.PE("a", lambda x: {"y": x.to(torch.float64)}, (tcore.Port("x", (2,)),),
                   (tcore.Port("y", (2,)),)))
    g.add(tcore.PE("b", lambda y: {"z": y}, (tcore.Port("y", (2,)),), (tcore.Port("z", (2,)),)))
    g.connect("a.y", "b.y")
    ex = tcore.NoCExecutor(g, tcore.make_topology("ring", 2), device=CPU)
    with pytest.raises(tcore.GraphError, match="violates contract"):
        ex.run({"a.x": np.zeros(2, np.float32)})


def test_port_torch_dtype():
    assert tcore.Port("p", (2,), np.uint32).torch_dtype == torch.uint32
    assert tcore.Port("p", (2,)).torch_dtype == torch.float32
    with pytest.raises(TypeError):
        tcore.torch_dtype(np.complex64)


def test_nocstats_add_mixed_semantics():
    a = tcore.NoCStats(rounds=10, switch_cycles=7, switch_max_queue=5,
                       switch_peak_link_flits=4, bridge_peak_fifo=9)
    b = tcore.NoCStats(rounds=5, switch_cycles=8, switch_max_queue=3,
                       switch_peak_link_flits=11, bridge_peak_fifo=2)
    a.add(b)
    assert (a.rounds, a.switch_cycles) == (15, 15)                 # flows sum
    assert (a.switch_max_queue, a.switch_peak_link_flits, a.bridge_peak_fifo) == (5, 11, 9)
    assert len(a.as_dict()) == 17
    assert set(a.as_dict()) == set(jcore.NoCStats().as_dict())


def test_noc_config_matches_reference():
    for width in (4, 12, 16):
        t, j = tcore.NoCConfig(flit_data_width=width), jcore.NoCConfig(flit_data_width=width)
        assert t.flit_wire_bytes == j.flit_wire_bytes
        assert [t.flit_framed_bytes(b) for b in range(40)] == \
            [j.flit_framed_bytes(b) for b in range(40)]
    with pytest.raises(ValueError, match="NOC012"):
        tcore.NoCConfig(switch_vcs=0)
    assert tcore.NoCConfig().serdes is not tcore.NoCConfig().serdes


# -- golden NoCStats --------------------------------------------------------------

def test_golden_stats_ldpc_fano():
    rng = np.random.default_rng(0)
    llr = tldpc.awgn_llr(np.zeros(7, np.int8), 3.0, rng)
    bits, _, st = tldpc.decode_on_noc(tldpc.fano_plane_H(), llr, 10, device=CPU)
    _, _, st_j = jldpc.decode_on_noc(jldpc.fano_plane_H(), llr, 10)
    assert not bits.any()
    assert st.as_dict() == GOLDEN_LDPC_FANO == st_j.as_dict()
    assert convert.stats_to_torch(st_j.as_dict()) == st


def test_golden_stats_bmvm():
    rng = np.random.default_rng(0)
    cfg = tbmvm.BMVMConfig(n=64, k=8, fold=2)
    A = rng.integers(0, 2, (64, 64)).astype(np.uint8)
    v = rng.integers(0, 2, (64,)).astype(np.uint8)
    lut = tbmvm.preprocess(A, cfg, device=CPU)
    out, st = tbmvm.iterate_noc_sim(lut, v, cfg, 2, topology="mesh", device=CPU)
    assert np.array_equal(out.reshape(1, -1), jbmvm.software_ref(A, v[None], 2))
    assert st.as_dict() == GOLDEN_BMVM


@pytest.mark.parametrize("name", TOPOLOGIES)
@pytest.mark.parametrize("width", [8, 12, 16, 32])
def test_sim_python_matches_sim_and_reference_bmvm(name, width):
    """The seed loop == the compiled engine == direct on the BMVM n=64 graph,
    outputs and NoCStats, and both equal the reference's seed loop."""
    rng = np.random.default_rng(0)
    A = rng.integers(0, 2, (64, 64)).astype(np.uint8)
    v = rng.integers(0, 2, (64,)).astype(np.uint8)
    tcfg, jcfg = tbmvm.BMVMConfig(n=64, k=8, fold=2), jbmvm.BMVMConfig(n=64, k=8, fold=2)
    gt, fb = tbmvm.build_bmvm_graph(tbmvm.preprocess(A, tcfg, device=CPU), tcfg)
    gj, _ = jbmvm.build_bmvm_graph(np.asarray(jbmvm.preprocess(A, jcfg)), jcfg)
    vw = np.array(jbmvm.kref.gf2_pack_vector(jnp.asarray(v), 8), np.uint32)
    inp = {f"lut{i}.v": vw[2 * i:2 * i + 2] for i in range(4)}
    ex = tcore.NoCExecutor(gt, tcore.make_topology(name, 8), device=CPU,
                           cfg=tcore.NoCConfig(flit_data_width=width))
    exj = jcore.NoCExecutor(gj, jcore.make_topology(name, 8), verify="off",
                            cfg=jcore.NoCConfig(flit_data_width=width))
    outs = {m: ex.run_iterative(inp, fb, 2, mode=m) for m in ("direct", "sim", "sim_python")}
    _, st_j = exj.run_iterative(inp, fb, 2, mode="sim_python")
    for k, val in outs["direct"][0].items():
        assert torch.equal(outs["sim"][0][k], val) and torch.equal(outs["sim_python"][0][k], val)
    assert outs["sim"][1].as_dict() == outs["sim_python"][1].as_dict() == st_j.as_dict()


def test_sim_python_golden_stats_ldpc_fano():
    rng = np.random.default_rng(0)
    llr = tldpc.awgn_llr(np.zeros(7, np.int8), 3.0, rng)
    bits, _, st = tldpc.decode_on_noc(tldpc.fano_plane_H(), llr, 10, mode="sim_python",
                                      device=CPU)
    assert not bits.any() and st.as_dict() == GOLDEN_LDPC_FANO


def test_run_batch_refuses_sim_python_as_the_reference_does():
    g, topo, inp = _graph_and_topo()
    with pytest.raises(tcore.GraphError, match="unknown mode"):
        tcore.NoCExecutor(g, topo, device=CPU).run_batch({k: v[None] for k, v in inp.items()},
                                                         mode="sim_python")


# -- what later slices port runs now ----------------------------------------------

def _graph_and_topo():
    g, inp = _diamond(tcore, torch)
    return g, tcore.make_topology("mesh", 4), inp


@pytest.fixture(scope="module")
def spmd_world(tmp_path_factory):
    """The diamond on the 4-node mesh in ``mode="spmd"`` over 4 gloo ranks
    (uncut run and run_batch, and under a 2-pod plan), with each rank's
    ``sim`` run beside it; the result every rank returned."""
    w = W.World("noc_diamond", 4, tmp_path_factory.mktemp("noc_diamond"))
    yield lambda: W.one_result(w)
    w.close()


def _spmd_equals_sim(case):
    out, st, out_sim, st_sim = case
    assert out.keys() == out_sim.keys()
    assert all(np.array_equal(out[k], out_sim[k]) for k in out)
    assert st == st_sim
    return st


@pytest.mark.parametrize("mode", ["spmd", "buffered"])
def test_later_modes_raise(mode, request):
    """Both have been ported: ``spmd`` (one node a rank) equals ``sim`` and
    ``direct`` in outputs and ``sim`` in NoCStats through run and run_batch;
    ``buffered`` runs in both and equals ``sim`` in outputs."""
    g, topo, inp = _graph_and_topo()
    ex = tcore.NoCExecutor(g, topo, device=CPU)
    if mode == "spmd":
        res = request.getfixturevalue("spmd_world")()
        for call in ("run", "run_batch"):
            assert _spmd_equals_sim(res[call])["rounds"] > 0
        want, _ = ex.run(inp, mode="direct")
        assert all(np.array_equal(res["run"][0][k], want[k].numpy()) for k in want)
        return
    binp = {k: v[None] for k, v in inp.items()}
    for call in (ex.run, ex.run_batch):
        x = inp if call == ex.run else binp
        (out, st), (ref, st_sim) = call(x, mode=mode), call(x, mode="sim")
        assert all(torch.equal(out[k], ref[k]) for k in ref)
        assert st.switch_cycles == st.rounds > 0 and st.flits == st_sim.flits


def test_unknown_mode_is_an_error():
    g, topo, inp = _graph_and_topo()
    with pytest.raises(tcore.GraphError, match="unknown mode"):
        tcore.NoCExecutor(g, topo, device=CPU).run(inp, mode="warp")


@pytest.mark.parametrize("kwargs,err", [
    (dict(verify="strict"), None), (dict(verify="warn"), None),
    (dict(verify="maybe"), ValueError), (dict(trace=True), None)])
def test_later_executor_options_raise(kwargs, err):
    """An unknown ``verify`` is an error; ``verify="strict"``/``"warn"`` and
    ``trace=`` have been ported (``err`` None): the executor verifies itself,
    keeps the findings, and ``trace=True`` gives it a fresh tracer."""
    g, topo, inp = _graph_and_topo()
    if err is None:
        with warnings.catch_warnings(record=True) as warned:
            warnings.simplefilter("always")
            ex = tcore.NoCExecutor(g, topo, device=CPU, **kwargs)
        assert ex.verification and all(d.code == "NOC005" for d in ex.verification)
        assert len(warned) == (kwargs.get("verify") == "warn")
        assert (ex.tracer is not None) == ("trace" in kwargs)
        if ex.tracer is not None:
            _, st = ex.run(inp)
            assert trace_stats(ex.tracer).as_dict() == st.as_dict()
        return
    with pytest.raises(err):
        tcore.NoCExecutor(g, topo, device=CPU, **kwargs)


@pytest.mark.parametrize("mode", ["spmd", "buffered"])
def test_plan_with_later_modes_raises(mode, request):
    """Under a plan ``spmd`` serializes the cut hops between ranks and
    equals the bridged ``sim`` in outputs and every NoCStats field, bridge
    counters included; ``buffered`` routes uncut and rolls in the analytic
    bridge counters, which equal the bridged simulator's."""
    if mode == "spmd":
        st = _spmd_equals_sim(request.getfixturevalue("spmd_world")()["plan"])
        assert st["bridge_beats"] > 0 and st["cross_pod_msgs"] > 0
        return
    g, topo, inp = _graph_and_topo()
    placement = {p: i for i, p in enumerate(g.pes)}
    ex = tcore.NoCExecutor(g, topo, plan=tcore.cut(g, placement, [0, 0, 1, 1]), device=CPU)
    (out, st), (ref, st_sim) = ex.run(inp, mode=mode), ex.run(inp, mode="sim")
    assert all(torch.equal(out[k], ref[k]) for k in ref)
    assert st.bridge_counters() == st_sim.bridge_counters() and st.bridge_beats > 0


@pytest.mark.parametrize("option", ["tracer"])
@pytest.mark.parametrize("app", ["bmvm", "ldpc", "pf"])
def test_app_later_options_raise(option, app):
    """The apps' ``tracer=`` has been ported: it reaches
    ``NoCExecutor(trace=)``, and the trace folds back into the run's stats."""
    value = {"tracer": Tracer()}[option]
    if app == "bmvm":
        cfg = tbmvm.BMVMConfig(n=16, k=4, fold=1)
        lut = tbmvm.preprocess(np.eye(16, dtype=np.uint8), cfg, device=CPU)
        call = lambda: tbmvm.iterate_noc_sim(lut, np.ones(16, np.uint8), cfg, 1, device=CPU,
                                             **{option: value})
    elif app == "ldpc":
        call = lambda: tldpc.decode_on_noc(tldpc.fano_plane_H(), np.ones(7, np.float32), 1,
                                           device=CPU, **{option: value})
    else:
        cfg = tpf.PFConfig(img=32, roi=8, n_particles=8)
        call = lambda: tpf.track_on_noc(np.zeros((2, 32, 32), np.float32), cfg, device=CPU,
                                        **{option: value})
    st = call()[-1]
    assert len(value) > 0 and trace_stats(value).as_dict() == st.as_dict()


def test_bmvm_iterate_spmd_raises():
    """iterate_spmd has been ported; without a process group it raises the
    error that names torchrun (tests/test_torch_spmd.py runs it on 8 ranks)."""
    cfg = tbmvm.BMVMConfig(n=16, k=4, fold=1)
    lut = tbmvm.preprocess(np.eye(16, dtype=np.uint8), cfg, device=CPU)
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node"):
        tbmvm.iterate_spmd(lut, np.ones((1, 16), np.uint8), cfg, 1, device=CPU)
