"""The port's buffered wormhole switch and traffic generator against the
reference, on the same inputs: dimension-ordered routes, the cycle simulator
(SwitchStats, completions and ejection log equal field for field on table 9's
fast grid and the torus depth-1 gate), the analytic model, the packet lists,
the message-cube adapter, ``NoCExecutor(mode="buffered")`` (golden NoCStats,
buffered == sim on the diamond graph and the three apps on every topology,
mixed dtypes, run_batch, run_iterative, pods), and the port's own throughput
property against the link loads of the packets actually generated."""
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
from repro_torch.apps import bmvm as tbmvm  # noqa: E402
from repro_torch.apps import ldpc as tldpc  # noqa: E402
from repro_torch.apps import particle_filter as tpf  # noqa: E402
import repro.telemetry as jtel  # noqa: E402
import repro_torch.telemetry as ttel  # noqa: E402

TOPOLOGIES = ["ring", "mesh", "torus", "fattree"]
PATTERNS = ["uniform", "hotspot", "transpose", "bursty"]
CPU = "cpu"
GOLDEN_LDPC_FANO_BUFFERED = dict(
    waves=20, rounds=190, link_bytes=2600, payload_bytes=840, flits=420,
    cross_pod_msgs=0, cross_pod_wire_bytes=0, cross_pod_beats=0,
    bridge_beats=0, bridge_wire_bytes=0, bridge_stall_rounds=0,
    bridge_peak_fifo=0, switch_cycles=190, switch_stall_cycles=520,
    switch_arb_losses=40, switch_max_queue=2, switch_peak_link_flits=13)
GOLDEN_BMVM_BUFFERED = dict(
    waves=4, rounds=90, link_bytes=640, payload_bytes=256, flits=128,
    cross_pod_msgs=0, cross_pod_wire_bytes=0, cross_pod_beats=0,
    bridge_beats=0, bridge_wire_bytes=0, bridge_stall_rounds=0,
    bridge_peak_fifo=0, switch_cycles=90, switch_stall_cycles=304,
    switch_arb_losses=28, switch_max_queue=4, switch_peak_link_flits=6)


def _pkts(packets):
    return [(p.src, p.dst, p.n_flits, p.t_inject) for p in packets]


def _traffic(name, n, **kw):
    """The same TrafficConfig's packets from both packages (asserted equal)."""
    tt, tj = tcore.make_topology(name, n), jcore.make_topology(name, n)
    pt = tcore.generate_traffic(tt, tcore.TrafficConfig(**kw))
    pj = jcore.generate_traffic(tj, jcore.TrafficConfig(**kw))
    assert _pkts(pt) == _pkts(pj)
    return tt, tj, pt, pj


def _same_run(tt, tj, pt, pj, **cfg):
    """simulate_switch of both packages: stats, completions, ejection log."""
    rt = tcore.simulate_switch(tt, pt, tcore.SwitchConfig(**cfg), record_ejections=True)
    rj = jcore.simulate_switch(tj, pj, jcore.SwitchConfig(**cfg), record_ejections=True)
    assert dataclasses.asdict(rt.stats) == dataclasses.asdict(rj.stats)
    assert np.array_equal(rt.completions, rj.completions)
    assert rt.ejections == rj.ejections
    return rt


# -- routing and the analytic model -------------------------------------------------

@pytest.mark.parametrize("name", TOPOLOGIES)
@pytest.mark.parametrize("n", [2, 4, 8, 9, 16])
def test_dor_route_matches_reference(name, n):
    tt, tj = tcore.make_topology(name, n), jcore.make_topology(name, n)
    for vcs in (1, 2, 3):
        for s in range(n):
            for d in range(n):
                assert tcore.dor_route(tt, s, d, vcs) == jcore.dor_route(tj, s, d, vcs)


def test_dor_route_refuses_unknown_topologies_as_the_reference_does():
    class Star(tcore.Topology):
        pass
    with pytest.raises(TypeError, match="no dimension-ordered routes"):
        tcore.dor_route(Star(4), 0, 1)


@pytest.mark.parametrize("name", TOPOLOGIES)
@pytest.mark.parametrize("pattern", PATTERNS)
def test_traffic_and_analytic_model_match_reference(name, pattern):
    """Packet lists, traffic matrices, link loads, lower bound and saturation
    rate equal the reference's."""
    n = 8 if name in ("ring", "fattree") else 16
    kw = dict(pattern=pattern, injection_rate=0.2, n_packets=6, hotspot=5, seed=3)
    tt, tj, pt, pj = _traffic(name, n, **kw)
    mt = tcore.traffic_matrix(tt, tcore.TrafficConfig(**kw))
    mj = jcore.traffic_matrix(tj, jcore.TrafficConfig(**kw))
    assert np.array_equal(mt, mj)
    assert [tcore.transpose_partner(tt, i) for i in range(n)] == \
        [jcore.transpose_partner(tj, i) for i in range(n)]
    for vcs in (1, 2):
        assert tcore.link_loads(tt, pt, vcs) == jcore.link_loads(tj, pj, vcs)
        assert tcore.saturation_rate(tt, mt, vcs) == jcore.saturation_rate(tj, mj, vcs)
    assert tcore.switch_lower_bound(tt, pt) == jcore.switch_lower_bound(tj, pj)


def test_traffic_config_and_edge_cases_match_reference():
    for kw in (dict(injection_rate=0.0), dict(hotspot_frac=1.5), dict(packet_flits=0),
               dict(burst_len=0), dict(n_packets=-1), dict(pattern="tornado")):
        with pytest.raises(ValueError) as et:
            tcore.TrafficConfig(**kw)
        with pytest.raises(ValueError) as ej:
            jcore.TrafficConfig(**kw)
        assert str(et.value) == str(ej.value)
    one = tcore.make_topology("ring", 1)
    for pattern in PATTERNS:
        cfg = tcore.TrafficConfig(pattern=pattern)
        assert tcore.generate_traffic(one, cfg) == []
        assert np.array_equal(tcore.traffic_matrix(one, cfg), np.zeros((1, 1)))
    assert tcore.saturation_rate(one, np.zeros((1, 1))) == float("inf")


# -- the cycle simulator: table 9's fast grid ------------------------------------------

@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("depth", [1, 4])
@pytest.mark.parametrize("frac", [0.3, 1.5])
def test_table9_grid_matches_reference(pattern, depth, frac):
    """benchmarks/run.py table9 (fast): 16-node mesh, 16 packets a node,
    offered load a fraction of the analytic saturation rate."""
    topo = tcore.make_topology("mesh", 16)
    sat = tcore.saturation_rate(topo, tcore.traffic_matrix(
        topo, tcore.TrafficConfig(pattern=pattern, hotspot=5)))
    tt, tj, pt, pj = _traffic("mesh", 16, pattern=pattern, hotspot=5,
                              injection_rate=frac * sat, n_packets=16, seed=0)
    res = _same_run(tt, tj, pt, pj, buffer_depth=depth)
    assert res.stats.packets == len(pt)
    assert res.stats.cycles >= tcore.switch_lower_bound(tt, pt)
    assert res.stats.max_queue <= depth


def test_torus_depth1_hotspot_gate_matches_reference():
    """Table 9's deadlock-freedom gate: dateline VCs keep a depth-1 torus
    under a hotspot mix live."""
    tt, tj, pt, pj = _traffic("torus", 16, pattern="hotspot", hotspot=5, hotspot_frac=0.7,
                              injection_rate=0.8, n_packets=16, seed=7)
    res = _same_run(tt, tj, pt, pj, buffer_depth=1)
    assert res.stats.packets == len(pt)


@pytest.mark.parametrize("name", TOPOLOGIES)
@pytest.mark.parametrize("n", [4, 9])
@pytest.mark.parametrize("depth", [1, 2, 3])
def test_random_traffic_matches_reference(name, n, depth):
    """n=4 takes the 2x2 torus, whose routers list each neighbor twice."""
    tt, tj, pt, pj = _traffic(name, n, pattern="uniform", injection_rate=0.6,
                              packet_flits=3, n_packets=10, seed=depth)
    _same_run(tt, tj, pt, pj, buffer_depth=depth)


@pytest.mark.parametrize("name", TOPOLOGIES)
@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("seed", [0, 5])
def test_throughput_within_link_load_rate_of_generated_packets(name, pattern, seed):
    """The port's own throughput property: every link and every ejection port
    moves at most one flit a cycle, so over the packets actually generated
    accepted throughput is at most flits / (n * the busiest channel's load).
    (The reference's gate against the expected traffic_matrix's saturation
    rate can be beaten by a finite sample; this one cannot.)"""
    topo = tcore.make_topology(name, 16 if name in ("mesh", "torus") else 8)
    n = topo.n_nodes
    for rate in (0.1, 2.0):
        pkts = tcore.generate_traffic(topo, tcore.TrafficConfig(
            pattern=pattern, injection_rate=rate, n_packets=8, hotspot=3, seed=seed))
        st = tcore.simulate_switch(topo, pkts, tcore.SwitchConfig(buffer_depth=2)).stats
        eject: dict[int, int] = {}
        for p in pkts:
            eject[p.dst] = eject.get(p.dst, 0) + p.n_flits
        busiest = max(max(tcore.link_loads(topo, pkts).values(), default=0),
                      max(eject.values()))
        assert st.cycles >= busiest
        assert st.throughput(n) <= st.flits / (n * busiest) + 1e-12
        assert st.cycles >= tcore.switch_lower_bound(topo, pkts)


def test_switch_config_errors_match_reference():
    tt, tj = tcore.make_topology("mesh", 4), jcore.make_topology("mesh", 4)
    for cfg, pk in ((dict(buffer_depth=0), [(0, 1, 1)]), (dict(n_vcs=0), [(0, 1, 1)]),
                    ({}, [(0, 1, 0)])):
        with pytest.raises(ValueError) as et:
            tcore.simulate_switch(tt, [tcore.Packet(*p) for p in pk], tcore.SwitchConfig(**cfg),
                                  verify=False)
        with pytest.raises(ValueError) as ej:
            jcore.simulate_switch(tj, [jcore.Packet(*p) for p in pk], jcore.SwitchConfig(**cfg),
                                  verify=False)
        assert str(et.value) == str(ej.value)
    with pytest.raises(ValueError, match="exceeds 2 flits"):
        tcore.simulate_switch(tt, [tcore.Packet(0, 1, 2, payload=np.zeros(5, np.uint8))])
    with pytest.raises(tcore.DeadlockError, match="max_cycles=3"):
        tcore.simulate_switch(tt, [tcore.Packet(0, 3, 40)], tcore.SwitchConfig(max_cycles=3))
    st = tcore.simulate_switch(tt, []).stats
    assert (st.cycles, st.avg_latency, st.throughput(4)) == (0, 0.0, 0.0)


def test_tracer_raises_until_the_telemetry_slice():
    """The telemetry slice has landed: both entry points take a tracer, and
    their events equal the reference's."""
    traces = []
    for core, tel in ((tcore, ttel), (jcore, jtel)):
        topo = core.make_topology("mesh", 4)
        tr = tel.Tracer()
        core.simulate_switch(topo, [core.Packet(0, 1, 1), core.Packet(2, 1, 3)], tracer=tr)
        cube = np.arange(32, dtype=np.uint8).reshape(4, 4, 2)
        core.simulate_wormhole_cube(topo, torch.as_tensor(cube) if core is tcore else cube,
                                    tracer=tr)
        traces.append([(e.ts, e.name, e.track, e.kind, e.dur, e.value, e.args)
                       for e in tr.events()])
    assert traces[0] == traces[1] and len(traces[0]) > 0


# -- payloads ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_payloads_delivered_on_their_own_device(kind):
    """Standalone payloads: the delivered bytes equal the reference's
    (zero-padded to whole flits), as numpy arrays or as tensors."""
    rng = np.random.default_rng(4)
    tt, tj = tcore.make_topology("torus", 9), jcore.make_topology("torus", 9)
    raw = [rng.integers(0, 255, int(rng.integers(1, 12)), dtype=np.uint8) for _ in range(30)]
    spec = [(int(rng.integers(9)), int(rng.integers(9)), int(rng.integers(0, 5))) for _ in raw]
    fb = 2
    pj = [jcore.Packet(s, d, -(-r.size // fb) + 1, t, payload=r) for (s, d, t), r in zip(spec, raw)]
    wrap = (lambda r: torch.as_tensor(r)) if kind == "tensor" else (lambda r: r)
    pt = [tcore.Packet(p.src, p.dst, p.n_flits, p.t_inject, payload=wrap(p.payload)) for p in pj]
    pt[3] = dataclasses.replace(pt[3], payload=None)
    pj[3] = dataclasses.replace(pj[3], payload=None)
    rt = tcore.simulate_switch(tt, pt, tcore.SwitchConfig(buffer_depth=1, flit_bytes=fb))
    rj = jcore.simulate_switch(tj, pj, jcore.SwitchConfig(buffer_depth=1, flit_bytes=fb))
    assert dataclasses.asdict(rt.stats) == dataclasses.asdict(rj.stats)
    assert rt.payloads[3] is None and rj.payloads[3] is None
    for got, want in zip(rt.payloads, rj.payloads):
        if want is None:
            continue
        assert isinstance(got, torch.Tensor if kind == "tensor" else np.ndarray)
        assert np.array_equal(np.asarray(got), want)


@pytest.mark.parametrize("name", TOPOLOGIES)
@pytest.mark.parametrize("depth", [1, 4])
def test_wormhole_cube_matches_reference(name, depth):
    """The cube adapter: delivered == the reference's delivery, equal stats,
    plain, with a pair layout and batched; a cube of another dtype than
    bytes is refused."""
    n = 9 if name != "ring" else 8
    rng = np.random.default_rng(depth)
    tt, tj = tcore.make_topology(name, n), jcore.make_topology(name, n)
    msgs = rng.integers(0, 255, (n, n, 7), dtype=np.uint8)
    pairs = [(s, d, int(rng.integers(0, 8))) for s in range(n) for d in range(n)]
    B = 3
    bmsgs = rng.integers(0, 255, (B, n, n, 5), dtype=np.uint8)
    for args, kw in (((msgs,), {}), ((msgs,), dict(pairs=pairs)), ((bmsgs,), dict(batched=True))):
        dt, st = tcore.simulate_wormhole_cube(tt, torch.as_tensor(args[0]),
                                              tcore.SwitchConfig(buffer_depth=depth), **kw)
        dj, sj = jcore.simulate_wormhole_cube(tj, args[0], jcore.SwitchConfig(buffer_depth=depth),
                                              **kw)
        assert np.array_equal(dt.numpy(), dj)
        assert dataclasses.asdict(st) == dataclasses.asdict(sj)
    with pytest.raises(TypeError, match="uint8"):
        tcore.simulate_wormhole_cube(tt, torch.zeros(n, n, 3))


def test_wormhole_cube_delivers_from_the_ejection_record(monkeypatch):
    """The delivered cube is rebuilt from the ejected tokens, not from a
    transpose: a token ejected at the wrong node moves its bytes there."""
    from repro_torch.core import switch

    topo = tcore.make_topology("mesh", 4)
    msgs = torch.arange(1, 33, dtype=torch.uint8).reshape(4, 4, 2)
    run = switch._run_switch

    def misroute(*a, **k):
        stats, comp, log, tokens = run(*a, **k)
        return stats, comp, log, [(p, f, (u + 1) % 4) for p, f, u in tokens]
    monkeypatch.setattr(switch, "_run_switch", misroute)
    got, _ = tcore.simulate_wormhole_cube(topo, msgs)
    assert not torch.equal(got, msgs.transpose(0, 1))
    assert torch.equal(got.roll(-1, 0), msgs.transpose(0, 1))


# -- the executor in mode="buffered" ---------------------------------------------------

def _diamond(core):
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
    return g


def _mixed(core, lib):
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
    return g


@pytest.mark.parametrize("name", TOPOLOGIES)
@pytest.mark.parametrize("depth", [1, 4])
def test_buffered_diamond_matches_sim_and_reference(name, depth):
    cfg = dict(switch_buffer_depth=depth)
    ex = tcore.NoCExecutor(_diamond(tcore), tcore.make_topology(name, 6),
                           cfg=tcore.NoCConfig(**cfg), device=CPU)
    exj = jcore.NoCExecutor(_diamond(jcore), jcore.make_topology(name, 6),
                            cfg=jcore.NoCConfig(**cfg))
    x = np.arange(4.0, dtype=np.float32)
    direct, _ = ex.run({"src.x": x}, mode="direct")
    sim, st_sim = ex.run({"src.x": x}, mode="sim")
    buf, st = ex.run({"src.x": x}, mode="buffered")
    ref, st_j = exj.run({"src.x": jnp.asarray(x)}, mode="buffered")
    for k in direct:
        assert torch.equal(buf[k], direct[k]) and torch.equal(buf[k], sim[k])
        assert np.array_equal(buf[k].numpy(), np.asarray(ref[k]))
    assert st.as_dict() == st_j.as_dict()
    assert st.switch_cycles == st.rounds > 0 and st.switch_max_queue <= depth
    for f in ("waves", "payload_bytes", "flits"):
        assert getattr(st, f) == getattr(st_sim, f)


def test_buffered_mixed_dtype_batch_and_iterative_match_reference():
    ex = tcore.NoCExecutor(_mixed(tcore, torch), tcore.make_topology("torus", 4), device=CPU)
    exj = jcore.NoCExecutor(_mixed(jcore, jnp), jcore.make_topology("torus", 4))
    x = np.arange(3.0, dtype=np.float32)
    buf, st = ex.run({"a.x": x}, mode="buffered")
    ref, st_j = exj.run({"a.x": jnp.asarray(x)}, mode="buffered")
    for k in ref:
        assert buf[k].dtype == tcore.torch_dtype(np.asarray(ref[k]).dtype)
        assert np.array_equal(buf[k].numpy(), np.asarray(ref[k]))
    assert st.as_dict() == st_j.as_dict()
    B = 3
    binp = {"a.x": np.stack([x * (b + 1) for b in range(B)])}
    bo, bst = ex.run_batch(binp, mode="buffered")
    so, sst = ex.run_batch(binp, mode="sim")
    _, bst_j = exj.run_batch({"a.x": jnp.asarray(binp["a.x"])}, mode="buffered")
    for k in so:
        assert torch.equal(bo[k], so[k])
    assert bst.as_dict() == bst_j.as_dict()
    assert bst.payload_bytes == sst.payload_bytes == 3 * 15 and bst.switch_cycles > 0
    ex = tcore.NoCExecutor(_diamond(tcore), tcore.make_topology("ring", 4), device=CPU)
    exj = jcore.NoCExecutor(_diamond(jcore), jcore.make_topology("ring", 4))
    feedback = [("join.out", "src.x")]
    out, st = ex.run_iterative({"src.x": x[:1].repeat(4)}, feedback, 3, mode="buffered")
    out_s, _ = ex.run_iterative({"src.x": x[:1].repeat(4)}, feedback, 3, mode="sim")
    _, st_j = exj.run_iterative({"src.x": jnp.asarray(x[:1].repeat(4))}, feedback, 3,
                                mode="buffered")
    assert torch.equal(out["join.out"], out_s["join.out"])
    assert st.as_dict() == st_j.as_dict() and st.waves == 9


def test_golden_stats_ldpc_fano_buffered():
    rng = np.random.default_rng(0)
    llr = tldpc.awgn_llr(np.zeros(7, np.int8), 3.0, rng)
    bits, _, st = tldpc.decode_on_noc(tldpc.fano_plane_H(), llr, 10, mode="buffered",
                                      device=CPU)
    assert not bits.any()
    assert st.as_dict() == GOLDEN_LDPC_FANO_BUFFERED


def test_golden_stats_bmvm_buffered():
    rng = np.random.default_rng(0)
    cfg = tbmvm.BMVMConfig(n=64, k=8, fold=2)
    A = rng.integers(0, 2, (64, 64)).astype(np.uint8)
    v = rng.integers(0, 2, (64,)).astype(np.uint8)
    lut = tbmvm.preprocess(A, cfg, device=CPU)
    out, st = tbmvm.iterate_noc_sim(lut, v, cfg, 2, topology="mesh", mode="buffered", device=CPU)
    assert np.array_equal(out.reshape(1, -1), jbmvm.software_ref(A, v[None], 2))
    assert st.as_dict() == GOLDEN_BMVM_BUFFERED


@pytest.mark.parametrize("name", TOPOLOGIES)
def test_buffered_apps_match_sim_and_reference(name):
    """All three case studies: buffered outputs equal sim's, and the
    buffered NoCStats equal the reference's on every topology."""
    rng = np.random.default_rng(0)
    llr = tldpc.awgn_llr(np.zeros(7, np.int8), 3.0, rng)
    H = tldpc.fano_plane_H()
    b_s, p_s, _ = tldpc.decode_on_noc(H, llr, 5, topology=name, device=CPU)
    b_b, p_b, st = tldpc.decode_on_noc(H, llr, 5, topology=name, mode="buffered", device=CPU)
    _, p_j, st_j = jldpc.decode_on_noc(H, llr, 5, topology=name, mode="buffered")
    assert np.array_equal(b_s, b_b) and np.array_equal(p_s, p_b)
    assert np.allclose(p_b, p_j, atol=1e-5) and st.as_dict() == st_j.as_dict()

    cfg, jcfg = tbmvm.BMVMConfig(n=64, k=8, fold=2), jbmvm.BMVMConfig(n=64, k=8, fold=2)
    A = rng.integers(0, 2, (64, 64)).astype(np.uint8)
    v = rng.integers(0, 2, (64,)).astype(np.uint8)
    lut = tbmvm.preprocess(A, cfg, device=CPU)
    o_s, _ = tbmvm.iterate_noc_sim(lut, v, cfg, 2, topology=name, device=CPU)
    o_b, st = tbmvm.iterate_noc_sim(lut, v, cfg, 2, topology=name, mode="buffered", device=CPU)
    _, st_j = jbmvm.iterate_noc_sim(jnp.asarray(jbmvm.preprocess(A, jcfg)), v, jcfg, 2,
                                    topology=name, mode="buffered")
    assert np.array_equal(o_s, o_b)
    assert np.array_equal(o_b.reshape(1, -1), jbmvm.software_ref(A, v[None], 2))
    assert st.as_dict() == st_j.as_dict()

    pcfg = tpf.PFConfig()
    frames, _ = tpf.synth_video(pcfg, 2, np.random.default_rng(0))
    c_s, _ = tpf.track_on_noc(frames, pcfg, topology=name, device=CPU)
    c_b, st = tpf.track_on_noc(frames, pcfg, topology=name, mode="buffered", device=CPU)
    _, st_j = jpf.track_on_noc(frames, jpf.PFConfig(), topology=name, mode="buffered")
    assert np.array_equal(c_s, c_b)
    assert st.as_dict() == st_j.as_dict()


@pytest.mark.parametrize("app", ["bmvm", "ldpc", "pf"])
def test_buffered_apps_cut_into_two_pods(app):
    """``mode="buffered"`` with ``pods=``: outputs and every non-bridge
    counter equal the uncut buffered run, the bridge counters are the
    analytic ones (equal to the bridged simulator's in ``sim``), and all of
    it equals the reference."""
    rng = np.random.default_rng(1)
    if app == "bmvm":
        cfg, jcfg = tbmvm.BMVMConfig(n=64, k=8, fold=2), jbmvm.BMVMConfig(n=64, k=8, fold=2)
        A = rng.integers(0, 2, (64, 64)).astype(np.uint8)
        v = rng.integers(0, 2, (64,)).astype(np.uint8)
        lut, lut_j = tbmvm.preprocess(A, cfg, device=CPU), jnp.asarray(jbmvm.preprocess(A, jcfg))
        pods = [0] * 4 + [1] * 4

        def run(mode, pods):
            return tbmvm.iterate_noc_sim(lut, v, cfg, 2, topology="mesh", mode=mode, pods=pods,
                                         device=CPU)
        ref = jbmvm.iterate_noc_sim(lut_j, v, jcfg, 2, topology="mesh", mode="buffered",
                                    pods=pods)
    elif app == "ldpc":
        llr = tldpc.awgn_llr(np.zeros(7, np.int8), 3.0, rng)
        H = tldpc.fano_plane_H()
        pods = [0] * 8 + [1] * 8

        def run(mode, pods):
            return tldpc.decode_on_noc(H, llr, 3, mode=mode, pods=pods, device=CPU)
        ref = jldpc.decode_on_noc(H, llr, 3, mode="buffered", pods=pods)
    else:
        pcfg = tpf.PFConfig(img=64, roi=16, n_particles=32)
        frames, _ = tpf.synth_video(pcfg, 3, rng)
        pods = [0] * 4 + [1] * 4

        def run(mode, pods):
            return tpf.track_on_noc(frames, pcfg, topology="torus", mode=mode, pods=pods,
                                    device=CPU)
        ref = jpf.track_on_noc(frames, jpf.PFConfig(img=64, roi=16, n_particles=32),
                               topology="torus", mode="buffered", pods=pods)
    cut, uncut, sim_cut = run("buffered", pods), run("buffered", None), run("sim", pods)
    st, st0, st_sim = cut[-1], uncut[-1], sim_cut[-1]
    for a, b in zip(cut[:-1], uncut[:-1]):
        assert np.array_equal(a, b)
    assert {k: v for k, v in st.as_dict().items() if not k.startswith(("bridge_", "cross_pod_"))} \
        == {k: v for k, v in st0.as_dict().items() if not k.startswith(("bridge_", "cross_pod_"))}
    assert st.bridge_counters() == st_sim.bridge_counters() and st.bridge_beats > 0
    assert st.cross_pod_msgs == st_sim.cross_pod_msgs > 0
    assert st.as_dict() == ref[-1].as_dict()
