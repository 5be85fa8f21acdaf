"""The port's telemetry against the reference, on the CPU: the event stream of
every engine (the same events, in the same order, with the same ``ts``,
``dur``, ``value`` and ``args``) over the topology × app × {sim, buffered,
bridged} grid and ``sim_python`` uncut and cut; ``trace_stats`` equal to the
port's ``NoCStats`` field for field; the high-water marks, the ring buffer's
bound and ``strict=`` refusal; zero events allocated when off; the deadlock
event; the Perfetto export, its validation and round trip; the heatmap with
bridge links; the metrics registry (histogram quantiles, snapshot, Prometheus
text, the engines' ``noc.*`` publication); the ``python -m
repro_torch.telemetry`` CLI with ``--device cpu``; and ``serve --metrics``.

The same seeded inputs go through ``repro`` and ``repro_torch``; everything is
compared exactly (``==``), after turning the reference's numpy scalars into
Python ones."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
import repro.telemetry as jtel  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.telemetry as ttel  # noqa: E402
from repro.apps import bmvm as jbmvm  # noqa: E402
from repro.apps import ldpc as jldpc  # noqa: E402
from repro.apps import particle_filter as jpf  # noqa: E402
from repro_torch.apps import bmvm as tbmvm  # noqa: E402
from repro_torch.apps import ldpc as tldpc  # noqa: E402
from repro_torch.apps import particle_filter as tpf  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402

TOPOLOGIES = ["ring", "mesh", "torus", "fattree"]
VARIANTS = ["sim", "buffered", "bridged"]
CPU = "cpu"


def pods_of(n):
    return [0] * (n // 2) + [1] * (n - n // 2)


def _py(v):
    return v.item() if isinstance(v, np.generic) else v


def events(tr):
    """A trace as plain tuples, numpy scalars turned into Python ones."""
    return [(e.ts, e.name, e.track, e.kind, e.dur, _py(e.value),
             None if e.args is None else {k: _py(v) for k, v in e.args.items()})
            for e in (tr.events() if hasattr(tr, "events") else tr)]


def assert_python_scalars(tr):
    """The port's events carry Python scalars only: they serialize and compare."""
    for e in tr.events():
        for v in [e.ts, e.dur, e.value] + list((e.args or {}).values()):
            assert type(v) in (int, float, str, bool), (e, type(v))
    json.dumps(ttel.chrome_trace(tr))


def run_bmvm(pkg, topology, mode, pods, tracer):
    rng = np.random.default_rng(0)
    A = rng.integers(0, 2, (64, 64)).astype(np.uint8)
    v = rng.integers(0, 2, (64,)).astype(np.uint8)
    if pkg == "torch":
        cfg = tbmvm.BMVMConfig(n=64, k=8, fold=2)
        _, st = tbmvm.iterate_noc_sim(tbmvm.preprocess(A, cfg, device=CPU), v, cfg, 2,
                                      topology=topology, mode=mode, pods=pods, tracer=tracer,
                                      device=CPU)
    else:
        cfg = jbmvm.BMVMConfig(n=64, k=8, fold=2)
        _, st = jbmvm.iterate_noc_sim(jbmvm.preprocess(A, cfg), v, cfg, 2, topology=topology,
                                      mode=mode, pods=pods, tracer=tracer)
    return st


def run_ldpc(pkg, topology, mode, pods, tracer):
    llr = jldpc.awgn_llr(np.zeros(7, np.int8), 4.0, np.random.default_rng(0))
    if pkg == "torch":
        _, _, st = tldpc.decode_on_noc(tldpc.fano_plane_H(), llr, 2, topology=topology,
                                       n_nodes=16, mode=mode, pods=pods, tracer=tracer,
                                       device=CPU)
    else:
        _, _, st = jldpc.decode_on_noc(jldpc.fano_plane_H(), llr, 2, topology=topology,
                                       n_nodes=16, mode=mode, pods=pods, tracer=tracer)
    return st


def run_pf(pkg, topology, mode, pods, tracer):
    mod = tpf if pkg == "torch" else jpf
    cfg = mod.PFConfig(img=48, roi=12, n_particles=32, n_bins=12)
    frames, _ = mod.synth_video(cfg, 3, np.random.default_rng(0))
    kw = dict(device=CPU) if pkg == "torch" else {}
    _, st = mod.track_on_noc(frames, cfg, n_pe=4, topology=topology, n_nodes=8, mode=mode,
                             pods=pods, tracer=tracer, **kw)
    return st


APPS = {"bmvm": (run_bmvm, 8), "ldpc": (run_ldpc, 16), "pf": (run_pf, 8)}


def traced_pair(app, topology, mode, cut, **tracer_kw):
    """The same traced run in both packages: (port tracer, port stats,
    reference tracer, reference stats)."""
    run, n_nodes = APPS[app]
    pods = pods_of(n_nodes) if cut else None
    tt, jt = ttel.Tracer(**tracer_kw), jtel.Tracer(**tracer_kw)
    st_t = run("torch", topology, mode, pods, tt)
    st_j = run("jax", topology, mode, pods, jt)
    return tt, st_t, jt, st_j


def variant_args(variant):
    return ("buffered" if variant == "buffered" else "sim"), variant == "bridged"


def assert_same_trace(tt, st_t, jt, st_j):
    assert tt.dropped == jt.dropped == 0
    assert events(tt) == events(jt)
    assert tt.clock == jt.clock
    assert st_t.as_dict() == st_j.as_dict()
    assert ttel.trace_stats(tt).as_dict() == st_t.as_dict()
    assert_python_scalars(tt)


# -- the event stream and trace_stats, the whole grid ----------------------------------

@pytest.mark.parametrize("topology", TOPOLOGIES)
@pytest.mark.parametrize("app", list(APPS))
@pytest.mark.parametrize("variant", VARIANTS)
def test_trace_events_match_reference_grid(topology, app, variant):
    mode, cut = variant_args(variant)
    tt, st_t, jt, st_j = traced_pair(app, topology, mode, cut)
    assert_same_trace(tt, st_t, jt, st_j)
    if variant == "bridged":
        assert st_t.cross_pod_msgs > 0 and any(e.name == "bridge_tx" for e in tt.events())
    if variant == "buffered":
        assert st_t.switch_cycles > 0 and any(e.name == "pkt" for e in tt.events())


@pytest.mark.parametrize("app", list(APPS))
@pytest.mark.parametrize("cut", [False, True])
def test_sim_python_events_match_reference(app, cut):
    tt, st_t, jt, st_j = traced_pair(app, "mesh", "sim_python", cut)
    assert_same_trace(tt, st_t, jt, st_j)
    if cut:
        assert st_t.bridge_peak_fifo > 0


def test_sim_python_events_equal_sim_events():
    """The seed loop and the compiled engine give one event stream, but for
    the ``run`` and ``route`` spans that name the mode."""
    a, _, _, _ = traced_pair("bmvm", "torus", "sim", True)
    b, _, _, _ = traced_pair("bmvm", "torus", "sim_python", True)

    def strip(tr):
        return [e[:6] + ({k: v for k, v in (e[6] or {}).items() if k != "mode"},)
                for e in events(tr)]
    assert strip(a) == strip(b)


def test_high_water_marks_buffered_bridged_match_reference():
    tt, st_t, jt, st_j = traced_pair("ldpc", "mesh", "buffered", True)
    assert_same_trace(tt, st_t, jt, st_j)
    agg = ttel.trace_stats(tt)
    assert st_t.switch_max_queue > 0 and st_t.bridge_peak_fifo > 0
    assert (agg.switch_max_queue, agg.bridge_peak_fifo, agg.switch_peak_link_flits) == \
        (st_t.switch_max_queue, st_t.bridge_peak_fifo, st_t.switch_peak_link_flits)


def test_run_batch_and_iterative_share_one_clock():
    """run_batch traces the batch factor on every ``msg`` (``n``), and the
    clock runs on across runs: trace_stats of the whole trace is the sum."""
    ex, inputs, feedback = bmvm_executor(trace=True)
    binp = {k: torch.stack([v.view(torch.int32), v.view(torch.int32) ^ 1]).view(torch.uint32)
            for k, v in inputs.items()}
    _, st_b = ex.run_batch(binp, mode="buffered")
    n_batch = len(ex.tracer)
    _, st_i = ex.run_iterative(inputs, feedback, 2, mode="sim")
    ns = [e.args["n"] for e in ex.tracer.events() if e.name == "msg"]
    n_first = sum(e.name == "msg" for e in ex.tracer.events()[:n_batch])
    assert ns == [2] * n_first + [1] * (len(ns) - n_first) and n_first > 0
    assert ttel.trace_stats(ex.tracer).as_dict() == st_b.add(st_i).as_dict()


# -- zero overhead when off ----------------------------------------------------------------

def bmvm_executor(trace=None):
    rng = np.random.default_rng(0)
    cfg = tbmvm.BMVMConfig(n=64, k=8, fold=2)
    A = rng.integers(0, 2, (64, 64)).astype(np.uint8)
    v = rng.integers(0, 2, (64,)).astype(np.uint8)
    g, feedback = tbmvm.build_bmvm_graph(tbmvm.preprocess(A, cfg, device=CPU), cfg)
    vw = kref.gf2_pack_vector(torch.as_tensor(v), cfg.k).view(torch.uint32)
    f = cfg.fold
    inputs = {f"lut{i}.v": vw[i * f:(i + 1) * f] for i in range(cfg.n_pe)}
    ex = tcore.NoCExecutor(g, tcore.make_topology("mesh", 2 * cfg.n_pe), trace=trace,
                           device=CPU)
    return ex, inputs, feedback


def test_tracing_disabled_allocates_nothing():
    ex, inputs, feedback = bmvm_executor()
    assert ex.tracer is None                     # default is off
    before = ttel.events_allocated()
    ex.run_iterative(inputs, feedback, 2, mode="sim")
    ex.run_iterative(inputs, feedback, 2, mode="buffered")
    ex.run_iterative(inputs, feedback, 2, mode="sim_python")
    tbmvm.iterate_noc_sim(tbmvm.preprocess(np.eye(64, dtype=np.uint8),
                                           tbmvm.BMVMConfig(n=64, k=8, fold=2), device=CPU),
                          np.ones(64, np.uint8), tbmvm.BMVMConfig(n=64, k=8, fold=2), 1,
                          pods=pods_of(8), device=CPU)
    assert ttel.events_allocated() == before


def test_tracer_true_constructs_fresh():
    ex, inputs, feedback = bmvm_executor(trace=True)
    assert isinstance(ex.tracer, ttel.Tracer)
    ex.run_iterative(inputs, feedback, 1, mode="sim")
    assert len(ex.tracer) > 0 and ex.tracer.clock > 0


# -- the ring buffer --------------------------------------------------------------------------

def test_ring_buffer_bounded_and_strict():
    for tel in (ttel, jtel):
        tr = tel.Tracer(capacity=16)
        for i in range(100):
            tr.instant("msg", "node 0", ts=i, src=0, dst=1, bytes=4, flits=1, n=1)
        assert (len(tr), tr.emitted, tr.dropped) == (16, 100, 84)
        with pytest.raises(ValueError, match="dropped"):
            tel.trace_stats(tr)
        assert tel.trace_stats(tr, strict=False).payload_bytes == 16 * 4
        tr.clear()
        assert (len(tr), tr.emitted, tr.clock) == (0, 0, 0)


@pytest.mark.parametrize("kwargs", [dict(capacity=0), dict(detail="everything")])
def test_tracer_rejects_bad_args(kwargs):
    for tel in (ttel, jtel):
        with pytest.raises(ValueError):
            tel.Tracer(**kwargs)


@pytest.mark.parametrize("variant", ["buffered", "bridged", "buffered_bridged"])
def test_overflow_keeps_the_reference_suffix(variant):
    """Ring-buffer overflow on the real engines: both packages keep the same
    24 newest events, strict aggregation refuses, ``strict=False`` folds the
    survivors and can only undercount."""
    mode = "sim" if variant == "bridged" else "buffered"
    tt, st_t, jt, _ = traced_pair("ldpc", "mesh", mode, variant != "buffered", capacity=24)
    assert tt.dropped == jt.dropped > 0 and len(tt) == 24
    assert events(tt) == events(jt)
    with pytest.raises(ValueError, match="dropped"):
        ttel.trace_stats(tt)
    partial = ttel.trace_stats(tt, strict=False)
    for f in ("payload_bytes", "flits", "link_bytes", "switch_max_queue", "bridge_wire_bytes"):
        assert getattr(partial, f) <= getattr(st_t, f)


# -- the switch on its own -------------------------------------------------------------------

def test_switch_deadlock_event_matches_reference():
    pk_t = [tcore.Packet(s, (s + 4) % 8, 4) for s in range(8)]
    pk_j = [jcore.Packet(s, (s + 4) % 8, 4) for s in range(8)]
    traces = []
    for core, pkts, tel in ((tcore, pk_t, ttel), (jcore, pk_j, jtel)):
        tr = tel.Tracer()
        with pytest.raises(core.DeadlockError) as err:
            core.simulate_switch(core.make_topology("ring", 8), pkts,
                                 core.SwitchConfig(buffer_depth=1, n_vcs=1, max_cycles=20_000),
                                 verify=False, tracer=tr)
        traces.append((events(tr), str(err.value)))
    assert traces[0] == traces[1]
    dead = [e for e in traces[0][0] if e[1] == "deadlock"]
    assert len(dead) == 1 and dead[0][6]["wedged"] > 0 and dead[0][6]["wait_cycle"] > 0


@pytest.mark.parametrize("detail", ["cycles", "flits"])
def test_switch_trace_with_idle_gaps_matches_reference(detail):
    """Staggered injections (idle fast-forwards) under both details; one
    ``flit`` event per link move under ``"flits"``."""
    spec = [(0, 15, 6, 0), (3, 12, 4, 0), (5, 10, 3, 40), (15, 0, 8, 41), (6, 6, 2, 90)]
    runs = []
    for core, tel in ((tcore, ttel), (jcore, jtel)):
        tr = tel.Tracer(detail=detail)
        tr.clock = 7
        res = core.simulate_switch(core.make_topology("torus", 16),
                                   [core.Packet(*p) for p in spec], tracer=tr)
        runs.append((events(tr), res.stats))
    assert runs[0][0] == runs[1][0]
    names = [e[1] for e in runs[0][0]]
    assert "idle_ff" in names
    assert names.count("flit") == (runs[0][1].link_flits if detail == "flits" else 0)


def test_switch_and_cube_accept_a_tracer():
    topo = tcore.make_topology("mesh", 4)
    tr = ttel.Tracer()
    tcore.simulate_switch(topo, [tcore.Packet(0, 3, 2)], tracer=tr)
    cube = torch.arange(32, dtype=torch.uint8).reshape(4, 4, 2)
    delivered, st = tcore.simulate_wormhole_cube(topo, cube, tracer=tr)
    assert torch.equal(delivered, cube.transpose(0, 1))
    assert sum(e.name == "switch_run" for e in tr.events()) == 2


# -- exporters ------------------------------------------------------------------------------

def test_chrome_trace_schema_roundtrip(tmp_path):
    tt, st, jt, _ = traced_pair("bmvm", "mesh", "sim", False)
    doc = ttel.chrome_trace(tt)
    assert json.loads(json.dumps(doc)) == json.loads(json.dumps(jtel.chrome_trace(jt)))
    n = ttel.validate_chrome_trace(doc)
    assert n == len(doc["traceEvents"])
    path = tmp_path / "trace.json"
    ttel.write_chrome_trace(str(path), tt)
    loaded = json.loads(path.read_text())
    assert ttel.validate_chrome_trace(loaded) == n
    util = ttel.link_utilization(tt)
    assert util == ttel.link_utilization(loaded) == jtel.link_utilization(jt)
    assert sum(util.values()) == st.link_bytes
    assert ttel.heatmap(util) == jtel.heatmap(util)
    assert ttel.heatmap(util, csv=True) == jtel.heatmap(util, csv=True)
    back = ttel.events_from_chrome(loaded)
    assert events(back) == events(jtel.events_from_chrome(loaded))
    assert ttel.trace_stats(back).as_dict() == st.as_dict()


@pytest.mark.parametrize("mode", ["sim", "buffered"])
def test_heatmap_includes_bridge_links(mode):
    tt, st, jt, _ = traced_pair("ldpc", "mesh", mode, True)
    assert st.cross_pod_msgs > 0 and st.bridge_wire_bytes > 0
    util = ttel.link_utilization(tt)
    assert util == jtel.link_utilization(jt)
    routers = ttel.link_utilization([e for e in tt.events() if e.name != "bridge_tx"])
    assert sum(util.values()) - sum(routers.values()) == st.bridge_wire_bytes
    assert sum(routers.values()) == st.link_bytes
    assert ttel.heatmap(util) == jtel.heatmap(util)
    assert len(ttel.heatmap(util, csv=True).splitlines()) == len(util) + 1


def test_chrome_trace_tamper_rejected():
    tr = ttel.Tracer()
    tr.span("wave", "noc", 0, 2, wave=0)
    doc = ttel.chrome_trace(tr)
    assert ttel.validate_chrome_trace(doc) == len(doc["traceEvents"])
    bad = json.loads(json.dumps(doc))
    bad["traceEvents"][-1]["ph"] = "Z"
    bad2 = json.loads(json.dumps(doc))
    del bad2["traceEvents"][-1]["ts"]
    bad3 = json.loads(json.dumps(doc))
    bad3["traceEvents"] = [e for e in bad3["traceEvents"] if e["name"] != "thread_name"]
    for d in (bad, bad2, bad3, {"nope": []}):
        with pytest.raises(ValueError):
            ttel.validate_chrome_trace(d)
        with pytest.raises(ValueError):
            jtel.validate_chrome_trace(d)


# -- metrics registry -----------------------------------------------------------------------

SAMPLES = {"linspace": list(np.linspace(0.001, 1.0, 1000)),
           "lognormal": list(np.random.default_rng(3).lognormal(-4, 1.5, 777)),
           "with_underflow": [0.0, -2.0, 0.5, 3.0, 3.0, 1e-6],
           "single": [7.3], "empty": []}


@pytest.mark.parametrize("case", list(SAMPLES))
def test_histogram_quantiles_match_reference(case):
    ht = ttel.MetricsRegistry().histogram("t.seconds")
    hj = jtel.MetricsRegistry().histogram("t.seconds")
    for v in SAMPLES[case]:
        ht.observe(float(v))
        hj.observe(float(v))
    qs = (0.0, 0.1, 0.5, 0.9, 0.99, 0.999, 1.0)
    assert [ht.quantile(q) for q in qs] == [hj.quantile(q) for q in qs]
    assert (ht.count, ht.total, ht.vmin, ht.vmax, ht.mean, ht.buckets) == \
        (hj.count, hj.total, hj.vmin, hj.vmax, hj.mean, hj.buckets)
    with pytest.raises(ValueError):
        ht.quantile(1.5)


def _fill(reg):
    reg.counter("noc.rounds", mode="sim").inc(5)
    reg.counter("noc.rounds", mode="sim").inc(2)
    reg.gauge("noc.peak", mode="sim").set_max(3)
    reg.gauge("noc.peak", mode="sim").set_max(2)
    reg.gauge("serve.batch").set(4)
    for v in (0.1, 0.2, 0.4, 0.0):
        reg.histogram("step.seconds", phase="a-b").observe(v)
    reg.histogram("empty.series")
    return reg


def test_registry_snapshot_and_prometheus_match_reference():
    rt, rj = _fill(ttel.MetricsRegistry()), _fill(jtel.MetricsRegistry())
    assert rt.snapshot() == rj.snapshot()
    assert rt.prometheus() == rj.prometheus()
    assert rt.snapshot()["gauges"]["noc.peak{mode=sim}"] == 3
    assert list(rt.histograms("step.")) == list(rj.histograms("step."))
    with rt.timer("t.seconds") as h:
        pass
    assert h.count == 1 and h.total >= 0
    with pytest.raises(ValueError):
        rt.counter("noc.rounds", mode="sim").inc(-1)


@pytest.mark.parametrize("mode", ["sim", "buffered", "sim_python"])
def test_engine_publishes_into_registry_like_reference(mode):
    snaps = []
    for pkg, tel in (("torch", ttel), ("jax", jtel)):
        reg = tel.enable_metrics()
        try:
            st = run_bmvm(pkg, "mesh", mode, pods_of(8), None)
        finally:
            tel.disable_metrics()
        snaps.append((reg.snapshot(), st.as_dict()))
    assert snaps[0] == snaps[1]
    snap, st = snaps[0]
    label = f"{{mode={mode},topology=Mesh2D}}"
    assert snap["counters"]["noc.rounds" + label] == st["rounds"]
    assert snap["gauges"]["noc.bridge_peak_fifo" + label] == st["bridge_peak_fifo"]
    assert ttel.get_registry() is None


def test_moe_and_step_metrics_share_the_schema():
    """The MoE and train-step publishers: the reference's names, a 0-d
    tensor read back as a float at publish time, non-scalars skipped."""
    class Dispatch:
        engine, topology, capacity, capacity_factor = "noc", "fattree", 8, 1.5
        flits, rounds, link_bytes, drops, peak_occupancy = 64, 12, 4096, 3, 7

    assert ttel.STEP_METRIC_NAMES == jtel.STEP_METRIC_NAMES
    assert ttel.MOE_METRIC_NAMES == jtel.MOE_METRIC_NAMES
    rt, rj = ttel.MetricsRegistry(), jtel.MetricsRegistry()
    rt.record_moe_stats(Dispatch)
    rj.record_moe_stats(Dispatch)
    rt.record_step_metrics({"moe_drops": torch.tensor(2), "moe_peak_occupancy": 9.0,
                            "loss": torch.tensor(1.0)})
    rj.record_step_metrics({"moe_drops": 2, "moe_peak_occupancy": 9.0, "loss": 1.0})
    assert rt.snapshot() == rj.snapshot()
    snap = rt.snapshot()
    rt.record_step_metrics({"moe_drops": torch.ones(3)})     # not a scalar: skipped
    assert rt.snapshot() == snap
    Dispatch.drops = torch.ones(2)
    rt.record_moe_stats(Dispatch)
    assert rt.snapshot()["counters"]["noc.moe.drops{engine=noc,topology=fattree}"] == 3


# -- the CLI and serve --metrics --------------------------------------------------------------

@pytest.mark.parametrize("app", ["bmvm", "ldpc", "pf"])
def test_cli_emits_the_reference_perfetto(app, tmp_path, capsys):
    from repro.telemetry.__main__ import main as jmain
    from repro_torch.telemetry.__main__ import main as tmain

    out_t, out_j = tmp_path / "t.json", tmp_path / "j.json"
    tmain(["--app", app, "--iters", "2", "--out", str(out_t), "--device", "cpu"])
    text = capsys.readouterr().out
    jmain(["--app", app, "--iters", "2", "--out", str(out_j)])
    assert "parity OK (bit-exact)" in text
    doc = json.loads(out_t.read_text())
    assert ttel.validate_chrome_trace(doc) > 0
    assert doc == json.loads(out_j.read_text())
    assert text == capsys.readouterr().out.replace(str(out_j), str(out_t))


def test_cli_profile_and_metrics(tmp_path, capsys):
    from repro_torch.telemetry.__main__ import main

    snap = tmp_path / "m.json"
    main(["--app", "bmvm", "--mode", "buffered", "--pods", "--profile", "--metrics",
          str(snap), "--detail", "flits", "--csv", "--device", "cpu"])
    text = capsys.readouterr().out
    assert "bottleneck report" in text and "src,dst,bytes" in text
    hists = json.loads(snap.read_text())["histograms"]
    assert any(k.startswith("noc.latency.total{") for k in hists)
    assert any(k.startswith("noc.switch_cycles{") for k in json.loads(snap.read_text())["counters"])
    assert ttel.get_registry() is None


def test_cli_defaults_to_the_gpu():
    from repro_torch.telemetry.__main__ import main

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--app", "bmvm", "--iters", "1"])


def test_serve_metrics_matches_reference(tmp_path, capsys):
    from repro.launch import serve as jserve
    from repro_torch.launch import serve as tserve

    pt, pj = tmp_path / "t.json", tmp_path / "j.json"
    argv = ["--arch", "whisper-large-v3", "--smoke", "--requests", "6", "--batch", "4",
            "--prompt-len", "8", "--gen", "5"]
    toks = tserve.run(argv + ["--device", "cpu", "--metrics", str(pt)])
    text = capsys.readouterr().out
    jserve.run(argv + ["--metrics", str(pj)])
    st, sj = json.loads(pt.read_text()), json.loads(pj.read_text())
    assert st.keys() == sj.keys() and st["histograms"].keys() == sj["histograms"].keys()
    assert {k: h["count"] for k, h in st["histograms"].items()} == \
        {k: h["count"] for k, h in sj["histograms"].items()} == \
        {"serve.decode.seconds": 2 * 4, "serve.prefill.seconds": 2}
    assert "decode/token: p50" in text and ttel.get_registry() is None
    assert np.array_equal(toks, tserve.run(argv + ["--device", "cpu"]))
    tserve.run(argv + ["--device", "cpu", "--metrics", "-"])
    printed = capsys.readouterr().out
    assert json.loads(printed[printed.index("{"):])["histograms"].keys() == sj["histograms"].keys()
