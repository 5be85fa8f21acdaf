"""The port's latency profiler and regression diff against the reference, on
the CPU: ``profile_trace`` over the topology × app × {sim, buffered, bridged}
grid and ``sim_python`` (every ``LatencyRecord``, ``WaveProfile``, critical
path, flow table and report equal to the reference's, the decomposition
identity exact), the analytic-bound identities of the bare switch, zero
records allocated unless the profiler runs, strict refusal of a dropped
trace, the saved-trace round trip, the ``noc.latency.*`` publication, and
``regress.compare_rows``/``metric_class`` on the reference's own rows."""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
import repro.telemetry as jtel  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.telemetry as ttel  # noqa: E402
from repro.telemetry import regress as jregress  # noqa: E402
from repro_torch.telemetry import regress as tregress  # noqa: E402

from test_torch_telemetry import (APPS, TOPOLOGIES, VARIANTS, bmvm_executor,  # noqa: E402
                                  events, traced_pair, variant_args)


def fields(x):
    """Profile parts as plain tuples (they compare across packages)."""
    if dataclasses.is_dataclass(x):
        return tuple((f.name, fields(getattr(x, f.name))) for f in dataclasses.fields(x))
    if isinstance(x, (list, tuple)):
        return tuple(fields(v) for v in x)
    if isinstance(x, dict):
        return {k: fields(v) for k, v in x.items()}
    return x.item() if isinstance(x, np.generic) else x


def assert_same_profile(tt, jt):
    pt = ttel.profile_trace(tt).check_exact()
    pj = jtel.profile_trace(jt).check_exact()
    assert pt.records, "profiled run produced no latency records"
    assert fields(pt.records) == fields(pj.records)
    assert fields(pt.waves) == fields(pj.waves)
    assert (pt.links, pt.modes) == (pj.links, pj.modes)
    cp = pt.critical_path()
    assert fields(cp) == fields(pj.critical_path())
    assert cp.length == tt.clock == sum(w.dur for w in pt.waves)
    assert sum(c for _, c in cp.attribution) == cp.gap == sum(w.gap for w in pt.waves)
    assert pt.flows() == pj.flows()
    assert pt.report() == pj.report()
    for r in pt.records:
        assert r.serialization + r.hop + r.queueing + r.bridge == r.latency > 0
    return pt


@pytest.mark.parametrize("topology", TOPOLOGIES)
@pytest.mark.parametrize("app", list(APPS))
@pytest.mark.parametrize("variant", VARIANTS)
def test_profile_matches_reference_grid(topology, app, variant):
    mode, cut = variant_args(variant)
    tt, _, jt, _ = traced_pair(app, topology, mode, cut)
    prof = assert_same_profile(tt, jt)
    if variant == "buffered":
        assert {r.kind for r in prof.records} == {"pkt"}
        assert any(w.kind == "switch" for w in prof.waves)
    else:
        assert {r.kind for r in prof.records} == {"msg"}
    if variant == "bridged":
        # a schedule wave is a barrier: every message carries the wave's stall
        for w in prof.waves:
            assert all(r.bridge == w.bridge_stalls for r in prof.records if r.wave == w.index)


@pytest.mark.parametrize("cut", [False, True])
def test_profile_sim_python_matches_reference(cut):
    tt, _, jt, _ = traced_pair("ldpc", "torus", "sim_python", cut)
    assert_same_profile(tt, jt)


@pytest.mark.parametrize("topology,n", [("mesh", 16), ("ring", 8), ("torus", 16)])
def test_single_packet_meets_bound_exactly(topology, n):
    topo = tcore.make_topology(topology, n)
    pkts = [tcore.Packet(0, n - 1, 4)]
    tr = ttel.Tracer()
    res = tcore.simulate_switch(topo, pkts, tracer=tr)
    prof = ttel.profile_trace(tr).check_exact()
    (r,) = prof.records
    cp = prof.critical_path()
    assert r.latency == cp.length == tcore.switch_lower_bound(topo, pkts) == res.stats.cycles
    assert (r.queueing, r.bridge, r.serialization, r.hop) == (0, 0, 4, r.hops)
    assert cp.gap == 0 and not cp.attribution


def test_contended_run_attributes_every_gap_cycle_like_reference():
    profs = []
    for core, tel in ((tcore, ttel), (jcore, jtel)):
        pkts = [core.Packet(s, 15, 8) for s in range(3)]
        tr = tel.Tracer()
        res = core.simulate_switch(core.make_topology("mesh", 16), pkts, tracer=tr)
        profs.append((tel.profile_trace(tr).check_exact(), res.stats.cycles,
                      core.switch_lower_bound(core.make_topology("mesh", 16), pkts)))
    (pt, cycles, bound), (pj, _, _) = profs
    assert fields(pt.waves) == fields(pj.waves) and fields(pt.records) == fields(pj.records)
    w = pt.waves[0]
    assert cycles > bound and w.gap == cycles - bound
    assert sum(c for _, c in w.attribution) == w.gap and all(c > 0 for _, c in w.attribution)
    assert any(r.queueing > 0 for r in pt.records)


def test_bridged_gap_names_the_gating_bridge():
    tt, _, jt, _ = traced_pair("ldpc", "torus", "sim", True)
    prof = assert_same_profile(tt, jt)
    stalls = sum(w.bridge_stalls for w in prof.waves)
    assert stalls > 0
    bridge_attr = [(res, c) for res, c in prof.critical_path().attribution
                   if res.startswith("bridge ")]
    assert bridge_attr and sum(c for _, c in bridge_attr) == stalls
    assert any(r.bridge > 0 for r in prof.records)


# -- zero overhead off, strictness -----------------------------------------------------------

def test_profiling_disabled_allocates_no_records():
    ex, inputs, feedback = bmvm_executor()
    ev0, rec0 = ttel.events_allocated(), ttel.records_allocated()
    ex.run_iterative(inputs, feedback, 2, mode="sim")
    ex.run_iterative(inputs, feedback, 2, mode="buffered")
    assert (ttel.events_allocated(), ttel.records_allocated()) == (ev0, rec0)
    ex2, inputs2, feedback2 = bmvm_executor(trace=True)
    ex2.run_iterative(inputs2, feedback2, 1, mode="buffered")
    assert ttel.events_allocated() > ev0 and ttel.records_allocated() == rec0
    ttel.profile_trace(ex2.tracer)
    assert ttel.records_allocated() > rec0


def test_profile_strict_refuses_dropped_events():
    ex, inputs, feedback = bmvm_executor(trace=ttel.Tracer(capacity=32))
    ex.run_iterative(inputs, feedback, 2, mode="buffered")
    assert ex.tracer.dropped > 0
    with pytest.raises(ValueError, match="dropped"):
        ttel.profile_trace(ex.tracer)
    ttel.profile_trace(ex.tracer, strict=False).check_exact()   # survivors stay exact


# -- saved traces, flows, publication -----------------------------------------------------------

def test_events_from_chrome_roundtrip():
    tt, _, jt, _ = traced_pair("bmvm", "mesh", "buffered", True)
    doc = json.loads(json.dumps(ttel.chrome_trace(tt)))
    evs = ttel.events_from_chrome(doc)
    assert ttel.trace_stats(evs).as_dict() == ttel.trace_stats(tt).as_dict()
    p1, p2 = ttel.profile_trace(tt).check_exact(), ttel.profile_trace(evs).check_exact()
    assert fields(p1.records) == fields(p2.records)
    assert p1.critical_path().length == p2.critical_path().length and p1.links == p2.links
    assert fields(p2.records) == fields(jtel.profile_trace(jtel.events_from_chrome(doc)).records)


def test_publish_noc_latency_schema_matches_reference():
    tt, _, jt, _ = traced_pair("pf", "mesh", "buffered", True)
    snaps = []
    for tel, tr in ((ttel, tt), (jtel, jt)):
        reg = tel.enable_metrics()
        try:
            tel.profile_trace(tr).publish(mode="buffered")
        finally:
            tel.disable_metrics()
        snaps.append(reg.snapshot())
        hists = reg.histograms("noc.latency.")
        assert {h.name for h in hists.values()} >= {
            "noc.latency.total", "noc.latency.serialization", "noc.latency.hop",
            "noc.latency.queueing", "noc.latency.bridge", "noc.latency.flow"}
        total = reg.histogram("noc.latency.total", mode="buffered")
        assert sum(reg.histogram(f"noc.latency.{c}", mode="buffered").total
                   for c in ("serialization", "hop", "queueing", "bridge")) == total.total
    assert snaps[0] == snaps[1]
    ttel.profile_trace(tt).publish()   # no registry: a no-op


# -- the regression diff ------------------------------------------------------------------------

@pytest.mark.parametrize("key,value", [
    ("us", 1.0), ("seed_loop_us", 1.0), ("speedup_vs_sw", 1.0), ("tok_per_s", 1.0),
    ("traced_over_untraced", 1.2), ("cycles", 100), ("stalls", 100), ("crit", 98),
    ("deadlock_free", "True"), ("ok", True)])
def test_metric_class_matches_reference(key, value):
    assert tregress.metric_class(key, value) == jregress.metric_class(key, value)
    assert tregress._fmt(value) == jregress._fmt(value)
    if not isinstance(value, (str, bool)):
        for new in (value * 0.5, value * 2):
            assert tregress._worse(key, value, new) == jregress._worse(key, value, new)


BASE = [{"name": "t_x", "us": 10.0, "cycles": 100, "accepted": 0.5}]
GATE = [{"name": "t_gate", "us": 0.0, "deadlock_free": "True"},
        {"name": "t_only_base", "us": 0.0, "cycles": 1}]
COMPARE_CASES = {
    "unchanged": (BASE, [dict(BASE[0])], {}),
    "counter_worse": (BASE, [{**BASE[0], "cycles": 120}], {}),
    "counter_better": (BASE, [{**BASE[0], "cycles": 90}], {}),
    "accepted_drops": (BASE, [{**BASE[0], "accepted": 0.4}], {}),
    "timing_within": ([{"name": "t_x", "us": 100.0}], [{"name": "t_x", "us": 110.0}],
                      dict(timing_tol=0.25)),
    "timing_beyond": ([{"name": "t_x", "us": 100.0}], [{"name": "t_x", "us": 200.0}],
                      dict(timing_tol=0.25)),
    "timing_gate_off": ([{"name": "t_x", "us": 100.0}], [{"name": "t_x", "us": 900.0}],
                        dict(gate_timing=False)),
    "text_and_presence": (GATE, [{"name": "t_gate", "us": 0.0, "deadlock_free": "False"},
                                 {"name": "t_new", "us": 1.0}], {}),
}


@pytest.mark.parametrize("case", list(COMPARE_CASES))
def test_compare_rows_matches_reference(case):
    base, new, kw = COMPARE_CASES[case]
    found = tregress.compare_rows(base, new, **kw)
    assert found == jregress.compare_rows(base, new, **kw)
    verdicts = [f["verdict"] for f in found]
    if case in ("unchanged", "timing_within", "timing_gate_off"):
        assert found == []
    elif case in ("counter_worse", "accepted_drops", "timing_beyond"):
        assert verdicts == ["regression"]
    elif case == "counter_better":
        assert verdicts == ["improvement"]
    else:
        assert sorted(verdicts) == ["drift", "regression", "regression"]


def test_profile_of_the_empty_and_raw_traces():
    """A trace with no events profiles to nothing; a bare switch run traced
    outside an executor is one ``switch_raw`` wave."""
    empty = ttel.profile_trace(ttel.Tracer())
    assert (empty.records, empty.waves) == ([], [])
    assert events(ttel.Tracer()) == []
    tr = ttel.Tracer()
    tcore.simulate_switch(tcore.make_topology("ring", 4), [tcore.Packet(0, 2, 3)], tracer=tr)
    tcore.simulate_switch(tcore.make_topology("ring", 4), [tcore.Packet(1, 3, 2)], tracer=tr)
    assert [w.kind for w in ttel.profile_trace(tr).check_exact().waves] == ["switch_raw"] * 2
