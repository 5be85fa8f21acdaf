"""The port's static verifier (`repro_torch.analysis`) against the reference,
on the same inputs: every diagnostic's code, severity, ``where`` and message
must be equal.  Deadlock verdicts and culprit cycles, corrupted route
programs, wave layouts and bridged programs, capacity bounds against buffered
runs, traffic checks, the linters, ``NoCExecutor(verify=)`` (``"strict"`` by
default), the runtime deadlock report, and the CLI with ``--device cpu``."""
import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.analysis as JA  # noqa: E402
import repro.core as jcore  # noqa: E402
import repro_torch.analysis as TA  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro.analysis import lint as jlint  # noqa: E402
from repro.apps import ldpc as jldpc  # noqa: E402
from repro_torch.analysis import lint as tlint  # noqa: E402
from repro_torch.apps import ldpc as tldpc  # noqa: E402

TOPOLOGIES = ["ring", "mesh", "torus", "fattree"]
CPU = "cpu"


def _d(diags):
    return [(d.code, d.severity, d.where, d.message) for d in diags]


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


def _ldpc_inputs(H, llr, lib):
    inputs = {}
    for b in range(H.shape[1]):
        inputs[f"bit{b}.u0"] = lib(llr[b:b + 1].astype(np.float32))
    for c in range(H.shape[0]):
        for j_c, b in enumerate(np.nonzero(H[c])[0]):
            inputs[f"chk{c}.u{j_c}"] = lib(llr[b:b + 1].astype(np.float32))
    return inputs


def _ldpc():
    H = tldpc.fano_plane_H()
    llr = tldpc.awgn_llr(np.zeros(7, np.int8), 3.0, np.random.default_rng(0))
    return (tldpc.build_ldpc_graph(H)[0], jldpc.build_ldpc_graph(H)[0],
            _ldpc_inputs(H, llr, torch.as_tensor), _ldpc_inputs(H, llr, jnp.asarray))


# -- channel-dependency deadlock proofs ---------------------------------------------

@pytest.mark.parametrize("tname,n,vcs,safe", [
    ("ring", 8, 1, False), ("ring", 8, 2, True), ("ring", 2, 1, True), ("torus", 4, 1, True),
    ("torus", 16, 1, False), ("torus", 16, 2, True), ("mesh", 16, 1, True),
    ("fattree", 8, 1, True)])
def test_deadlock_verdicts_match_reference(tname, n, vcs, safe):
    tt, tj = tcore.make_topology(tname, n), jcore.make_topology(tname, n)
    cyc = TA.deadlock_cycle(tt, vcs)
    assert (cyc is None) == safe
    assert cyc == JA.deadlock_cycle(tj, vcs)
    assert TA.build_cdg(tt, vcs) == JA.build_cdg(tj, vcs)
    diags = TA.check_deadlock_freedom(tt, vcs, "w")
    assert _d(diags) == _d(JA.check_deadlock_freedom(tj, vcs, "w"))
    assert [d.code for d in diags] == ([] if safe else ["NOC001"])
    if not safe:
        for (u, v, _), (u2, _, _) in zip(cyc, cyc[1:] + cyc[:1]):
            assert v == u2


def test_check_deadlock_freedom_rejects_zero_vcs():
    diags = TA.check_deadlock_freedom(tcore.make_topology("mesh", 4), 0)
    assert _d(diags) == _d(JA.check_deadlock_freedom(jcore.make_topology("mesh", 4), 0))
    assert [d.code for d in diags] == ["NOC002"]


@pytest.mark.parametrize("tname", TOPOLOGIES)
@pytest.mark.parametrize("n", [2, 5, 9])
@pytest.mark.parametrize("vcs", [1, 2])
def test_verifier_verdict_matches_simulator(tname, n, vcs):
    """verifier-safe ⇒ a depth-1 all-to-all drains (stats equal to the
    reference's); verifier-cyclic ⇒ simulate_switch refuses the combination
    up front with the reference's message."""
    tt, tj = tcore.make_topology(tname, n), jcore.make_topology(tname, n)
    pairs = [(s, d) for s in range(n) for d in range(n) if s != d]
    pt, pj = [tcore.Packet(s, d, 2) for s, d in pairs], [jcore.Packet(s, d, 2) for s, d in pairs]
    kw = dict(buffer_depth=1, n_vcs=vcs, max_cycles=100_000)
    if TA.deadlock_cycle(tt, vcs) is None:
        rt = tcore.simulate_switch(tt, pt, tcore.SwitchConfig(**kw))
        rj = jcore.simulate_switch(tj, pj, jcore.SwitchConfig(**kw))
        assert rt.stats.packets == len(pairs)
        assert dataclasses.asdict(rt.stats) == dataclasses.asdict(rj.stats)
    else:
        with pytest.raises(ValueError, match="NOC001") as et:
            tcore.simulate_switch(tt, pt, tcore.SwitchConfig(**kw))
        with pytest.raises(ValueError) as ej:
            jcore.simulate_switch(tj, pj, jcore.SwitchConfig(**kw))
        assert str(et.value) == str(ej.value)


def test_runtime_deadlock_reports_the_reference_culprit_cycle():
    """ring 8 at one VC: verify=True refuses with NOC001 and the channel
    cycle; verify=False wedges and names the same wait cycle as the
    reference."""
    pk = [(s, (s + 4) % 8, 4) for s in range(8) for _ in range(4)]
    tt, tj = tcore.make_topology("ring", 8), jcore.make_topology("ring", 8)
    cfg = dict(buffer_depth=1, n_vcs=1, max_cycles=50_000)
    with pytest.raises(ValueError, match="NOC001") as et:
        tcore.simulate_switch(tt, [tcore.Packet(*p) for p in pk], tcore.SwitchConfig(**cfg))
    assert "->" in str(et.value) and "back to" in str(et.value)
    with pytest.raises(tcore.DeadlockError, match="culprit wait cycle") as et:
        tcore.simulate_switch(tt, [tcore.Packet(*p) for p in pk], tcore.SwitchConfig(**cfg),
                              verify=False)
    with pytest.raises(jcore.DeadlockError) as ej:
        jcore.simulate_switch(tj, [jcore.Packet(*p) for p in pk], jcore.SwitchConfig(**cfg),
                              verify=False)
    assert str(et.value) == str(ej.value)


def test_graph_and_wait_cycles_match_reference():
    for waits in ({1: 2, 2: 3, 3: 1, 9: 1}, {1: 2, 2: 3}, {}, {(0, 1): (1, 2), (1, 2): (0, 1)}):
        assert TA.find_wait_cycle(waits) == JA.find_wait_cycle(waits)
    for deps in ({1: {2}, 2: {3}, 3: {1}}, {1: {2, 3}, 2: set(), 3: {2}}, {}):
        assert TA.find_graph_cycle(deps) == JA.find_graph_cycle(deps)
    cyc = ((0, 1, 0), (1, 2, 0), (2, 0, 0))
    assert TA.format_channel_cycle(cyc) == JA.format_channel_cycle(cyc)
    tt, tj = tcore.make_topology("torus", 9), jcore.make_topology("torus", 9)
    for s in range(9):
        for d in range(9):
            assert TA.route_channels(tt, s, d, 2) == JA.route_channels(tj, s, d, 2)


# -- delivery proofs ------------------------------------------------------------------

@pytest.mark.parametrize("tname,n", [("ring", 8), ("mesh", 16), ("torus", 16), ("fattree", 8),
                                     ("ring", 5), ("mesh", 6)])
def test_route_programs_verify_clean(tname, n):
    assert TA.verify_route_program(tcore.compile_routes(tcore.make_topology(tname, n))) == []


def _corrupt_first_move(prog, **repl):
    ph = prog.phases[0]
    rnd = ph.rounds[0]
    mv = dataclasses.replace(rnd.moves[0], **repl)
    rnd = dataclasses.replace(rnd, moves=(mv,) + rnd.moves[1:])
    ph = dataclasses.replace(ph, rounds=(rnd,) + ph.rounds[1:])
    return dataclasses.replace(prog, phases=(ph,) + prog.phases[1:])


@pytest.mark.parametrize("corruption", ["erase", "misroute", "double"])
def test_corrupted_route_program_matches_reference(corruption):
    progs = {}
    for core, A in ((tcore, TA), (jcore, JA)):
        prog = core.compile_routes(core.make_topology("ring", 8))
        mv = prog.phases[0].rounds[0].moves[0]
        if corruption == "erase":
            bad = _corrupt_first_move(prog, src_table=tuple(-1 for _ in mv.src_table))
        elif corruption == "misroute":
            (s0, d0), *rest = mv.perm
            bad = _corrupt_first_move(prog, perm=((s0, (d0 + 1) % 8),) + tuple(rest))
        else:
            bad = _corrupt_first_move(prog, src_table=tuple(i for i, _ in enumerate(mv.src_table)))
        progs[core] = _d(A.verify_route_program(bad))
    assert progs[tcore] == progs[jcore]
    assert "NOC003" in {c for c, *_ in progs[tcore]}


@pytest.mark.parametrize("tname", TOPOLOGIES)
def test_wave_layouts_match_reference(tname):
    ex = tcore.NoCExecutor(_diamond(tcore), tcore.make_topology(tname, 6), device=CPU)
    exj = jcore.NoCExecutor(_diamond(jcore), jcore.make_topology(tname, 6))
    for w, (p, pj) in enumerate(zip(ex.programs, exj.programs)):
        assert np.array_equal(p.pack_host, pj.pack_idx)
        assert np.array_equal(p.gather_host, pj.gather_idx)
        assert torch.equal(p.pack_idx, torch.as_tensor(p.pack_host))
        assert torch.equal(p.gather_idx, torch.as_tensor(p.gather_host))
        assert p.pairs == pj.pairs
        assert TA.verify_wave_layout(p, 6, f"w{w}", ex.cfg.flit_wire_bytes) == []


@pytest.mark.parametrize("corruption", ["duplicate", "transpose", "extent", "length", "ragged"])
def test_corrupted_wave_layout_matches_reference(corruption):
    ex = tcore.NoCExecutor(_diamond(tcore), tcore.make_topology("mesh", 6), device=CPU)
    exj = jcore.NoCExecutor(_diamond(jcore), jcore.make_topology("mesh", 6))
    found = []
    for prog, pack_f, gather_f, A in (
            (next(p for p in ex.programs if p.pack_host.size > 1), "pack_host", "gather_host", TA),
            (next(p for p in exj.programs if p.pack_idx.size > 1), "pack_idx", "gather_idx", JA)):
        pack, gather = getattr(prog, pack_f).copy(), getattr(prog, gather_f).copy()
        kw, fb = {}, None
        if corruption == "duplicate":
            pack[1] = pack[0]
            kw = {pack_f: pack}
        elif corruption == "transpose":
            gather[0], gather[-1] = gather[-1], gather[0]
            kw = {gather_f: gather}
        elif corruption == "extent":
            kw = dict(pairs=tuple((s, d, 1) for s, d, _ in prog.pairs))
        elif corruption == "length":
            kw = {pack_f: pack[:-1]}
        else:
            fb = 3
        found.append(_d(A.verify_wave_layout(dataclasses.replace(prog, **kw), 6, "w", fb)))
    assert found[0] == found[1]
    assert {c for c, *_ in found[0]} == {"NOC003"}


def test_bridged_program_corruptions_match_reference():
    placement = {"src": 0, "l": 2, "r": 3, "join": 5}
    pods = [0, 0, 0, 1, 1, 1]
    out = []
    for core, A, kw in ((tcore, TA, dict(device=CPU)), (jcore, JA, {})):
        g = _diamond(core)
        ex = core.NoCExecutor(g, core.make_topology("mesh", 6), placement=placement,
                              plan=core.cut(g, placement, pods), **kw)
        bprog = ex._ensure_bridge()
        flipped = list(bprog.pod_of_node)
        flipped[0] = 1 - flipped[0]
        out.append([_d(A.verify_bridged_program(b)) for b in (
            bprog, dataclasses.replace(bprog, pod_of_node=(0, 0, 1)),
            dataclasses.replace(bprog, bridges=bprog.bridges[:-1]),
            dataclasses.replace(bprog, pod_of_node=tuple(flipped)))])
    assert out[0] == out[1]
    clean, short, dropped, relabeled = out[0]
    assert [c for c, *_ in clean if c != "NOC005"] == []
    assert "NOC008" in {c for c, *_ in short}
    assert "NOC004" in {c for c, *_ in dropped} and "NOC004" in {c for c, *_ in relabeled}


# -- capacity bounds --------------------------------------------------------------------

def _report(rep):
    d = dataclasses.asdict(rep)
    d["diagnostics"] = _d(rep.diagnostics)
    return d


@pytest.mark.parametrize("tname,n", [("ring", 8), ("mesh", 16), ("torus", 16), ("fattree", 8)])
def test_bounds_exact_and_sound_vs_buffered_ldpc(tname, n):
    gt, gj, inp, inp_j = _ldpc()
    ex = tcore.NoCExecutor(gt, tcore.make_topology(tname, n), device=CPU)
    exj = jcore.NoCExecutor(gj, jcore.make_topology(tname, n))
    rep = TA.executor_bounds(ex)
    assert _report(rep) == _report(JA.executor_bounds(exj))
    _, st = ex.run(inp, mode="buffered")
    assert (rep.flits, rep.payload_bytes, rep.link_bytes) == \
        (st.flits, st.payload_bytes, st.link_bytes)
    assert st.switch_max_queue <= rep.peak_queue
    assert st.switch_peak_link_flits <= rep.peak_link_flits


def test_queue_bound_tight_under_competing_flows():
    """Three sources streaming into one ejection port: the losing FIFOs fill
    to depth, bound == measured == depth, and NOC005 predicts it."""
    reps = []
    for core, kw in ((tcore, dict(device=CPU)), (jcore, {})):
        g = core.TaskGraph("star")
        for i in (1, 2, 3):
            g.add(core.PE(f"s{i}", lambda x: {"o": x * 2.0}, (core.Port("x", (32,)),),
                          (core.Port("o", (32,)),)))
        g.add(core.PE("sink", lambda a, b, c: {"y": a + b + c},
                      (core.Port("a", (32,)), core.Port("b", (32,)), core.Port("c", (32,))),
                      (core.Port("y", (32,)),)))
        for i, p in zip((1, 2, 3), "abc"):
            g.connect(f"s{i}.o", f"sink.{p}")
        reps.append(core.NoCExecutor(g, core.make_topology("ring", 4), verify="off",
                                     placement={"s1": 1, "s2": 2, "s3": 3, "sink": 0}, **kw))
    ex, exj = reps
    rep = TA.executor_bounds(ex)
    assert _report(rep) == _report(JA.executor_bounds(exj))
    _, st = ex.run({f"s{i}.x": np.arange(32.0, dtype=np.float32) + i for i in (1, 2, 3)},
                   mode="buffered")
    assert rep.peak_queue == st.switch_max_queue == ex.cfg.switch_buffer_depth
    assert any(d.code == "NOC005" for d in rep.diagnostics)


def test_bridge_counters_exact_vs_bridged_sim():
    gt, gj, inp, _ = _ldpc()
    pods = [0] * 8 + [1] * 8
    tt, tj = tcore.make_topology("mesh", 16), jcore.make_topology("mesh", 16)
    pl = tcore.place_round_robin(gt, tt)
    ex = tcore.NoCExecutor(gt, tt, placement=pl, plan=tcore.cut(gt, pl, pods), device=CPU)
    exj = jcore.NoCExecutor(gj, tj, placement=pl, plan=jcore.cut(gj, pl, pods))
    rep = TA.executor_bounds(ex)
    assert _report(rep) == _report(JA.executor_bounds(exj))
    _, st = ex.run(inp, mode="sim")
    assert (rep.bridge_beats, rep.bridge_wire_bytes, rep.bridge_stall_rounds,
            rep.bridge_peak_fifo) == (st.bridge_beats, st.bridge_wire_bytes,
                                      st.bridge_stall_rounds, st.bridge_peak_fifo)


def test_predicted_peaks_and_channel_loads_match_reference():
    tt, tj = tcore.make_topology("torus", 9), jcore.make_topology("torus", 9)
    pairs = [(s, (s * 4 + 1) % 9, 6 + s) for s in range(9)]
    assert TA.wave_channel_loads(tt, pairs, 2, 2) == JA.wave_channel_loads(tj, pairs, 2, 2)
    for depth in (1, 4, 64):
        assert TA.predicted_peaks(tt, pairs, 2, 2, depth) == \
            JA.predicted_peaks(tj, pairs, 2, 2, depth)
    assert TA.predicted_peaks(tt, [], 2, 2, 4) == (0, 0)


@pytest.mark.parametrize("tname,n", [("mesh", 16), ("ring", 1), ("torus", 9)])
@pytest.mark.parametrize("kw", [dict(injection_rate=0.01), dict(injection_rate=50.0),
                                dict(pattern="hotspot", injection_rate=0.1, hotspot=99),
                                dict(pattern="transpose", injection_rate=0.3)])
def test_check_traffic_codes_match_reference(tname, n, kw):
    got = TA.check_traffic(tcore.make_topology(tname, n), tcore.TrafficConfig(**kw))
    assert _d(got) == _d(JA.check_traffic(jcore.make_topology(tname, n), jcore.TrafficConfig(**kw)))
    assert {d.code for d in got} <= {"NOC006", "NOC014"}


# -- linters and the executor's verify= -------------------------------------------------

def test_lint_placement_and_graph_match_reference():
    gt, gj = _diamond(tcore), _diamond(jcore)
    tt, tj = tcore.make_topology("mesh", 4), jcore.make_topology("mesh", 4)
    ok = {"src": 0, "l": 1, "r": 2, "join": 3}
    missing = dict(ok)
    del missing["join"]
    for pl in (ok, {**ok, "ghost": 1, "join": 9}, missing):
        got = TA.lint_placement(gt, tt, pl)
        assert _d(got) == _d(JA.lint_placement(gj, tj, pl))
        assert {d.code for d in got} == (set() if pl is ok else {"NOC007"})
    assert TA.lint_graph(gt) == []
    for core, g in ((tcore, gt), (jcore, gj)):   # a channel added without connect()
        g.add(core.PE("big", lambda x: {"y": x}, (core.Port("x", (8,)),),
                      (core.Port("y", (8,)),)))
        g.channels.append(core.Channel("big", "y", "l", "a"))
    got = TA.lint_graph(gt)
    assert _d(got) == _d(JA.lint_graph(gj))
    assert [d.code for d in got] == ["NOC009", "NOC009"]


def test_lint_noc_config_matches_reference():
    tt, tj = tcore.make_topology("ring", 8), jcore.make_topology("ring", 8)
    for kw, codes in ((dict(), set()), (dict(flit_data_width=12), {"NOC010"}),
                      (dict(switch_vcs=1), {"NOC001"}), (dict(flit_data_width=24), {"NOC010"})):
        got = TA.lint_noc_config(tcore.NoCConfig(**kw), tt)
        assert _d(got) == _d(JA.lint_noc_config(jcore.NoCConfig(**kw), tj))
        assert {d.code for d in got} == codes
    for field in ("flit_data_width", "flit_buffer_depth", "bridge_fifo_depth",
                  "switch_buffer_depth", "switch_vcs"):
        with pytest.raises(ValueError, match="NOC012"):
            tcore.NoCConfig(**{field: 0})


def test_lint_model_config_on_the_ported_registry():
    from repro_torch import configs

    for smoke in (False, True):
        assert TA.lint_model_config(configs.get_config("whisper-large-v3", smoke=smoke),
                                    n_ranks=4) == []
    moe = configs.get_config("whisper-large-v3").replace(
        pattern=(("attn", "moe"),), n_experts=6, top_k=2, moe_impl="noc", moe_topology="hex")
    got = TA.lint_model_config(moe, n_ranks=4)
    assert [d.code for d in got] == ["NOC011", "NOC011"]
    assert "dense reference" in got[1].message


@pytest.mark.parametrize("arch", ["command-r-35b", "gemma-7b", "internvl2-1b",
                                  "jamba-v0.1-52b", "llama3.2-1b", "minicpm3-4b",
                                  "phi3.5-moe-42b-a6.6b", "qwen3-moe-235b-a22b",
                                  "whisper-large-v3", "xlstm-350m"])
def test_lint_configs_target_matches_reference(arch):
    """The CLI's ``configs`` target over the port's registry: each arch, FULL
    and SMOKE, lints to the reference's diagnostics for the same arch (with
    and without MoE layers grafted on, so the NOC011 paths are compared too)."""
    from repro import configs as jconfigs
    from repro_torch import configs as tconfigs

    got = {w: _d(d) for w, d in tlint._lint_configs()}
    want = {w: _d(d) for w, d in jlint._lint_configs()}
    assert set(got) == {f"configs/{n}{s}" for n in tconfigs.ALL_ARCHS for s in ("", "/smoke")}
    for tag in (f"configs/{arch}", f"configs/{arch}/smoke"):
        assert got[tag] == want[tag]
    moe = dict(pattern=(("attn", "moe"),), n_experts=6, top_k=2, moe_impl="noc")
    for smoke in (False, True):
        t = tconfigs.get_config(arch, smoke=smoke).replace(**moe)
        j = jconfigs.get_config(arch, smoke=smoke).replace(**moe)
        assert _d(TA.lint_model_config(t, n_ranks=4)) == _d(JA.lint_model_config(j, n_ranks=4))


def test_executor_verify_modes():
    g = _diamond(tcore)
    bad = tcore.NoCConfig(switch_vcs=1)
    ring = tcore.make_topology("ring", 8)
    with pytest.raises(TA.VerificationError) as ei:       # strict is the default
        tcore.NoCExecutor(g, ring, cfg=bad, device=CPU)
    with pytest.raises(JA.VerificationError) as ej:
        jcore.NoCExecutor(_diamond(jcore), jcore.make_topology("ring", 8),
                          cfg=jcore.NoCConfig(switch_vcs=1))
    assert _d(ei.value.diagnostics) == _d(ej.value.diagnostics)
    assert str(ei.value) == str(ej.value)
    with pytest.warns(UserWarning, match="NOC001"):
        ex = tcore.NoCExecutor(g, ring, cfg=bad, verify="warn", device=CPU)
    assert "NOC001" in {d.code for d in ex.verification}
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ex = tcore.NoCExecutor(g, ring, cfg=bad, verify="off", device=CPU)
    assert ex.verification == []
    ex = tcore.NoCExecutor(g, ring, device=CPU)
    exj = jcore.NoCExecutor(_diamond(jcore), jcore.make_topology("ring", 8))
    assert TA.errors(ex.verification) == [] and _d(ex.verification) == _d(exj.verification)
    with pytest.raises(ValueError, match="verify"):
        tcore.NoCExecutor(g, ring, verify="loud", device=CPU)


def test_default_executor_runs_strict_and_flags_bad_placement():
    with pytest.raises(TA.VerificationError) as ei:
        tcore.NoCExecutor(_diamond(tcore), tcore.make_topology("mesh", 4), device=CPU,
                          placement={"src": 0, "l": 1, "r": 2, "join": 77})
    with pytest.raises(JA.VerificationError) as ej:
        jcore.NoCExecutor(_diamond(jcore), jcore.make_topology("mesh", 4),
                          placement={"src": 0, "l": 1, "r": 2, "join": 77})
    assert "NOC007" in {d.code for d in ei.value.diagnostics}
    assert _d(ei.value.diagnostics) == _d(ej.value.diagnostics)


@pytest.mark.parametrize("pods", [None, [0] * 3 + [1] * 3])
@pytest.mark.parametrize("tname", TOPOLOGIES)
def test_verify_executor_matches_reference(tname, pods):
    placement = {"src": 0, "l": 2, "r": 3, "join": 5}
    found = []
    for core, A, kw in ((tcore, TA, dict(device=CPU)), (jcore, JA, {})):
        g = _diamond(core)
        plan = core.cut(g, placement, pods) if pods else None
        ex = core.NoCExecutor(g, core.make_topology(tname, 6), placement=placement, plan=plan,
                              verify="off", **kw)
        found.append(_d(A.verify_executor(ex)))
    assert found[0] == found[1]


def test_lint_apps_match_reference():
    """The CLI's ``apps`` target: the three case studies' default executors
    verify to the reference's diagnostics."""
    got = tlint._lint_apps(CPU)
    want = jlint._lint_apps()
    assert [(w, _d(d)) for w, d in got] == [(w, _d(d)) for w, d in want]
    assert [(w, _d(d)) for w, d in tlint._lint_benchmarks()] == \
        [(w, _d(d)) for w, d in jlint._lint_benchmarks()]


@pytest.mark.parametrize("argv,rc", [
    (["benchmarks"], 0), (["configs"], 0), (["nope"], 2), (["apps", "--device", "cpu"], 0),
    (["--device", "cpu"], 0), (["apps", "--device", "cpu", "--strict-warnings"], 1),
    (["benchmarks", "--device", "tpu"], 2), (["configs", "--device"], 2)])
def test_lint_cli_exit_codes(argv, rc, capsys):
    assert tlint.main(argv) == rc
    out = capsys.readouterr().out
    if rc != 2:
        assert out.splitlines()[-1].startswith("lint: 0 error(s)")


def test_lint_cli_apps_needs_a_gpu_by_default():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlint.main(["apps"])


def test_diagnostic_records_match_reference():
    assert TA.CODES == JA.CODES
    for code in TA.CODES:
        t, j = TA.diag(code, "m", "w"), JA.diag(code, "m", "w")
        assert (str(t), t.severity) == (str(j), j.severity)
    ds = [TA.diag("NOC005", "a"), TA.diag("NOC001", "b", "x")]
    js = [JA.diag("NOC005", "a"), JA.diag("NOC001", "b", "x")]
    assert TA.format_diagnostics(ds) == JA.format_diagnostics(js)
    assert TA.format_diagnostics([]) == JA.format_diagnostics([]) == "no findings"
    assert _d(TA.errors(ds)) == _d(JA.errors(js))
