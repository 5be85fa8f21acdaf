"""Latency profiler: trace events → per-packet records, critical path, gaps
(port of ``repro.telemetry.profile``).

`telemetry.trace_stats` proves a trace reproduces the run's *totals*;
this module answers the next question — **where did the cycles go?**  It
consumes the same `Tracer` stream (nothing is re-simulated) and rebuilds:

* one :class:`LatencyRecord` per delivered packet (buffered transport,
  from ``pkt`` events) or per message (schedule transports, from ``msg``
  events), with the inject→eject latency on the logical clock decomposed
  into **serialization + hop + queueing + bridge** components that sum to
  the measured latency *bit-exactly* — the decomposition is an accounting
  identity, not an estimate (`Profile.check_exact` enforces it, and
  ``tests/test_torch_profile.py`` differential-tests it across the topology ×
  app × mode grid);
* one :class:`WaveProfile` per wave with the analytic lower bound for that
  wave (`switch_lower_bound` via the ``switch_run`` event for the buffered
  switch, max hop distance for the schedule transports) and a **gap
  attribution**: every cycle above the bound is charged to a named
  resource — a hot link, arbitration losses at that link, credit stalls,
  or a saturated bridge (``bridge {s}->{d}``).  Attribution entries sum to
  the wave's gap exactly;
* the **critical path**: waves execute back-to-back on the logical clock,
  so the run's critical path chains each wave's slowest record; its length
  equals the final clock value, and on an uncontended single-packet run it
  collapses to ``latency == switch_lower_bound`` exactly (tested).

Decomposition semantics:

================  =====================================================
component         meaning
================  =====================================================
serialization     pure pipeline occupancy: ``n_flits`` tail cycles for a
                  wormhole packet; the scatter+gather ticks (2) for a
                  schedule message
hop               dimension-ordered hop distance src→dst (head traversal)
queueing          everything contention adds: credit stalls, arbitration
                  losses, schedule rounds beyond the hop distance —
                  computed as the exact remainder, so the identity
                  ``latency == ser + hop + queueing + bridge`` holds by
                  construction
bridge            stall rounds the quasi-SERDES bridges added to the
                  wave (schedule messages; buffered packets carry 0 —
                  the bridge overlay there is wave-level and appears in
                  the wave's gap attribution instead)
================  =====================================================

Zero-overhead-off mirrors the tracer contract: no ``LatencyRecord`` is
allocated unless :func:`profile_trace` is called (`records_allocated` is
the test hook, the analog of ``events_allocated``).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Iterable, Optional, Union

from .tracer import TraceEvent, Tracer

# module-wide allocation counter: the zero-overhead-when-off property is
# tested as "this number does not move unless profile_trace runs"
_N_RECORDS = 0


def records_allocated() -> int:
    """Total LatencyRecords allocated in this process (test/debug hook)."""
    return _N_RECORDS


_LINK_TRACK = re.compile(r"^(link|bridge) (\d+)->(\d+)$")


@dataclasses.dataclass(frozen=True)
class LatencyRecord:
    """One delivered packet/message on the logical clock.

    ``kind`` — ``"pkt"`` (buffered wormhole packet) or ``"msg"`` (schedule
    message).  ``n`` — batch multiplicity (schedule messages carry the
    wave's batch factor; the latency is per item, the multiplicity scales
    the flow counts).  The component identity is checked by :attr:`exact`.
    """

    kind: str
    src: int
    dst: int
    t_inject: int
    t_eject: int
    flits: int
    hops: int
    serialization: int
    hop: int
    queueing: int
    bridge: int
    wave: int
    n: int = 1

    def __post_init__(self):
        global _N_RECORDS
        _N_RECORDS += 1

    @property
    def latency(self) -> int:
        return self.t_eject - self.t_inject

    @property
    def exact(self) -> bool:
        """The accounting identity: components sum to measured latency."""
        return (self.serialization + self.hop + self.queueing + self.bridge
                == self.latency)


@dataclasses.dataclass
class WaveProfile:
    """Per-wave accounting: duration, analytic bound, attributed gap.

    ``kind``: ``"switch"`` (buffered wave), ``"schedule"`` (sim/spmd wave),
    ``"switch_raw"`` (a bare `simulate_switch` run traced outside the
    executor — no wave span), ``"idle"`` (message-free wave).  ``rounds``
    is schedule rounds or switch cycles; ``gap`` is the cycles above
    ``bound`` plus bridge stalls, and ``attribution`` is a list of
    ``(resource, cycles)`` pairs summing to ``gap`` exactly.
    """

    index: int
    t0: int
    dur: int
    kind: str
    mode: str
    rounds: int
    bridge_stalls: int
    bound: int
    gap: int
    attribution: list
    stalls: int = 0
    arb: int = 0
    hot_link: Optional[str] = None
    n_records: int = 0


@dataclasses.dataclass(frozen=True)
class CriticalPath:
    """The longest dependency chain through the run.

    Waves are barriers on the logical clock, so the chain is one segment
    per wave — the wave's slowest element (max-latency packet/message, or
    the bare phase for idle waves).  ``length`` is the sum of wave
    durations == the final logical clock; ``gap`` and ``attribution`` are
    the merged above-bound accounting across all segments.
    """

    length: int
    segments: list
    gap: int
    attribution: list

    def __str__(self) -> str:
        steps = " -> ".join(s[1] for s in self.segments) or "(empty)"
        return f"critical path {self.length} ticks: {steps}"


@dataclasses.dataclass
class Profile:
    """The full profiler output for one trace (see module docstring)."""

    records: list
    waves: list
    links: dict
    modes: list

    # -- invariants --------------------------------------------------------
    def check_exact(self) -> "Profile":
        """Raise unless every record's decomposition sums exactly and every
        wave's attribution sums to its gap.  Returns self for chaining."""
        for r in self.records:
            if not r.exact:
                raise ValueError(
                    f"inexact decomposition for {r.kind} {r.src}->{r.dst} "
                    f"wave {r.wave}: ser={r.serialization} hop={r.hop} "
                    f"queue={r.queueing} bridge={r.bridge} != lat={r.latency}")
        for w in self.waves:
            attributed = sum(c for _, c in w.attribution)
            if attributed != w.gap:
                raise ValueError(
                    f"wave {w.index}: attribution sums to {attributed}, "
                    f"gap is {w.gap}")
        return self

    # -- critical path -----------------------------------------------------
    def critical_path(self) -> CriticalPath:
        segments, length, gap = [], 0, 0
        attr: dict = {}
        for w in self.waves:
            length += w.dur
            gap += w.gap
            for res, c in w.attribution:
                attr[res] = attr.get(res, 0) + c
            recs = [r for r in self.records if r.wave == w.index]
            if recs:
                worst = max(recs, key=lambda r: (r.latency, r.src, r.dst))
                desc = (f"wave {w.index} [{w.kind}] {worst.kind} "
                        f"{worst.src}->{worst.dst} lat={worst.latency}")
            else:
                desc = f"wave {w.index} [{w.kind}] dur={w.dur}"
            segments.append((w.index, desc, w.dur))
        merged = sorted(attr.items(), key=lambda kv: (-kv[1], kv[0]))
        return CriticalPath(length, segments, gap, merged)

    # -- flows -------------------------------------------------------------
    def flows(self) -> dict:
        """Per-(src, dst) latency stats from *exact sample quantiles* (the
        registry's `Histogram` is bucketed; this reads the raw records)."""
        by_flow: dict = {}
        for r in self.records:
            by_flow.setdefault((r.src, r.dst), []).extend([r.latency] * r.n)
        out = {}
        for flow, lats in sorted(by_flow.items()):
            lats.sort()
            k = len(lats)
            out[flow] = {
                "count": k,
                "p50": lats[max(0, -(-50 * k // 100) - 1)],
                "p99": lats[max(0, -(-99 * k // 100) - 1)],
                "p999": lats[max(0, -(-999 * k // 1000) - 1)],
                "max": lats[-1],
                "mean": sum(lats) / k,
            }
        return out

    # -- registry publication ---------------------------------------------
    def publish(self, registry=None, **labels) -> None:
        """Observe every record into ``noc.latency.*`` histograms.

        Schema (p50/p99/p99.9 via `Histogram.quantile`):

        * ``noc.latency.total`` — inject→eject latency
        * ``noc.latency.serialization`` / ``.hop`` / ``.queueing`` /
          ``.bridge`` — the components (same multiplicities, so component
          histogram sums equal the total histogram sum)
        * ``noc.latency.flow{flow="s->d"}`` — per-flow totals

        ``registry=None`` publishes into the process-wide registry if one
        is enabled, else is a no-op (the standard publisher guard).
        """
        if registry is None:
            from .metrics import get_registry

            registry = get_registry()
            if registry is None:
                return
        for r in self.records:
            for _ in range(r.n):
                registry.histogram("noc.latency.total", **labels).observe(r.latency)
                registry.histogram("noc.latency.serialization", **labels).observe(r.serialization)
                registry.histogram("noc.latency.hop", **labels).observe(r.hop)
                registry.histogram("noc.latency.queueing", **labels).observe(r.queueing)
                registry.histogram("noc.latency.bridge", **labels).observe(r.bridge)
                registry.histogram("noc.latency.flow",
                                   flow=f"{r.src}->{r.dst}", **labels).observe(r.latency)

    # -- human-readable bottleneck report ----------------------------------
    def report(self, top: int = 8) -> str:
        cp = self.critical_path()
        total = sum(r.latency * r.n for r in self.records)
        comp = {"serialization": 0, "hop": 0, "queueing": 0, "bridge": 0}
        for r in self.records:
            comp["serialization"] += r.serialization * r.n
            comp["hop"] += r.hop * r.n
            comp["queueing"] += r.queueing * r.n
            comp["bridge"] += r.bridge * r.n
        lines = ["bottleneck report",
                 "=" * 17,
                 f"modes: {', '.join(self.modes) or '(raw switch)'}   "
                 f"waves: {len(self.waves)}   records: "
                 f"{sum(r.n for r in self.records)}",
                 f"critical path: {cp.length} ticks over "
                 f"{len(cp.segments)} wave(s); gap above bounds: {cp.gap}",
                 "",
                 "latency decomposition (record-cycles, sums exactly):"]
        for k in ("serialization", "hop", "queueing", "bridge"):
            pct = 100.0 * comp[k] / total if total else 0.0
            lines.append(f"  {k:<14} {comp[k]:>10}  ({pct:5.1f}%)")
        lines.append(f"  {'total':<14} {total:>10}")
        lines.append("")
        lines.append("gap attribution (cycles above analytic bound):")
        if cp.attribution:
            for res, c in cp.attribution[:top]:
                lines.append(f"  {c:>8}  {res}")
        else:
            lines.append("  (none — the run met its lower bounds)")
        lines.append("")
        lines.append("flows (exact sample quantiles, top by p99):")
        flows = sorted(self.flows().items(),
                       key=lambda kv: (-kv[1]["p99"], kv[0]))
        for (s, d), st in flows[:top]:
            lines.append(f"  {s:>3}->{d:<3} n={st['count']:<6} "
                         f"p50={st['p50']:<6} p99={st['p99']:<6} "
                         f"p99.9={st['p999']:<6} max={st['max']}")
        hot = sorted(self.links.items(), key=lambda kv: (-kv[1], kv[0]))
        if hot:
            lines.append("")
            lines.append("hottest links (bytes):")
            for track, b in hot[:top]:
                lines.append(f"  {b:>10}  {track}")
        lines.append("")
        lines.append("critical path:")
        for _, desc, dur in cp.segments[:top]:
            lines.append(f"  +{dur:<5} {desc}")
        if len(cp.segments) > top:
            lines.append(f"  ... {len(cp.segments) - top} more wave(s)")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# the profiler proper: one pass over the event stream
# ---------------------------------------------------------------------------

class _WaveState:
    """Accumulates one wave's child events until its ``wave`` span lands."""

    __slots__ = ("msgs", "pkts", "n_rounds", "max_c", "stalls", "arb",
                 "sw_ts", "sw_bound", "bridge_stalls", "links")

    def __init__(self):
        self.msgs: list = []          # (ts, args) per msg instant
        self.pkts: list = []          # args per pkt instant
        self.n_rounds = 0
        self.max_c = -1
        self.stalls = 0
        self.arb = 0
        self.sw_ts: Optional[int] = None
        self.sw_bound = 0
        self.bridge_stalls: list = []  # (rounds, src, dst)
        self.links: dict = {}          # "link s->d" / "bridge s->d" -> bytes

    @property
    def pending(self) -> bool:
        return bool(self.msgs or self.pkts or self.n_rounds or
                    self.max_c >= 0 or self.bridge_stalls or self.links)


def _hot_link(ws: _WaveState) -> Optional[str]:
    if not ws.links:
        return None
    return max(ws.links.items(), key=lambda kv: (kv[1], kv[0]))[0]


def _finalize_wave(prof: Profile, ws: _WaveState, index: int, t0: int,
                   dur: int, mode: str, kind: str) -> None:
    """Turn one wave's accumulated events into records + a WaveProfile.

    The component arithmetic here IS the decomposition contract — every
    branch constructs the components so they sum to the measured latency
    identically (see module docstring); `Profile.check_exact` re-verifies.
    """
    hot = _hot_link(ws)
    for track, b in ws.links.items():
        prof.links[track] = prof.links.get(track, 0) + b
    bridge_rounds = sum(r for r, _, _ in ws.bridge_stalls)
    attribution: list = [(f"bridge {s}->{d}", r)
                         for r, s, d in ws.bridge_stalls if r]

    if ws.pkts:  # buffered switch wave (or raw switch run)
        base = ws.sw_ts if ws.sw_ts is not None else t0 + 1
        cycles = ws.max_c + 1
        if kind == "switch_raw":
            dur = cycles
        for a in ws.pkts:
            lat = a["lat"]
            prof.records.append(LatencyRecord(
                kind="pkt", src=a["src"], dst=a["dst"],
                t_inject=base + a["inject"],
                t_eject=base + a["inject"] + lat,
                flits=a["flits"], hops=a["hops"],
                serialization=a["flits"], hop=a["hops"],
                queueing=lat - a["flits"] - a["hops"], bridge=0,
                wave=index))
        sgap = max(0, cycles - ws.sw_bound) if ws.sw_ts is not None else 0
        if sgap:
            at = hot or "switch"
            contended = ws.stalls + ws.arb
            if contended:
                arb_share = min(sgap, round(sgap * ws.arb / contended))
                stall_share = sgap - arb_share
                if stall_share:
                    attribution.append((f"credit stall @ {at}", stall_share))
                if arb_share:
                    attribution.append((f"arbitration @ {at}", arb_share))
            else:
                attribution.append((f"serialization @ {at}", sgap))
        prof.waves.append(WaveProfile(
            index=index, t0=t0, dur=dur, kind=kind, mode=mode,
            rounds=cycles, bridge_stalls=bridge_rounds,
            bound=ws.sw_bound, gap=sgap + bridge_rounds,
            attribution=attribution, stalls=ws.stalls, arb=ws.arb,
            hot_link=hot, n_records=len(ws.pkts)))
    elif ws.msgs:  # schedule wave: every message spans the whole wave
        rounds = ws.n_rounds
        stall = dur - 2 - rounds   # bridge stalls stretch the route phase
        max_hops = 0
        for ts, a in ws.msgs:
            h = a.get("hops", 0)
            max_hops = max(max_hops, h)
            prof.records.append(LatencyRecord(
                kind="msg", src=a["src"], dst=a["dst"],
                t_inject=ts, t_eject=ts + dur,
                flits=a["flits"], hops=h,
                serialization=2, hop=h, queueing=rounds - h, bridge=stall,
                wave=index, n=a.get("n", 1)))
        sgap = max(0, rounds - max_hops)
        if sgap:
            attribution.append((
                f"schedule serialization @ {hot or 'schedule'}", sgap))
        prof.waves.append(WaveProfile(
            index=index, t0=t0, dur=dur, kind=kind, mode=mode,
            rounds=rounds, bridge_stalls=bridge_rounds, bound=max_hops,
            gap=sgap + bridge_rounds, attribution=attribution,
            hot_link=hot, n_records=len(ws.msgs)))
    else:  # message-free wave: scatter+gather barrier only
        prof.waves.append(WaveProfile(
            index=index, t0=t0, dur=dur, kind="idle", mode=mode,
            rounds=0, bridge_stalls=bridge_rounds, bound=0,
            gap=bridge_rounds, attribution=attribution, hot_link=None))


def profile_trace(trace: Union[Tracer, Iterable[TraceEvent]], *,
                  strict: bool = True) -> Profile:
    """Rebuild a :class:`Profile` from a complete trace.

    Single pass, same strictness contract as `trace_stats`: with
    ``strict=True`` (default) a `Tracer` that dropped events is refused —
    a partial trace cannot support latency claims.  ``strict=False``
    profiles whatever events remain (counts degrade predictably; the
    exactness invariant still holds for every record that IS rebuilt,
    since each record derives from a single event).

    Accepts a `Tracer` or any iterable of `TraceEvent` (e.g. the output of
    `telemetry.export.events_from_chrome`, so saved Perfetto JSON
    round-trips back into a profile).
    """
    if isinstance(trace, Tracer):
        if strict and trace.dropped:
            raise ValueError(
                f"trace dropped {trace.dropped} events (capacity="
                f"{trace.capacity}): a partial trace cannot support "
                f"latency attribution; raise the Tracer capacity")
        events: Iterable[TraceEvent] = trace.events()
    else:
        events = list(trace)

    prof = Profile(records=[], waves=[], links={}, modes=[])
    ws = _WaveState()
    mode = "?"
    wave_i = 0
    for ev in events:
        name = ev.name
        if name == "run":
            m = (ev.args or {}).get("mode", "?")
            mode = m
            if m not in prof.modes:
                prof.modes.append(m)
        elif name == "msg":
            ws.msgs.append((ev.ts, ev.args or {}))
        elif name == "pkt":
            ws.pkts.append(ev.args)
        elif name == "round":
            ws.n_rounds += 1
        elif name == "cycle":
            c = ev.args["c"]
            if c > ws.max_c:
                ws.max_c = c
            ws.stalls += ev.args["stalls"]
            ws.arb += ev.args["arb"]
        elif name == "switch_run":
            if ws.pkts:   # back-to-back raw runs without wave spans
                _finalize_wave(prof, ws, wave_i,
                               ws.sw_ts if ws.sw_ts is not None else ev.ts,
                               0, mode, "switch_raw")
                wave_i += 1
                ws = _WaveState()
            ws.sw_ts = ev.ts
            ws.sw_bound = ev.args.get("bound", 0)
        elif name == "bridge_stall":
            a = ev.args
            ws.bridge_stalls.append((a["rounds"], a.get("src", -1),
                                     a.get("dst", -1)))
        elif name == "bridge_tx":
            # bridge byte-load joins the link tally so the hot resource of
            # a partitioned wave can be a bridge, not just a router link
            ws.links[ev.track] = ws.links.get(ev.track, 0) \
                + ev.args["wire_bytes"]
        elif name == "link":
            m = _LINK_TRACK.match(ev.track)
            if m:
                ws.links[ev.track] = ws.links.get(ev.track, 0) + int(ev.value)
        elif name == "wave":
            _finalize_wave(prof, ws, wave_i, ev.ts, ev.dur, mode,
                           "switch" if ws.pkts else
                           ("schedule" if ws.msgs else "idle"))
            wave_i += 1
            ws = _WaveState()
    if ws.pending:   # trailing raw switch run (no executor wave span)
        _finalize_wave(prof, ws, wave_i,
                       ws.sw_ts if ws.sw_ts is not None else 0, 0, mode,
                       "switch_raw" if ws.pkts else "schedule")
    return prof
