"""Event tracer: bounded ring buffer + the trace→NoCStats aggregation (port
of ``repro.telemetry.tracer``).

The event taxonomy (the telemetry contract — aggregation and exporters key
on ``name``; ``track`` names the Perfetto timeline row):

=============  =======  ===================  ======================================
name           kind     track                args / value
=============  =======  ===================  ======================================
run            instant  "noc"                mode, topology, n_nodes, batch
wave           span     "noc"                wave, msgs; dur = scatter+route+gather
scatter        span     "engine"             msgs, bytes
route          span     "engine"             mode
gather         span     "engine"             —
msg            instant  "node {src}"         src, dst, bytes, flits, hops, n
                                             [+ wire_bytes, beats when cross-pod]
round          instant  "noc"                bytes, links (one per schedule round)
link           counter  "link {s}->{d}"      value = bytes this round (schedule
                                             modes) or flit-bytes this switch
                                             run (buffered mode, one per link)
cycle          instant  "switch"             c, moves, bytes, stalls, arb, ejects
queue          counter  "switch queue"       value = peak FIFO occupancy, cycle
flit           instant  "router {u}"         pid, f, vc, to (detail="flits" only)
switch_run     instant  "switch"             packets, flits, bound (analytic
                                             switch_lower_bound for the run)
pkt            instant  "node {dst}"         pid, src, dst, flits, hops, inject,
                                             lat, stall, arb (one per packet,
                                             emitted at tail ejection)
idle_ff        instant  "switch"             to (cycle-counter fast-forward)
deadlock       instant  "switch"             wedged, wait_cycle
bridge_cfg     instant  "bridges"            n, wire_bits, lanes, beat_bytes, ...
bridge_tx      instant  "bridge {s}->{d}"    words, beats, wire_bytes
bridge_fifo    counter  "bridge {s}->{d}"    value = FIFO occupancy, wire words
bridge_stall   instant  "bridges"            rounds, src, dst (the gating bridge)
=============  =======  ===================  ======================================

Timestamps are *logical* NoC time: each wave occupies ``[t0, t0 + dur)``
where scatter takes 1 tick, the route phase takes its rounds (or switch
cycles, plus bridge stall rounds) and gather takes 1 tick.  The engines
advance ``Tracer.clock`` accordingly, so one trace covers a whole
``run_iterative``/``run_batch`` timeline.

The correctness contract (the whole point): :func:`trace_stats` folds a full
trace back into a `core.noc.NoCStats` that is **bit-exact** against
what the engine returned — sums for the flow counters, maxes for the
high-water marks, switch cycles recovered from the per-cycle events.  The
trace is a proof-carrying account of the run, not a best-effort log; the
parity is differential-tested across the topology × app × mode grid in
``tests/test_torch_telemetry.py``, event for event against the reference.

The buffer is bounded (``capacity`` events, oldest dropped first) so tracing
can never blow up memory on a runaway workload; :func:`trace_stats` refuses
to aggregate a trace that dropped events (a partial trace proves nothing).

:mod:`telemetry.profile` consumes the same stream and rebuilds
per-packet/per-message latency records with an exact component decomposition
and per-wave gap attribution.

Event ``args`` hold Python scalars only (the engines' counters are host
bookkeeping), so a trace serializes with ``json.dumps`` and compares with
``==``.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Iterable, Optional, Union

# module-wide allocation counter: the zero-overhead-when-off property is
# tested as "this number does not move when tracing is disabled"
_N_EVENTS = 0


def events_allocated() -> int:
    """Total TraceEvents allocated in this process (test/debug hook)."""
    return _N_EVENTS


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One structured event.  ``kind``: 'span' | 'instant' | 'counter'."""

    ts: int
    name: str
    track: str
    kind: str = "instant"
    dur: int = 0
    value: float = 0.0
    args: Optional[dict] = None


class Tracer:
    """Bounded ring buffer of :class:`TraceEvent`.

    ``capacity`` — max events retained (oldest evicted first; ``dropped``
    counts evictions).  ``detail`` — '"cycles"'' (default) keeps per-cycle
    aggregates; ``"flits"`` additionally records every flit move through the
    wormhole switch (one event per flit per hop — verbose, post-mortem use).

    ``clock`` is the logical timebase the engines advance between waves;
    emit helpers default ``ts`` to it.
    """

    def __init__(self, capacity: int = 1 << 20, detail: str = "cycles"):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        if detail not in ("cycles", "flits"):
            raise ValueError(f"detail must be 'cycles' or 'flits', got {detail!r}")
        self.capacity = capacity
        self.detail = detail
        self._buf: deque[TraceEvent] = deque(maxlen=capacity)
        self.emitted = 0
        self.clock = 0

    # -- emission ----------------------------------------------------------
    def _push(self, ev: TraceEvent) -> None:
        global _N_EVENTS
        _N_EVENTS += 1
        self.emitted += 1
        self._buf.append(ev)

    def instant(self, name: str, track: str, ts: Optional[int] = None,
                **args) -> None:
        self._push(TraceEvent(self.clock if ts is None else ts, name, track,
                              "instant", args=args or None))

    def span(self, name: str, track: str, ts: int, dur: int, **args) -> None:
        self._push(TraceEvent(ts, name, track, "span", dur=dur,
                              args=args or None))

    def counter(self, name: str, track: str, value: float,
                ts: Optional[int] = None) -> None:
        self._push(TraceEvent(self.clock if ts is None else ts, name, track,
                              "counter", value=value))

    # -- access ------------------------------------------------------------
    @property
    def dropped(self) -> int:
        """Events evicted by the ring bound (0 ⇔ the trace is complete)."""
        return self.emitted - len(self._buf)

    def events(self) -> list[TraceEvent]:
        return list(self._buf)

    def clear(self) -> None:
        self._buf.clear()
        self.emitted = 0
        self.clock = 0

    def __len__(self) -> int:
        return len(self._buf)


# ---------------------------------------------------------------------------
# aggregation: trace -> NoCStats, bit-exact
# ---------------------------------------------------------------------------

def trace_stats(trace: Union[Tracer, Iterable[TraceEvent]], *,
                strict: bool = True):
    """Fold a complete trace into a `core.noc.NoCStats`.

    Every counter is rebuilt from first-principles events — per-message
    ``msg`` events for payload/flit/cross-pod counters, per-round ``round``
    events for schedule rounds/link bytes, per-cycle ``cycle``/``queue``
    events for the buffered switch (cycles are recovered as ``max c + 1``
    per switch run; a ``c`` that does not increase starts a new run), and
    the ``bridge_*`` events for the serial links.  High-water marks merge by
    max, flows by sum — exactly `NoCStats.add` semantics — so the result is
    bit-identical to the engine's own accounting (differential-tested).

    ``strict=True`` (default) raises if the tracer dropped events: an
    incomplete trace cannot prove anything about the run.
    """
    from ..core.noc import NoCStats

    if isinstance(trace, Tracer):
        if strict and trace.dropped:
            raise ValueError(
                f"trace dropped {trace.dropped} events (capacity="
                f"{trace.capacity}): aggregation of a partial trace would "
                f"not reproduce NoCStats; raise the Tracer capacity")
        events: Iterable[TraceEvent] = trace.events()
    else:
        events = list(trace)
    st = NoCStats()
    prev_c: Optional[int] = None   # last cycle index of the open switch run

    def commit_switch_run() -> None:
        nonlocal prev_c
        if prev_c is not None:
            # buffered transport: rounds ARE switch cycles (mode-specific
            # accounting of NoCExecutor._run_compiled)
            st.rounds += prev_c + 1
            st.switch_cycles += prev_c + 1
            prev_c = None

    for ev in events:
        name = ev.name
        if name == "wave":
            commit_switch_run()
            st.waves += 1
        elif name == "msg":
            a = ev.args or {}
            k = a.get("n", 1)
            st.payload_bytes += k * a["bytes"]
            st.flits += k * a["flits"]
            if "wire_bytes" in a:
                st.cross_pod_msgs += k
                st.cross_pod_wire_bytes += k * a["wire_bytes"]
                st.cross_pod_beats += k * a["beats"]
        elif name == "round":
            st.rounds += 1
            st.link_bytes += ev.args["bytes"]
        elif name == "cycle":
            a = ev.args
            c = a["c"]
            if prev_c is not None and c <= prev_c:
                st.rounds += prev_c + 1       # a new switch run started
                st.switch_cycles += prev_c + 1
            prev_c = c
            st.link_bytes += a["bytes"]
            st.switch_stall_cycles += a["stalls"]
            st.switch_arb_losses += a["arb"]
            st.switch_peak_link_flits = max(st.switch_peak_link_flits,
                                            a["moves"])
        elif name == "queue":
            st.switch_max_queue = max(st.switch_max_queue, int(ev.value))
        elif name == "bridge_tx":
            a = ev.args
            st.bridge_beats += a["beats"]
            st.bridge_wire_bytes += a["wire_bytes"]
        elif name == "bridge_stall":
            st.bridge_stall_rounds += ev.args["rounds"]
        elif name == "bridge_fifo":
            st.bridge_peak_fifo = max(st.bridge_peak_fifo, int(ev.value))
    commit_switch_run()
    return st
