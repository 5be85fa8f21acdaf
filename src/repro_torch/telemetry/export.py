"""Trace exporters: Chrome trace-event / Perfetto JSON + link heatmaps (port
of ``repro.telemetry.export``).

`chrome_trace` lowers a :class:`~telemetry.tracer.Tracer` into the
Chrome trace-event JSON object format (loadable in ``ui.perfetto.dev`` or
``chrome://tracing``): one thread-track per engine track (routers, links,
bridges, the wave/engine timelines), complete-event spans (``ph=X``) for
waves/scatter/route/gather, instants (``ph=i``) for per-cycle and
per-message events, and counter tracks (``ph=C``) for queue depth, link
load and bridge FIFO occupancy.  Logical NoC ticks map 1:1 onto trace
microseconds.  The document is the reference's, process name included, so
a trace of the port and one of the reference load side by side.

`validate_chrome_trace` is a hand-rolled structural checker for the subset
of the format we emit (no external jsonschema dependency).

`link_utilization` + `heatmap` rebuild the per-link byte totals from the
``link`` counter events — accepting either a live tracer or an exported
JSON document — and render them as an n×n text matrix or CSV.
"""
from __future__ import annotations

import json
import re
from typing import Union

from .tracer import TraceEvent, Tracer

_PID = 0
_LINK_TRACK = re.compile(r"^(?:link|bridge) (\d+)->(\d+)$")


def chrome_trace(trace: Union[Tracer, list], *, process_name: str = "repro.noc") -> dict:
    """Lower a trace to a Chrome trace-event JSON document (dict)."""
    events = trace.events() if isinstance(trace, Tracer) else list(trace)
    tids: dict = {}
    out = [{"name": "process_name", "ph": "M", "pid": _PID, "tid": 0,
            "args": {"name": process_name}}]

    def tid_of(track: str) -> int:
        t = tids.get(track)
        if t is None:
            t = tids[track] = len(tids) + 1
            out.append({"name": "thread_name", "ph": "M", "pid": _PID,
                        "tid": t, "args": {"name": track}})
        return t

    for ev in events:
        base = {"name": ev.name, "pid": _PID, "tid": tid_of(ev.track),
                "ts": ev.ts}
        if ev.kind == "span":
            base["ph"] = "X"
            base["dur"] = max(ev.dur, 1)
            base["args"] = ev.args or {}
        elif ev.kind == "counter":
            base["ph"] = "C"
            base["args"] = {"value": ev.value}
        else:
            base["ph"] = "i"
            base["s"] = "t"
            base["args"] = ev.args or {}
        out.append(base)
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def write_chrome_trace(path, trace: Union[Tracer, list, dict]) -> None:
    """Serialize a tracer (or a prebuilt document) to ``path``."""
    doc = trace if isinstance(trace, dict) else chrome_trace(trace)
    with open(path, "w") as fh:
        json.dump(doc, fh, indent=1)
        fh.write("\n")


def validate_chrome_trace(doc: dict) -> int:
    """Structural check of a Chrome trace-event document.

    Verifies the envelope, per-event required fields by phase, numeric
    timestamps/durations, counter args, and that every (pid, tid) carrying
    events has ``thread_name`` metadata.  Raises ``ValueError`` naming the
    first offending event; returns the number of events checked.
    """
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        raise ValueError("not a trace document: missing 'traceEvents'")
    evs = doc["traceEvents"]
    if not isinstance(evs, list):
        raise ValueError("'traceEvents' must be a list")
    named_threads = set()
    used_threads = set()
    for i, ev in enumerate(evs):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            raise ValueError(f"{where}: not an object")
        ph = ev.get("ph")
        if ph not in ("X", "i", "C", "M"):
            raise ValueError(f"{where}: unsupported ph {ph!r}")
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            raise ValueError(f"{where}: missing event name")
        for k in ("pid", "tid"):
            if not isinstance(ev.get(k), int):
                raise ValueError(f"{where}: {k} must be an int")
        if ph == "M":
            if ev["name"] not in ("process_name", "thread_name"):
                raise ValueError(f"{where}: unknown metadata {ev['name']!r}")
            if not isinstance(ev.get("args", {}).get("name"), str):
                raise ValueError(f"{where}: metadata needs args.name")
            if ev["name"] == "thread_name":
                named_threads.add((ev["pid"], ev["tid"]))
            continue
        used_threads.add((ev["pid"], ev["tid"]))
        if not isinstance(ev.get("ts"), (int, float)):
            raise ValueError(f"{where}: ts must be a number")
        if ph == "X":
            if not isinstance(ev.get("dur"), (int, float)) or ev["dur"] < 0:
                raise ValueError(f"{where}: span needs dur >= 0")
        if ph == "C":
            args = ev.get("args")
            if (not isinstance(args, dict) or not args
                    or not all(isinstance(v, (int, float))
                               for v in args.values())):
                raise ValueError(f"{where}: counter needs numeric args")
        if ph == "i" and ev.get("s", "t") not in ("g", "p", "t"):
            raise ValueError(f"{where}: bad instant scope {ev.get('s')!r}")
    orphans = used_threads - named_threads
    if orphans:
        raise ValueError(f"threads without thread_name metadata: "
                         f"{sorted(orphans)}")
    return len(evs)


def events_from_chrome(doc: dict) -> list:
    """Inverse of :func:`chrome_trace`: rebuild `TraceEvent`s from a saved
    Chrome trace document.

    Track names are recovered from the ``thread_name`` metadata, spans
    (``ph=X``) back to kind ``"span"`` with their duration, counters
    (``ph=C``) to kind ``"counter"`` with ``args.value``, instants to kind
    ``"instant"`` with their args; metadata events are dropped.  The result
    feeds `telemetry.profile.profile_trace` (and `trace_stats`), so a
    trace written to disk round-trips into the same profile the live tracer
    would give.
    """
    names = {(ev["pid"], ev["tid"]): ev["args"]["name"]
             for ev in doc.get("traceEvents", ())
             if ev.get("ph") == "M" and ev.get("name") == "thread_name"}
    out = []
    for ev in doc.get("traceEvents", ()):
        ph = ev.get("ph")
        if ph == "M":
            continue
        track = names.get((ev.get("pid"), ev.get("tid")), "")
        if ph == "X":
            out.append(TraceEvent(int(ev["ts"]), ev["name"], track, "span",
                                  dur=int(ev["dur"]),
                                  args=ev.get("args") or None))
        elif ph == "C":
            out.append(TraceEvent(int(ev["ts"]), ev["name"], track,
                                  "counter", value=ev["args"]["value"]))
        else:
            out.append(TraceEvent(int(ev["ts"]), ev["name"], track,
                                  "instant", args=ev.get("args") or None))
    return out


# ---------------------------------------------------------------------------
# link-utilization heatmap
# ---------------------------------------------------------------------------

def link_utilization(trace: Union[Tracer, list, dict]) -> dict:
    """Per-link byte totals ``{(src, dst): bytes}``.

    Accepts a live tracer / event list (sums ``link`` counter events) or an
    exported Chrome trace document (recovers the link from the track's
    ``thread_name`` metadata).  Bridge wire traffic is included under its
    own ``(src, dst)`` pairs via the ``bridge_tx`` events, so a partitioned
    run's serial links show up next to the router links they bridge; the
    buffered switch emits per-link flit-byte counters at the end of each
    run, so ``mode="buffered"`` heatmaps are populated too.
    """
    util: dict = {}

    def add(track: str, nbytes: float) -> None:
        m = _LINK_TRACK.match(track)
        if m:
            key = (int(m.group(1)), int(m.group(2)))
            util[key] = util.get(key, 0) + int(nbytes)

    if isinstance(trace, dict):
        names = {(ev["pid"], ev["tid"]): ev["args"]["name"]
                 for ev in trace.get("traceEvents", ())
                 if ev.get("ph") == "M" and ev.get("name") == "thread_name"}
        for ev in trace.get("traceEvents", ()):
            track = names.get((ev.get("pid"), ev.get("tid")), "")
            if ev.get("ph") == "C" and ev.get("name") == "link":
                add(track, ev["args"]["value"])
            elif ev.get("ph") == "i" and ev.get("name") == "bridge_tx":
                add(track, ev["args"]["wire_bytes"])
    else:
        events = trace.events() if isinstance(trace, Tracer) else trace
        for ev in events:
            assert isinstance(ev, TraceEvent)
            if ev.kind == "counter" and ev.name == "link":
                add(ev.track, ev.value)
            elif ev.name == "bridge_tx":
                add(ev.track, ev.args["wire_bytes"])
    return util


def heatmap(util: dict, *, csv: bool = False) -> str:
    """Render `link_utilization` output as text matrix or CSV."""
    if csv:
        lines = ["src,dst,bytes"]
        for (s, d), b in sorted(util.items()):
            lines.append(f"{s},{d},{b}")
        return "\n".join(lines)
    if not util:
        return "no link traffic recorded"
    nodes = sorted({s for s, _ in util} | {d for _, d in util})
    width = max(7, max(len(str(b)) for b in util.values()) + 1)
    head = "src\\dst" + "".join(f"{d:>{width}}" for d in nodes)
    lines = [head]
    for s in nodes:
        row = f"{s:>7}"
        for d in nodes:
            b = util.get((s, d), 0)
            row += f"{b if b else '.':>{width}}"
        lines.append(row)
    lines.append(f"total bytes: {sum(util.values())} over {len(util)} links")
    return "\n".join(lines)
