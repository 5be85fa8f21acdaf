"""Perf-regression diff: benchmark rows against a baseline (the pure half of
``repro.telemetry.regress``).

:func:`compare_rows` diffs two lists of benchmark row dicts (the format of
the reference's ``benchmarks/BENCH_*.json["rows"]``) with noise-aware
thresholds and names every finding.  Metric classes — counters and timings
fail differently:

* **counters** — deterministic engine numbers (cycles, stalls, flits,
  arb_losses, …).  Any mismatch is reported; a *worsening* is a regression,
  an improvement is reported as such.
* **timings** — ``us`` / any ``*_us`` key / throughput-like keys.  Only a
  *relative worsening* beyond ``timing_tol`` (default 25%) is a regression,
  and only with ``gate_timing=True``.
* **text** — strings/bools (verdicts like ``deadlock_free=True``): any change
  is a regression.

Direction matters: ``speedup``/``accepted``/``*_per_s``-style metrics are
higher-is-better; everything else numeric lower-is-better.

The reference's gate around this diff (``run_fresh``, which re-runs its
``benchmarks/run.py`` tables, ``_load_baseline`` and the ``main`` CLI) waits
for the port's own benchmark tables (ROADMAP Queue 1 item 9).
"""
from __future__ import annotations

import re

# keys whose values are wall-clock / throughput noise, not deterministic
_TIMING_KEY = re.compile(
    r"(^|_)us$|per_s|fps|traced_over_untraced|speedup|gain")
# numeric metrics where bigger is better (everything else: smaller better)
_HIGHER_BETTER = re.compile(
    r"speedup|accepted|gain|per_s|fps|throughput|sat_rate")


def metric_class(key: str, value) -> str:
    """``"timing"`` | ``"counter"`` | ``"text"`` for one row field."""
    if isinstance(value, str) or isinstance(value, bool):
        return "text"
    return "timing" if _TIMING_KEY.search(key) else "counter"


def _worse(key: str, base: float, new: float) -> bool:
    if _HIGHER_BETTER.search(key):
        return new < base
    return new > base


def _fmt(v) -> str:
    return f"{v:g}" if isinstance(v, (int, float)) else str(v)


def compare_rows(base_rows: list, new_rows: list, *,
                 timing_tol: float = 0.25,
                 gate_timing: bool = True) -> list:
    """Diff two row-dict lists (same format as ``BENCH_*.json["rows"]``).

    Returns a list of finding dicts ``{row, metric, cls, base, new, delta,
    verdict}`` where ``verdict`` is ``"regression"`` (fails the gate),
    ``"improvement"`` or ``"drift"`` (reported, non-fatal).  Rows are
    matched by name; rows present on only one side are a ``"regression"``
    (a vanished benchmark can hide a vanished feature).
    """
    base_by = {r["name"]: r for r in base_rows}
    new_by = {r["name"]: r for r in new_rows}
    findings = []
    for name in sorted(set(base_by) | set(new_by)):
        if name not in new_by:
            findings.append(dict(row=name, metric="(row)", cls="presence",
                                 base="present", new="missing", delta="",
                                 verdict="regression"))
            continue
        if name not in base_by:
            findings.append(dict(row=name, metric="(row)", cls="presence",
                                 base="missing", new="present", delta="",
                                 verdict="drift"))
            continue
        b, n = base_by[name], new_by[name]
        for key in sorted(set(b) & set(n) - {"name"}):
            bv, nv = b[key], n[key]
            cls = metric_class(key, bv)
            if cls == "text":
                if str(bv) != str(nv):
                    findings.append(dict(
                        row=name, metric=key, cls=cls, base=str(bv),
                        new=str(nv), delta="changed", verdict="regression"))
                continue
            if bv == nv:
                continue
            if cls == "timing":
                if not gate_timing:
                    continue
                rel = (nv - bv) / bv if bv else float("inf")
                if _HIGHER_BETTER.search(key):
                    rel = -rel
                if rel > timing_tol:
                    findings.append(dict(
                        row=name, metric=key, cls=cls, base=bv, new=nv,
                        delta=f"{rel:+.1%} (tol {timing_tol:.0%})",
                        verdict="regression"))
                continue
            # deterministic counter: any move is a finding
            verdict = ("regression" if _worse(key, bv, nv) else
                       "improvement")
            findings.append(dict(
                row=name, metric=key, cls=cls, base=bv, new=nv,
                delta=f"{nv - bv:+g}", verdict=verdict))
    return findings
