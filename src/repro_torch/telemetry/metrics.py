"""Unified metrics registry: counters, gauges, log-bucketed histograms (port of
``repro.telemetry.metrics``).

One naming scheme for every engine.  NoC engines publish their `NoCStats`
under ``noc.*`` (flow counters as Counters, high-water marks as max-Gauges),
MoE dispatch publishes ``noc.moe.*`` (`MoEDispatchStats.publish`), and the
train/serve loops time their steps into latency Histograms
(``train.step.seconds``, ``serve.prefill.seconds``, ``serve.decode.seconds``)
with p50/p99/p99.9 read straight off the log buckets.  The per-step metric
dict that `transformer.loss` returns maps onto the same names via
:data:`STEP_METRIC_NAMES` — no more parallel ad-hoc dicts.

The registry is opt-in and process-wide: :func:`enable_metrics` installs it,
:func:`get_registry` returns ``None`` when disabled (publishers guard on
that, so the off path is one pointer check).  Exposition: :meth:`snapshot`
(JSON-ready dict) and :meth:`prometheus` (text format, histograms as
summaries with quantiles).

Histograms bucket by powers of ``2**0.25`` (~19% relative width), so a
quantile estimate is exact to within one bucket and is clamped to the
observed min/max.  This module imports nothing from ``core`` at
module scope — the engines import it, not the other way around.
"""
from __future__ import annotations

import contextlib
import math
import time
from typing import Optional

_LOG_GROWTH = 0.25 * math.log(2.0)   # log of the bucket growth factor

# transformer.loss step-metric dict keys -> canonical metric names.  The
# dict keys are the reference's (tests/test_moe_noc.py); the mapping is
# how they join the shared schema.
STEP_METRIC_NAMES = {
    "moe_drops": "noc.moe.drops",
    "moe_peak_occupancy": "noc.moe.peak_occupancy",
}

# MoEDispatchStats field -> canonical metric name (same names the step
# metrics above land on, so traces, dispatch stats and train metrics agree)
MOE_METRIC_NAMES = {
    "flits": "noc.moe.flits",
    "rounds": "noc.moe.rounds",
    "link_bytes": "noc.moe.link_bytes",
    "drops": "noc.moe.drops",
    "peak_occupancy": "noc.moe.peak_occupancy",
}


def _key(name: str, labels: dict) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class Counter:
    """Monotonic sum."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: dict):
        self.name, self.labels, self.value = name, labels, 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("Counter.inc amount must be >= 0")
        self.value += amount


class Gauge:
    """Last-write value; ``set_max`` for high-water marks."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: dict):
        self.name, self.labels, self.value = name, labels, 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def set_max(self, value: float) -> None:
        self.value = max(self.value, float(value))


class Histogram:
    """Log-bucketed histogram (growth 2**0.25) with quantile readout.

    Values ≤ 0 collapse into a dedicated underflow bucket.  ``quantile``
    returns the upper edge of the bucket holding the target rank, clamped
    to the observed [min, max] — exact to one bucket (~19%).
    """

    __slots__ = ("name", "labels", "buckets", "count", "total", "vmin", "vmax")
    GROWTH = 2 ** 0.25

    def __init__(self, name: str, labels: dict):
        self.name, self.labels = name, labels
        self.buckets: dict = {}   # bucket index (None = underflow) -> count
        self.count = 0
        self.total = 0.0
        self.vmin: Optional[float] = None
        self.vmax: Optional[float] = None

    def observe(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.total += v
        self.vmin = v if self.vmin is None else min(self.vmin, v)
        self.vmax = v if self.vmax is None else max(self.vmax, v)
        idx = None if v <= 0.0 else math.ceil(math.log(v) / _LOG_GROWTH - 1e-9)
        self.buckets[idx] = self.buckets.get(idx, 0) + 1

    def quantile(self, q: float) -> float:
        """Quantile estimate, exact to one bucket (~19% relative).

        Contract (tested in ``tests/test_torch_telemetry.py``):

        * empty histogram → ``0.0`` for every ``q`` (never divides by zero);
        * single observation / single bucket → that value for every ``q``
          (the bucket edge is clamped to the observed ``[vmin, vmax]``, so
          p50 == p99 == p99.9 == the value);
        * ``q`` outside ``[0, 1]`` raises ``ValueError``;
        * ``q == 0`` reads the lowest occupied bucket (rank 1).
        """
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile q must be in [0, 1], got {q!r}")
        if not self.count:
            return 0.0
        target = max(1, math.ceil(q * self.count))
        cum = 0
        for idx in sorted(self.buckets,
                          key=lambda i: -math.inf if i is None else i):
            cum += self.buckets[idx]
            if cum >= target:
                edge = 0.0 if idx is None else self.GROWTH ** idx
                return min(max(edge, self.vmin), self.vmax)
        return self.vmax   # unreachable, kept for safety

    @property
    def p50(self) -> float:
        return self.quantile(0.50)

    @property
    def p99(self) -> float:
        return self.quantile(0.99)

    @property
    def p999(self) -> float:
        return self.quantile(0.999)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0


class MetricsRegistry:
    """Keyed store of Counter/Gauge/Histogram, one per (name, labels)."""

    def __init__(self):
        self._counters: dict = {}
        self._gauges: dict = {}
        self._histograms: dict = {}

    # -- instrument accessors (get-or-create) ------------------------------
    def counter(self, name: str, **labels) -> Counter:
        k = _key(name, labels)
        c = self._counters.get(k)
        if c is None:
            c = self._counters[k] = Counter(name, labels)
        return c

    def gauge(self, name: str, **labels) -> Gauge:
        k = _key(name, labels)
        g = self._gauges.get(k)
        if g is None:
            g = self._gauges[k] = Gauge(name, labels)
        return g

    def histogram(self, name: str, **labels) -> Histogram:
        k = _key(name, labels)
        h = self._histograms.get(k)
        if h is None:
            h = self._histograms[k] = Histogram(name, labels)
        return h

    def histograms(self, prefix: str = "") -> dict:
        """Installed histograms whose name starts with ``prefix``, keyed by
        their full ``name{labels}`` key (sorted).  Read-only view used by the
        launch entrypoints to surface e.g. every ``noc.latency.*`` series."""
        return {k: h for k, h in sorted(self._histograms.items())
                if h.name.startswith(prefix)}

    @contextlib.contextmanager
    def timer(self, name: str, **labels):
        """Time a block into ``histogram(name)`` (seconds)."""
        h = self.histogram(name, **labels)
        t0 = time.perf_counter()
        try:
            yield h
        finally:
            h.observe(time.perf_counter() - t0)

    # -- engine publishers -------------------------------------------------
    def record_noc_stats(self, stats, **labels) -> None:
        """Publish a `NoCStats` under ``noc.*``.

        Flow counters accumulate (Counter.inc), the high-water-mark fields
        (`noc._MAX_MERGE_FIELDS`) merge by max (Gauge.set_max) — the same
        semantics as `NoCStats.add`, so repeated runs aggregate exactly
        like the engine's own accounting.
        """
        from ..core.noc import _MAX_MERGE_FIELDS
        for field, v in stats.as_dict().items():
            name = f"noc.{field}"
            if field in _MAX_MERGE_FIELDS:
                self.gauge(name, **labels).set_max(v)
            else:
                self.counter(name, **labels).inc(v)

    def record_moe_stats(self, st) -> None:
        """Publish a `MoEDispatchStats` under the canonical ``noc.moe.*``.

        A 0-d tensor becomes a Python float here, at publish time (one
        read-back per field); a field that is not a scalar is skipped.
        """
        labels = {"engine": st.engine}
        if st.topology:
            labels["topology"] = st.topology
        for field, name in MOE_METRIC_NAMES.items():
            try:
                v = float(getattr(st, field))
            except Exception:
                continue
            if field == "peak_occupancy":
                self.gauge(name, **labels).set_max(v)
            else:
                self.counter(name, **labels).inc(v)
        self.gauge("noc.moe.capacity", **labels).set(st.capacity)
        self.gauge("noc.moe.capacity_factor", **labels).set(st.capacity_factor)

    def record_step_metrics(self, mets: dict) -> None:
        """Publish a train-step metric dict via :data:`STEP_METRIC_NAMES`
        (0-d tensors read back as floats here; non-scalars are skipped)."""
        for k, v in mets.items():
            name = STEP_METRIC_NAMES.get(k)
            if name is None:
                continue
            try:
                v = float(v)
            except Exception:
                continue
            if k == "moe_peak_occupancy":
                self.gauge(name).set_max(v)
            else:
                self.counter(name).inc(v)

    # -- exposition --------------------------------------------------------
    def snapshot(self) -> dict:
        """JSON-ready dict of every instrument."""
        return {
            "counters": {k: c.value for k, c in sorted(self._counters.items())},
            "gauges": {k: g.value for k, g in sorted(self._gauges.items())},
            "histograms": {
                k: {"count": h.count, "sum": h.total,
                    "min": h.vmin or 0.0, "max": h.vmax or 0.0,
                    "mean": h.mean, "p50": h.p50, "p99": h.p99,
                    "p99.9": h.p999}
                for k, h in sorted(self._histograms.items())
            },
        }

    def prometheus(self) -> str:
        """Prometheus text exposition (histograms as summary quantiles)."""
        def pname(name: str) -> str:
            return name.replace(".", "_").replace("-", "_")

        def plabels(labels: dict, extra: Optional[dict] = None) -> str:
            items = dict(labels)
            if extra:
                items.update(extra)
            if not items:
                return ""
            inner = ",".join(f'{k}="{items[k]}"' for k in sorted(items))
            return f"{{{inner}}}"

        out = []
        for c in self._counters.values():
            out.append(f"# TYPE {pname(c.name)} counter")
            out.append(f"{pname(c.name)}{plabels(c.labels)} {c.value:g}")
        for g in self._gauges.values():
            out.append(f"# TYPE {pname(g.name)} gauge")
            out.append(f"{pname(g.name)}{plabels(g.labels)} {g.value:g}")
        for h in self._histograms.values():
            n = pname(h.name)
            out.append(f"# TYPE {n} summary")
            for q, v in (("0.5", h.p50), ("0.99", h.p99), ("0.999", h.p999)):
                out.append(f"{n}{plabels(h.labels, {'quantile': q})} {v:g}")
            out.append(f"{n}_sum{plabels(h.labels)} {h.total:g}")
            out.append(f"{n}_count{plabels(h.labels)} {h.count}")
        return "\n".join(out) + "\n"


# ---------------------------------------------------------------------------
# process-wide opt-in registry
# ---------------------------------------------------------------------------
_REGISTRY: Optional[MetricsRegistry] = None


def enable_metrics(registry: Optional[MetricsRegistry] = None) -> MetricsRegistry:
    """Install (or replace) the process-wide registry and return it."""
    global _REGISTRY
    _REGISTRY = registry if registry is not None else MetricsRegistry()
    return _REGISTRY


def disable_metrics() -> None:
    """Remove the process-wide registry (publishers become no-ops)."""
    global _REGISTRY
    _REGISTRY = None


def get_registry() -> Optional[MetricsRegistry]:
    """The installed registry, or ``None`` when metrics are off."""
    return _REGISTRY
