"""Opt-in observability for the NoC engines: tracing, export, metrics (port of
``repro.telemetry``).

* `tracer` — :class:`Tracer` (bounded ring buffer of structured events; see
  its module docstring for the event schema) threaded through every engine
  via ``NoCExecutor(trace=...)`` / ``simulate_switch(tracer=...)`` /
  ``simulate_wormhole_cube(tracer=...)`` / the bridge machine of
  `core.interchip` / the apps' ``tracer=``, and :func:`trace_stats`, which
  folds a complete trace back into the run's `NoCStats` **bit-exactly**.
  The event stream equals the reference's event for event.
* `profile` — :func:`profile_trace` rebuilds per-packet/per-message
  :class:`LatencyRecord`\\ s (inject→eject on the logical clock, decomposed
  exactly into serialization + hop + queueing + bridge), the run's critical
  path, and a gap attribution charging every cycle above the analytic
  bounds to a named resource; :func:`records_allocated` is the
  zero-overhead-off hook (the `events_allocated` analog).
* `export` — :func:`chrome_trace` (Perfetto/Chrome trace-event JSON),
  :func:`validate_chrome_trace`, :func:`events_from_chrome` (the inverse —
  saved traces round-trip back into `trace_stats` / `profile_trace`), and the
  :func:`link_utilization` / :func:`heatmap` text/CSV reports.
* `metrics` — process-wide :class:`MetricsRegistry` (counter/gauge/
  log-bucketed histogram with p50/p99/p99.9, JSON snapshot + Prometheus
  text) that the NoC engines (``noc.*``), the serve loop
  (``serve.prefill.seconds`` / ``serve.decode.seconds``) and the profiler
  (``noc.latency.*``) publish into.
* `regress` — the benchmark-row diff (`regress.compare_rows`).

Everything is off by default and free when off: a disabled tracer is a
single ``is not None`` check in the engines (no event is allocated), a
disabled registry a single ``get_registry() is None`` check, and no
`LatencyRecord` exists unless `profile_trace` is called.  The whole package
is host bookkeeping in pure Python: nothing here touches a device.

``python -m repro_torch.telemetry`` runs any case-study app traced and dumps
the Perfetto trace, the link report and (``--profile``) the bottleneck
report.
"""
from .export import (chrome_trace, events_from_chrome, heatmap,
                     link_utilization, validate_chrome_trace,
                     write_chrome_trace)
from .metrics import (MOE_METRIC_NAMES, STEP_METRIC_NAMES, Counter, Gauge,
                      Histogram, MetricsRegistry, disable_metrics,
                      enable_metrics, get_registry)
from .profile import (CriticalPath, LatencyRecord, Profile, WaveProfile,
                      profile_trace, records_allocated)
from .tracer import TraceEvent, Tracer, events_allocated, trace_stats

__all__ = [
    "Counter",
    "CriticalPath",
    "Gauge",
    "Histogram",
    "LatencyRecord",
    "MOE_METRIC_NAMES",
    "MetricsRegistry",
    "Profile",
    "STEP_METRIC_NAMES",
    "TraceEvent",
    "Tracer",
    "WaveProfile",
    "chrome_trace",
    "disable_metrics",
    "enable_metrics",
    "events_allocated",
    "events_from_chrome",
    "get_registry",
    "heatmap",
    "link_utilization",
    "profile_trace",
    "records_allocated",
    "trace_stats",
    "validate_chrome_trace",
    "write_chrome_trace",
]
