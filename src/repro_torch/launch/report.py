"""Reports over saved telemetry traces (counterpart of ``repro/launch/report.py``).

    PYTHONPATH=src python -m repro_torch.launch.report --trace trace.json [--csv]
    PYTHONPATH=src python -m repro_torch.launch.report --profile trace.json

``--trace`` renders the link-utilization heatmap of a recorded Perfetto/
Chrome trace (see ``python -m repro_torch.telemetry``); ``--profile`` runs the
latency profiler over the same saved trace (``events_from_chrome`` →
``profile_trace``) and prints the bottleneck report: exact per-packet latency
decomposition, critical path and the gap attribution against the analytic
bounds.  Both read a trace written by either package: the event schema is
shared.  Both are host bookkeeping: nothing here touches a device.

The reference's positional mode (the roofline table over a directory of
dry-run JSONs) reads the device-mesh dry run, which the port does not have
yet (ROADMAP item 8(e)); without ``--trace`` or ``--profile`` this CLI exits
with that message.
"""
from __future__ import annotations

import argparse
import json

from ..telemetry import (events_from_chrome, heatmap, link_utilization,
                         profile_trace)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.report")
    ap.add_argument("dir", nargs="?", default=None,
                    help="dry-run results directory (roofline table; not ported)")
    ap.add_argument("--trace", default=None, metavar="TRACE_JSON",
                    help="render the link-utilization heatmap of a "
                         "telemetry trace")
    ap.add_argument("--csv", action="store_true",
                    help="with --trace: CSV rows instead of the matrix")
    ap.add_argument("--profile", default=None, metavar="TRACE_JSON",
                    help="print the latency profiler's bottleneck report "
                         "for a saved telemetry trace")
    args = ap.parse_args(argv)
    if args.profile is not None:
        with open(args.profile) as fh:
            doc = json.load(fh)
        print(profile_trace(events_from_chrome(doc)).check_exact().report())
        return
    if args.trace is not None:
        with open(args.trace) as fh:
            doc = json.load(fh)
        print(heatmap(link_utilization(doc), csv=args.csv))
        return
    ap.error("--trace or --profile is required; the roofline table over a dry-run "
             "directory waits for the device-mesh dry run (ROADMAP item 8(e))")


if __name__ == "__main__":
    main()
