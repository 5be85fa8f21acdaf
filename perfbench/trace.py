"""The profiler's trace, reduced to what the per-layer readers take.

`from_profiler` copies out of ``torch.profiler``'s raw (Kineto) events:

* the device activities (kernels, copies, memsets), each with the host event
  that launched it: the PyTorch operator or ``record_function`` range whose
  correlation id its linked id names (the link PyTorch's own event tree
  uses), so a kernel launched by hand (the port's ``ctypes`` kernels) is
  anchored to the innermost range around it;
* the host events of the thread that ran the harness's window range
  (``perfbench.window``), which label idle gaps and hold the ranges.

Times are seconds from the start of the window range.  `Trace` and its
functions are plain Python on those lists, so the readers can be tested on a
trace written by hand.  The busy and idle arithmetic is that of
``scripts/profile_main_path.py`` (device activities only, since the host
operators that launch them would count the same time again), with
overlapping activities counted once.
"""
from __future__ import annotations

import bisect
import dataclasses

WINDOW = "perfbench.window"


@dataclasses.dataclass(frozen=True)
class Span:
    name: str
    start: float
    end: float


@dataclasses.dataclass(frozen=True)
class Activity:
    name: str
    start: float
    end: float
    anchor: float | None      # start of the host event that launched it, on the window's thread


@dataclasses.dataclass
class Trace:
    window: float                       # seconds of the window range
    device: list[Activity]
    host: list[Span]                    # host events of the window's thread, by start

    def ranges(self, name: str) -> list[Span]:
        return [s for s in self.host if s.name == name]

    def busy_intervals(self) -> list[tuple[float, float]]:
        """The union of the device activities inside the window."""
        out: list[list[float]] = []
        for a in sorted(self.device, key=lambda a: a.start):
            lo, hi = max(a.start, 0.0), min(a.end, self.window)
            if hi <= lo:
                continue
            if out and lo <= out[-1][1]:
                out[-1][1] = max(out[-1][1], hi)
            else:
                out.append([lo, hi])
        return [(lo, hi) for lo, hi in out]

    def busy_s(self) -> float:
        return sum(hi - lo for lo, hi in self.busy_intervals())

    def device_time_under(self, name: str) -> float:
        """Seconds of the device activities launched inside ranges ``name``."""
        spans = sorted((s.start, s.end) for s in self.ranges(name))
        starts = [s for s, _ in spans]
        total = 0.0
        for a in self.device:
            if a.anchor is None:
                continue
            i = bisect.bisect_right(starts, a.anchor) - 1
            if i >= 0 and a.anchor <= spans[i][1]:
                total += a.end - a.start
        return total

    def top_device_ops(self, n: int = 10) -> list[list]:
        by: dict[str, float] = {}
        for a in self.device:
            by[a.name] = by.get(a.name, 0.0) + (a.end - a.start)
        return [[k[:160], v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10, prefix: str = "perfbench.") -> list[list]:
        """Idle seconds summed by what the host was doing when each gap began:
        the innermost harness range and the innermost host event open then."""
        busy = self.busy_intervals()
        gaps, t = [], 0.0
        for lo, hi in busy:
            if lo > t:
                gaps.append((t, lo))
            t = hi
        if self.window > t:
            gaps.append((t, self.window))
        host = sorted(self.host, key=lambda s: (s.start, -s.end))
        by: dict[str, float] = {}
        stack: list[Span] = []
        j = 0
        for lo, hi in gaps:
            while j < len(host) and host[j].start <= lo:
                stack.append(host[j])
                j += 1
            stack = [s for s in stack if s.end >= lo]
            rng = next((s.name for s in reversed(stack) if s.name.startswith(prefix)), "-")
            op = stack[-1].name if stack and not stack[-1].name.startswith(prefix) else "-"
            key = f"{rng} | {op}"
            by[key] = by.get(key, 0.0) + (hi - lo)
        return [[k[:160], v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def from_profiler(prof) -> Trace | None:
    """The `Trace` of a finished ``torch.profiler.profile``, or None when its
    window range is missing."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    host_raw, dev_raw = [], []
    for e in events:
        if e.device_type() == DeviceType.CPU:
            host_raw.append((e.name(), e.start_thread_id(), e.start_ns(), e.end_ns(),
                             e.correlation_id(), e.linked_correlation_id()))
        elif not e.is_user_annotation():
            dev_raw.append((e.name(), e.start_ns(), e.end_ns(), e.linked_correlation_id()))
    win = [h for h in host_raw if h[0] == WINDOW]
    if not win:
        return None
    _, thread, t0, t1, _, _ = win[0]
    anchors = {h[4]: h for h in host_raw if h[5] == 0}
    host = [Span(n, (s - t0) / 1e9, (e - t0) / 1e9)
            for n, th, s, e, _, _ in host_raw if th == thread and s >= t0 and s <= t1]
    device = []
    for n, s, e, linked in dev_raw:
        if e < t0 or s > t1:
            continue
        h = anchors.get(linked)
        anchor = (h[2] - t0) / 1e9 if h is not None and h[1] == thread else None
        device.append(Activity(n, (s - t0) / 1e9, (e - t0) / 1e9, anchor))
    host.sort(key=lambda s: s.start)
    return Trace(window=(t1 - t0) / 1e9, device=device, host=host)
