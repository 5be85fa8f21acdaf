"""Static capacity/occupancy bounds for compiled NoC executions (port of
``repro.analysis.capacity``).

Derived from the compiled wave layouts alone (no flit is moved), these bounds
bracket what the cycle-accurate simulators later measure:

* **exact** quantities — total flits, payload bytes, and per-wave
  ``link_flits`` (each flit crosses exactly its route's hop count of links in
  ``mode="buffered"``, so ``link_bytes == link_flits × flit_wire_bytes``
  bit-for-bit), and the bridge counters (`interchip.bridge_program_stats` is
  exact against the bridged simulator by construction);
* **sound upper bounds** — peak input-FIFO occupancy (a ``(link, vc)``
  channel can never hold more flits than ``min(buffer_depth, its total
  load)``) and peak per-cycle link crossings (at most one flit per distinct
  loaded link per cycle).  The property suite asserts measured `NoCStats`
  high-water marks never exceed these and that the exact parts agree
  bit-for-bit.

`check_traffic` closes the loop for the synthetic-traffic workloads: offered
``injection_rate`` is compared against the analytic `switch.saturation_rate`
for the pattern's `traffic_matrix` (NOC006), and degenerate topologies with
no destinations are rejected (NOC014).
"""
from __future__ import annotations

import dataclasses

from ..core.topology import Topology
from .cdg import route_channels
from .diagnostics import Diagnostic, diag


@dataclasses.dataclass
class CapacityReport:
    """Static bounds for one executor's compiled program (single input set).

    ``flits``/``payload_bytes``/``link_flits``/``link_bytes``/``bridge_*``
    are exact for one ``run``; ``peak_queue`` and ``peak_link_flits`` are
    sound upper bounds on the matching `NoCStats` high-water marks."""

    flits: int = 0
    payload_bytes: int = 0
    link_flits: int = 0
    link_bytes: int = 0
    peak_queue: int = 0
    peak_link_flits: int = 0
    bridge_beats: int = 0
    bridge_wire_bytes: int = 0
    bridge_stall_rounds: int = 0
    bridge_peak_fifo: int = 0
    diagnostics: list = dataclasses.field(default_factory=list)


def wave_channel_loads(topo: Topology, pairs, flit_bytes: int,
                       n_vcs: int) -> dict[tuple[int, int, int], int]:
    """Flits per (link, vc) channel for one wave's compiled pair layout."""
    loads: dict[tuple[int, int, int], int] = {}
    for s, d, nb in pairs:
        if nb <= 0:
            continue
        flits = -(-nb // flit_bytes)
        for ch in route_channels(topo, s, d, n_vcs):
            loads[ch] = loads.get(ch, 0) + flits
    return loads


def executor_bounds(ex) -> CapacityReport:
    """Static CapacityReport for a `NoCExecutor`'s compiled wave programs."""
    cfg = ex.cfg
    topo = ex.topo
    depth = cfg.switch_buffer_depth
    fb = cfg.flit_wire_bytes
    rep = CapacityReport()
    for w, prog in enumerate(ex.programs):
        rep.flits += prog.static.flits
        rep.payload_bytes += prog.static.payload_bytes
        if not prog.slots:
            continue
        try:
            loads = wave_channel_loads(topo, prog.pairs, fb, cfg.switch_vcs)
        except TypeError:      # topology without dimension-ordered routes
            continue
        if not loads:
            continue
        rep.link_flits += sum(loads.values())
        worst_ch = max(loads, key=loads.get)
        worst = loads[worst_ch]
        rep.peak_queue = max(rep.peak_queue, min(depth, worst))
        links_used = len({(u, v) for u, v, _ in loads})
        rep.peak_link_flits = max(rep.peak_link_flits, links_used)
        if worst >= depth:
            u, v, vc = worst_ch
            rep.diagnostics.append(diag(
                "NOC005", f"wave {w}: input FIFO ({u}->{v} vc{vc}) takes "
                          f"{worst} flits against depth {depth} — credit "
                          f"stalls predicted (correctness unaffected)",
                "NoCConfig.switch_buffer_depth"))
    rep.link_bytes = rep.link_flits * fb
    if ex.plan is not None:
        from ..core.interchip import bridge_program_stats

        bprog = ex._ensure_bridge()
        n = topo.n_nodes
        for prog in ex.programs:
            if not prog.slots or prog.buf_bytes == 0:
                continue
            b = bridge_program_stats(bprog, n * n * prog.buf_bytes)
            rep.bridge_beats += b.beats
            rep.bridge_wire_bytes += b.wire_bytes
            rep.bridge_stall_rounds += b.stall_rounds
            rep.bridge_peak_fifo = max(rep.bridge_peak_fifo, b.peak_fifo)
        if rep.bridge_peak_fifo >= cfg.bridge_fifo_depth:
            rep.diagnostics.append(diag(
                "NOC013", f"bridge FIFO peaks at {rep.bridge_peak_fifo} "
                          f"wire words against depth "
                          f"{cfg.bridge_fifo_depth} — back-pressure stall "
                          f"rounds predicted",
                "NoCConfig.bridge_fifo_depth"))
    return rep


def check_traffic(topo: Topology, tcfg,
                  n_vcs: int = 2) -> list[Diagnostic]:
    """NOC006/NOC014 diagnostics for a `traffic.TrafficConfig` on ``topo``."""
    from ..core.switch import saturation_rate
    from ..core.traffic import traffic_matrix

    where = f"TrafficConfig({tcfg.pattern})"
    n = topo.n_nodes
    diags: list[Diagnostic] = []
    if n < 2:
        diags.append(diag("NOC014", f"{topo.name} has {n} node(s): no "
                                    f"destination exists for injected "
                                    f"traffic", where))
        return diags
    if tcfg.pattern == "hotspot" and not 0 <= tcfg.hotspot < n:
        diags.append(diag("NOC014", f"hotspot node {tcfg.hotspot} outside "
                                    f"the {n}-node fabric", where))
        return diags
    sat = saturation_rate(topo, traffic_matrix(topo, tcfg), n_vcs)
    if tcfg.injection_rate > sat:
        diags.append(diag(
            "NOC006", f"offered load {tcfg.injection_rate:.3f} "
                      f"flits/cycle/node exceeds the analytic saturation "
                      f"rate {sat:.3f} for the {tcfg.pattern} pattern on "
                      f"{topo.name} n={n} — queues grow without bound in "
                      f"the open-loop regime", where))
    return diags


def predicted_peaks(topo: Topology, pairs, flit_bytes: int, n_vcs: int,
                    depth: int) -> tuple[int, int]:
    """(peak_queue, peak_link_flits) bounds for one raw pair layout —
    the standalone-workload analog of :func:`executor_bounds`."""
    loads = wave_channel_loads(topo, pairs, flit_bytes, n_vcs)
    if not loads:
        return 0, 0
    return (min(depth, max(loads.values())),
            len({(u, v) for u, v, _ in loads}))
