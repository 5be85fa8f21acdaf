"""The paper's three case studies on the port: GF(2) BMVM (``bmvm``), LDPC
min-sum decoding (``ldpc``) and particle-filter tracking
(``particle_filter``)."""
from __future__ import annotations

from typing import Optional, Sequence

from ..core import NoCExecutor, QuasiSerdesConfig, cut, resolve_placement


def reject_later_options(tracer=None) -> None:
    """The apps' telemetry argument belongs to a later slice of the port; it
    raises instead of being ignored."""
    if tracer is not None:
        raise NotImplementedError("telemetry (tracer=) is not ported yet "
                                  "(ROADMAP Queue 1 item 6)")


def noc_executor(graph, topo, placement, pods: Optional[Sequence[int]], serdes_cfg,
                 tracer, device):
    """The apps' NoC flow: placement (``"opt"`` is cut-aware when ``pods`` is
    given) → optional pod cut with ``serdes_cfg`` framing → executor."""
    reject_later_options(tracer)
    place = resolve_placement(graph, topo, placement, pod_of_node=pods, serdes_cfg=serdes_cfg)
    plan = None
    if pods is not None:
        plan = cut(graph, place, pods, serdes_cfg or QuasiSerdesConfig())
    return NoCExecutor(graph, topo, placement=place, plan=plan, device=device)
