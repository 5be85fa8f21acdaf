"""The paper's three case studies on the port: GF(2) BMVM (``bmvm``), LDPC
min-sum decoding (``ldpc``) and particle-filter tracking
(``particle_filter``)."""
from __future__ import annotations

from typing import Optional, Sequence

from ..core import NoCExecutor, QuasiSerdesConfig, cut, resolve_placement


def noc_executor(graph, topo, placement, pods: Optional[Sequence[int]], serdes_cfg,
                 tracer, device):
    """The apps' NoC flow: placement (``"opt"`` is cut-aware when ``pods`` is
    given) → optional pod cut with ``serdes_cfg`` framing → executor, traced
    into ``tracer`` when one is given."""
    place = resolve_placement(graph, topo, placement, pod_of_node=pods, serdes_cfg=serdes_cfg)
    plan = None
    if pods is not None:
        plan = cut(graph, place, pods, serdes_cfg or QuasiSerdesConfig())
    return NoCExecutor(graph, topo, placement=place, plan=plan, trace=tracer,
                       device=device)
