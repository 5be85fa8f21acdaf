"""Phase-2 of the paper, placement half: map TaskGraph PEs onto topology
nodes (``repro.core.partition`` lines 38-84 and 243-271 there).

Round-robin and the greedy traffic-aware placer are here, and
`resolve_placement` accepts ``"rr"``, ``"greedy"`` or an explicit mapping.  The
annealing search (``"opt"``) and pod cutting wait for ROADMAP Queue 1 item 4's
remainder and item 7.
"""
from __future__ import annotations

from typing import Mapping

from .graph import TaskGraph
from .topology import Topology


def place_round_robin(graph: TaskGraph, topo: Topology) -> dict[str, int]:
    names = list(graph.pes)
    return {n: i % topo.n_nodes for i, n in enumerate(names)}


def place_greedy(graph: TaskGraph, topo: Topology) -> dict[str, int]:
    """Traffic-aware: place heavy-talking PE pairs on low-hop node pairs.

    Classic greedy: order PE pairs by traffic desc; for each, put the unplaced
    endpoint on the free node closest to the placed one.
    """
    traffic = graph.traffic_bytes()
    pairs = sorted(traffic.items(), key=lambda kv: -kv[1])
    placement: dict[str, int] = {}
    free = set(range(topo.n_nodes))

    def nearest_free(anchor: int) -> int:
        if not free:
            # more PEs than nodes: fall back to min-load node
            loads: dict[int, int] = {}
            for v in placement.values():
                loads[v] = loads.get(v, 0) + 1
            return min(range(topo.n_nodes), key=lambda n: loads.get(n, 0))
        return min(free, key=lambda n: topo.hops(anchor, n))

    for (a, b), _ in pairs:
        if a not in placement and b not in placement:
            na = min(free) if free else 0
            placement[a] = na
            free.discard(na)
            nb = nearest_free(na)
            placement[b] = nb
            free.discard(nb)
        elif a in placement and b not in placement:
            nb = nearest_free(placement[a])
            placement[b] = nb
            free.discard(nb)
        elif b in placement and a not in placement:
            na = nearest_free(placement[b])
            placement[a] = na
            free.discard(na)
    for n in graph.pes:  # isolated PEs
        if n not in placement:
            node = min(free) if free else 0
            placement[n] = node
            free.discard(node)
    return placement


def resolve_placement(graph: TaskGraph, topo: Topology, spec="rr") -> dict[str, int]:
    """Turn a placement spec into a PE→node map: ``"rr"`` (round-robin),
    ``"greedy"`` or an explicit mapping, which is passed through."""
    if isinstance(spec, Mapping):
        missing = set(graph.pes) - set(spec)
        if missing:
            raise ValueError(f"placement mapping is missing PEs {sorted(missing)}")
        bad = {p: n for p, n in spec.items() if not 0 <= n < topo.n_nodes}
        if bad:
            raise ValueError(f"placement mapping has out-of-range nodes {bad} "
                             f"(topology has {topo.n_nodes} nodes)")
        return dict(spec)
    if spec == "rr":
        return place_round_robin(graph, topo)
    if spec == "greedy":
        return place_greedy(graph, topo)
    if spec == "opt":
        raise NotImplementedError("placement 'opt' (annealing search) is not "
                                  "ported yet (ROADMAP Queue 1 item 4)")
    raise ValueError(f"unknown placement spec {spec!r}; use 'rr'|'greedy'|'opt' or a mapping")
