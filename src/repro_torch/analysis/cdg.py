"""Dally–Seitz channel-dependency deadlock proofs for the wormhole switch
(port of ``repro.analysis.cdg``).

A *channel* is one input VC FIFO of the buffered switch, identified by the
directed physical link it terminates plus the virtual channel:
``(u, v, vc)`` — the VC-``vc`` FIFO at router ``v`` fed by upstream ``u``.
Routing induces a dependency ``a -> b`` whenever some packet's route occupies
channel ``a`` and next requests channel ``b``: a flit parked in ``a`` can be
waiting on buffer space in ``b``.  The classic theorem (Dally & Seitz 1987):
wormhole routing is deadlock-free **iff** this channel dependency graph is
acyclic.

:func:`build_cdg` enumerates every ``dor_route`` of a topology (the switch's
routing function, including its dateline VC assignment) and collects the
dependency edges; :func:`deadlock_cycle` returns ``None`` as a *proof* of
deadlock freedom or a concrete channel cycle as the counterexample.  This
replaces the hand-written "wrapped topologies need 2 VCs" guard, which was
imprecise in both directions — e.g. a 2-node ring or 2×2 torus is provably
safe at one VC (each dimension's routes are single-hop, so no dependency
chain ever forms), while the cyclic cases now come with the actual cycle.

:func:`find_wait_cycle` is the runtime companion: given the wait-for map of a
wedged simulation (each occupied channel → the channel its head flit wants),
it names the culprit cycle for the ``DeadlockError`` message.
"""
from __future__ import annotations

import functools
from typing import Hashable, Mapping, Optional, Sequence

from ..core.topology import Topology
from .diagnostics import Diagnostic, diag

#: one input-VC FIFO: (upstream node, downstream node, virtual channel)
Channel = tuple[int, int, int]


def route_channels(topo: Topology, src: int, dst: int,
                   n_vcs: int) -> list[Channel]:
    """The channel sequence a (src, dst) packet occupies under dor_route."""
    from ..core.switch import dor_route

    route, vcs = dor_route(topo, src, dst, n_vcs)
    return [(route[i], route[i + 1], vcs[i]) for i in range(len(route) - 1)]


def build_cdg(topo: Topology, n_vcs: int) -> dict[Channel, set[Channel]]:
    """Channel dependency graph of every dor_route over ``topo``."""
    deps: dict[Channel, set[Channel]] = {}
    n = topo.n_nodes
    for s in range(n):
        for d in range(n):
            if s == d:
                continue
            chans = route_channels(topo, s, d, n_vcs)
            for c in chans:
                deps.setdefault(c, set())
            for a, b in zip(chans, chans[1:]):
                deps[a].add(b)
    return deps


def find_graph_cycle(deps: Mapping[Hashable, set]) -> Optional[list]:
    """First cycle of a directed graph (DFS), or None if acyclic."""
    WHITE, GRAY, BLACK = 0, 1, 2
    color = dict.fromkeys(deps, WHITE)
    for root in deps:
        if color[root] != WHITE:
            continue
        color[root] = GRAY
        path = [root]
        iters = [iter(sorted(deps[root]))]
        while path:
            nxt = next(iters[-1], None)
            if nxt is None:
                color[path.pop()] = BLACK
                iters.pop()
                continue
            c = color.get(nxt, BLACK)
            if c == GRAY:
                return path[path.index(nxt):]
            if c == WHITE:
                color[nxt] = GRAY
                path.append(nxt)
                iters.append(iter(sorted(deps.get(nxt, ()))))
    return None


@functools.lru_cache(maxsize=None)
def deadlock_cycle(topo: Topology, n_vcs: int) -> Optional[tuple[Channel, ...]]:
    """``None`` ⇒ the (topology, routing, VC assignment) combination is
    provably wormhole-deadlock-free; otherwise a concrete channel cycle.
    Cached per (topo, n_vcs) — topologies are frozen/hashable."""
    cyc = find_graph_cycle(build_cdg(topo, n_vcs))
    return tuple(cyc) if cyc else None


def format_channel_cycle(cycle: Sequence[Channel]) -> str:
    hops = " -> ".join(f"({u}->{v} vc{vc})" for u, v, vc in cycle)
    u0, v0, vc0 = cycle[0]
    return f"{hops} -> back to ({u0}->{v0} vc{vc0})"


def check_deadlock_freedom(topo: Topology, n_vcs: int,
                           where: str = "") -> list[Diagnostic]:
    """NOC001/NOC002 diagnostics for one (topology, n_vcs) combination."""
    if n_vcs < 1:
        return [diag("NOC002", f"n_vcs={n_vcs} must be >= 1", where)]
    cyc = deadlock_cycle(topo, n_vcs)
    if cyc is None:
        return []
    return [diag(
        "NOC001",
        f"{topo.name} n={topo.n_nodes} with n_vcs={n_vcs} has a cyclic "
        f"channel dependency — wormhole traffic can deadlock: "
        f"{format_channel_cycle(cyc)}; wrapped dimensions need n_vcs >= 2 "
        f"dateline escape channels", where)]


def find_wait_cycle(waits: Mapping[Hashable, Hashable]) -> Optional[list]:
    """Cycle in a wait-for map (each key waits on exactly one successor).

    Used by the runtime DeadlockError to name the culprit channels of a
    wedged simulation; returns the cycle in wait order, or None."""
    done: set = set()
    for start in waits:
        if start in done:
            continue
        pos: dict = {}
        path: list = []
        k = start
        while k in waits and k not in pos and k not in done:
            pos[k] = len(path)
            path.append(k)
            k = waits[k]
        if k in pos:
            return path[pos[k]:]
        done.update(path)
    return None
