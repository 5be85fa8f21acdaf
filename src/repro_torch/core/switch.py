"""Buffered wormhole switching: cycle-accurate contention-aware NoC transport
(port of ``repro.core.switch``).

The lock-step modes (``direct``, ``sim``, the bridged variants) run
contention-free compiled schedules.  This module adds the congestion regime a
CONNECT-style fabric lives in:

* **per-port input FIFOs** of ``buffer_depth`` flits, one per virtual
  channel, with credit backpressure (a flit advances only into a FIFO with a
  free slot);
* **X-Y dimension-ordered routing** over the `core.topology` meshes and tori
  (unidirectional rotation on the ring, one crossbar hop on the fat-tree);
* **round-robin arbitration** between the input (port, VC) slots competing
  for an output port — one flit per physical output per cycle, losers
  counted as ``arb_losses``;
* **packet-atomic (wormhole) switching per virtual channel**: a downstream VC
  FIFO belongs to one packet from header to tail, while the physical link is
  multiplexed between VCs cycle by cycle;
* **dateline virtual channels** on wrapped dimensions: packets switch from
  VC 0 to VC 1 when they cross a wraparound link, which breaks the ring's
  cyclic channel dependency (`analysis.cdg` proves it per topology).

The cycle machine is host bookkeeping over ``(packet, flit)`` tokens: the
state tables, arbitration rings and grant order are the reference's, so
:class:`SwitchStats`, completions and the ejection log equal its field for
field, and a ``tracer=`` records the reference's events (Python ints, in the
reference's order).  No device operation runs per flit or per cycle.
Payload bytes stay where they are: each ejected token ``(pid, fidx)`` at node
``u`` names bytes ``[fidx*flit_bytes, (fidx+1)*flit_bytes)`` of packet
``pid``, and the delivered bytes are rebuilt from those tokens with one
gather and one scatter on the payload's own device (numpy for host
payloads).

:func:`simulate_wormhole_cube` adapts the simulator to the executor's
``(n, n, buf_bytes)`` message-cube contract (``NoCExecutor(mode="buffered")``):
``delivered[d, s]`` is assembled from the tokens ejected at ``d`` — equal to
``simulate_schedule``'s delivery by the exactly-once property, not by a
transpose.  :func:`switch_lower_bound` and :func:`saturation_rate` are the
analytic model the simulator can never beat.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Optional, Sequence

import numpy as np
import torch

from .topology import FatTree, Mesh2D, Ring, Topology, Torus2D

EJECT = -2    # output-port key: consume the flit at the local node
INJECT = -1   # input-port key: the node's (unbounded) injection queue


class DeadlockError(RuntimeError):
    """No flit can move, nothing left to inject: a cyclic resource wait."""


@dataclasses.dataclass(frozen=True)
class SwitchConfig:
    """CONNECT "Router Options" analog for the buffered mode.

    ``buffer_depth``  — input FIFO depth per (port, VC), in flits; depth 1 is
                        the legal worst case.
    ``n_vcs``         — virtual channels per input port; >= 2 required for
                        wrapped topologies (ring/torus datelines).
    ``flit_bytes``    — bytes carried per flit (== NoCConfig.flit_wire_bytes).
    ``max_cycles``    — optional hard horizon (DeadlockError past it).
    """

    buffer_depth: int = 4
    n_vcs: int = 2
    flit_bytes: int = 2
    max_cycles: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class Packet:
    """One wormhole packet: ``n_flits`` flits injected at ``t_inject``.

    ``payload`` (optional) is a numpy array or a tensor whose bytes the flits
    carry; flit ``f`` carries bytes ``[f*flit_bytes, (f+1)*flit_bytes)``
    (zero-padded)."""

    src: int
    dst: int
    n_flits: int
    t_inject: int = 0
    payload: Optional[Any] = None


@dataclasses.dataclass
class SwitchStats:
    """Counters of one :func:`simulate_switch` run (NoCStats ``switch_*``)."""

    cycles: int = 0            # cycles until the last tail flit ejected
    packets: int = 0           # packets delivered (== offered, asserted)
    flits: int = 0             # flits ejected
    link_flits: int = 0        # flit-hops over router->router links
    stall_cycles: int = 0      # head flits blocked on credit/VC allocation
    arb_losses: int = 0        # eligible head flits that lost an arbitration
    max_queue: int = 0         # peak input-FIFO occupancy, flits
    peak_link_flits: int = 0   # peak flits crossing links in one cycle
    latency_sum: int = 0
    latency_max: int = 0

    @property
    def avg_latency(self) -> float:
        """Mean packet latency in cycles; 0.0 when nothing was delivered."""
        if self.packets == 0:
            return 0.0
        return self.latency_sum / self.packets

    def throughput(self, n_nodes: int) -> float:
        """Accepted load over the whole run, flits/cycle/node; 0.0 for an
        empty run or a degenerate node count."""
        if self.cycles <= 0 or n_nodes <= 0:
            return 0.0
        return self.flits / self.cycles / n_nodes


@dataclasses.dataclass
class SwitchResult:
    stats: SwitchStats
    completions: np.ndarray          # per-packet tail-eject cycle (exclusive)
    payloads: list                   # per-packet delivered bytes (or None)
    ejections: Optional[list] = None  # (cycle, packet_id) log when recorded


# ---------------------------------------------------------------------------
# X-Y dimension-ordered routing + dateline VC assignment
# ---------------------------------------------------------------------------

def dor_route(topo: Topology, src: int, dst: int,
              n_vcs: int = 2) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """Dimension-ordered route and per-hop virtual channels.

    Returns ``(route, vcs)``: ``route = (src, ..., dst)`` visits neighbors
    only and never revisits a node; ``vcs[i]`` is the VC of the input FIFO the
    packet occupies at ``route[i+1]``.  VC 0 until the path crosses a
    wraparound (dateline) link in the current dimension, VC 1 from that hop
    on; the VC resets to 0 when routing switches dimension."""
    if src == dst:
        return (src,), ()
    esc = min(1, n_vcs - 1)
    if isinstance(topo, FatTree):
        return (src, dst), (0,)
    if isinstance(topo, Ring):
        # paper-faithful CONNECT ring: unidirectional +1 rotation
        n = topo.n_nodes
        route, vcs, vc, cur = [src], [], 0, src
        while cur != dst:
            if cur == n - 1:          # the n-1 -> 0 hop crosses the dateline
                vc = esc
            cur = (cur + 1) % n
            route.append(cur)
            vcs.append(vc)
        return tuple(route), tuple(vcs)
    if isinstance(topo, Mesh2D):      # Torus2D is a subclass
        wrap = isinstance(topo, Torus2D)
        x, y = topo.coords(src)
        dx, dy = topo.coords(dst)
        route, vcs = [src], []
        for size, cur, tgt, axis in ((topo.rx, x, dx, "x"), (topo.ry, y, dy, "y")):
            vc = 0
            while cur != tgt:
                if wrap:
                    fwd = (tgt - cur) % size
                    step = 1 if fwd <= size - fwd else -1
                    if (cur == size - 1 and step == 1) or (cur == 0 and step == -1):
                        vc = esc      # this hop crosses the dimension dateline
                    cur = (cur + step) % size
                else:
                    cur += 1 if tgt > cur else -1
                if axis == "x":
                    x = cur
                else:
                    y = cur
                route.append(topo.node(x, y))
                vcs.append(vc)
        return tuple(route), tuple(vcs)
    raise TypeError(f"no dimension-ordered routes for {type(topo).__name__}")


# ---------------------------------------------------------------------------
# cycle simulator
# ---------------------------------------------------------------------------

def _run_switch(topo: Topology, packets: Sequence[Packet], cfg: SwitchConfig,
                record_ejections: bool, verify: bool, tracer=None):
    """The cycle machine.  Returns ``(stats, completions, ejection log,
    tokens)`` where ``tokens`` lists every ejected ``(pid, fidx, node)`` in
    ejection order.

    Router ``u``'s arbitration ring is the reference's: the injection slot
    first, then ``(upstream, vc)`` for its sorted neighbors.  Only occupied
    FIFOs are visited each cycle; requests are grouped and granted per
    ``(router, output)`` in sorted order and applied in that order, as the
    reference applies them, so every counter (``max_queue`` included) and
    every trace event (``flit`` in grant order, ``pkt`` at tail ejection,
    ``queue`` as the cycle's peak) comes out the same.  ``tracer`` events are
    listed in :func:`simulate_switch`; their args are Python ints."""
    n = topo.n_nodes
    depth = cfg.buffer_depth
    if depth < 1:
        raise ValueError("buffer_depth must be >= 1")
    if cfg.n_vcs < 1:
        raise ValueError(f"n_vcs must be >= 1, got {cfg.n_vcs}")
    if verify:
        from ..analysis.cdg import check_deadlock_freedom

        found = check_deadlock_freedom(topo, cfg.n_vcs, "SwitchConfig.n_vcs")
        if found:
            raise ValueError(str(found[0]))

    # -- arbitration rings and input FIFOs -------------------------------------
    # FIFO ids: router u's injection queue is FIFO u, then one FIFO per
    # (router, upstream, vc).  A neighbor listed twice (a ring or torus
    # dimension of size 2) puts one FIFO at two ring positions, as in the
    # reference, where both positions request for the same head flit.
    rings: list[list[tuple[int, int]]] = []
    fifo_of: dict[tuple[int, int, int], int] = {(u, INJECT, 0): u for u in range(n)}
    for u in range(n):
        slots = [(INJECT, 0)]
        for up in sorted(topo.neighbors(u)):
            for vc in range(cfg.n_vcs):
                slots.append((up, vc))
                fifo_of.setdefault((u, up, vc), len(fifo_of))
        rings.append(slots)
    ring_len = [len(r) for r in rings]
    router_of = [0] * len(fifo_of)
    positions: list[list[int]] = [[] for _ in fifo_of]   # ring positions of a FIFO
    for u, slots in enumerate(rings):
        for si, (up, vc) in enumerate(slots):
            f = fifo_of[(u, up, vc)]
            router_of[f] = u
            positions[f].append(si)
    fifos = [deque() for _ in fifo_of]
    owner: list[Optional[int]] = [None] * len(fifo_of)

    # -- static per-packet tables: node -> (out_key, downstream FIFO, its VC) ---
    P = len(packets)
    nxt: list[dict[int, tuple[int, int, int]]] = []
    routes: dict[tuple[int, int], dict[int, tuple[int, int, int]]] = {}
    for p in packets:
        if p.n_flits < 1:
            raise ValueError(f"packet {p.src}->{p.dst}: n_flits must be >= 1")
        if p.payload is not None:
            size = (p.payload.numel() * p.payload.element_size()
                    if isinstance(p.payload, torch.Tensor) else np.asarray(p.payload).nbytes)
            if size > p.n_flits * cfg.flit_bytes:
                raise ValueError(f"payload {size}B exceeds {p.n_flits} flits x "
                                 f"{cfg.flit_bytes}B")
        tab = routes.get((p.src, p.dst))
        if tab is None:
            route, vcs = dor_route(topo, p.src, p.dst, cfg.n_vcs)
            hops = len(route) - 1
            tab = {route[i]: (route[i + 1], fifo_of[(route[i + 1], route[i], vcs[i])], vcs[i])
                   if i < hops else (EJECT, -1, 0) for i in range(hops + 1)}
            routes[(p.src, p.dst)] = tab
        nxt.append(tab)

    # -- dynamic state ---------------------------------------------------------
    active: set[int] = set()              # occupied FIFOs
    rr: dict[tuple[int, int], int] = {}
    order = sorted(range(P), key=lambda i: (packets[i].t_inject, i))
    inj_ptr = 0
    stats = SwitchStats()
    # telemetry (traced runs only; the untraced loop allocates nothing): the
    # run's clock base, per-packet credit-stall and arbitration-loss charges
    # (to the packet at the head of the blocked FIFO) and per-link flit tallies
    traced = tracer is not None
    base = tracer.clock if traced else 0
    flit_detail = traced and tracer.detail == "flits"
    pkt_stall = pkt_arb = link_tally = None
    if traced and P:
        pkt_stall, pkt_arb, link_tally = [0] * P, [0] * P, {}
        tracer.instant("switch_run", "switch", ts=base, packets=P,
                       flits=sum(p.n_flits for p in packets),
                       bound=switch_lower_bound(topo, packets, cfg))
    t_stall0 = t_arb0 = t_ej0 = cyc_q = 0
    completions = np.full(P, -1, np.int64)
    ejected = [0] * P                     # flits ejected so far, per packet
    ej_log: Optional[list] = [] if record_ejections else None
    tokens: list[tuple[int, int, int]] = []
    c = 0
    while stats.packets < P:
        if cfg.max_cycles is not None and c > cfg.max_cycles:
            raise DeadlockError(f"max_cycles={cfg.max_cycles} exceeded with "
                                f"{P - stats.packets} packets in flight")
        injected = False
        while inj_ptr < P and packets[order[inj_ptr]].t_inject <= c:
            pid = order[inj_ptr]
            src = packets[pid].src
            fifos[src].extend((pid, f) for f in range(packets[pid].n_flits))
            active.add(src)
            inj_ptr += 1
            injected = True
        if traced:   # start-of-cycle baselines for the cycle event's deltas
            t_stall0, t_arb0, t_ej0 = stats.stall_cycles, stats.arb_losses, stats.flits
            cyc_q = 0
        # ---- gather requests: head flit of every occupied input slot --------
        reqs: dict[tuple[int, int], list] = {}
        for g in active:
            pid, fidx = fifos[g][0]
            u = router_of[g]
            okey, dg, _ = nxt[pid][u]
            if okey == EJECT:
                elig = True
            else:
                # wormhole VC allocation: the downstream VC belongs to one
                # packet header-to-tail; headers claim a free VC, body flits
                # follow their claim — both need a credit
                own = owner[dg]
                elig = len(fifos[dg]) < depth and (own == pid or (own is None and fidx == 0))
            cands = reqs.setdefault((u, okey), [])
            for si in positions[g]:
                cands.append((si, g, pid, fidx, dg, elig))
        # ---- arbitrate: one flit per physical output port per cycle ----------
        moves = []
        for (u, okey), cands in sorted(reqs.items()):
            elig = [cand for cand in cands if cand[5]]
            stats.stall_cycles += len(cands) - len(elig)
            if not elig:
                continue
            ptr = rr.get((u, okey), 0)
            L = ring_len[u]
            win = min(elig, key=lambda cand: (cand[0] - ptr) % L)
            stats.arb_losses += len(elig) - 1
            rr[(u, okey)] = (win[0] + 1) % L
            moves.append((u, okey, win))
        if traced:
            # charge each blocked head to its packet: credit/VC stalls, and
            # arbitration losses of the eligible heads that did not win
            won = {(u, okey): win for u, okey, win in moves}
            for key, cands in reqs.items():
                win = won.get(key)
                for cand in cands:
                    if not cand[5]:
                        pkt_stall[cand[2]] += 1
                    elif cand is not win:
                        pkt_arb[cand[2]] += 1
        # ---- apply (grants were computed on start-of-cycle state) ------------
        link_moves = 0
        for u, okey, (si, g, pid, fidx, dg, _) in moves:
            pkt = packets[pid]
            tail = fidx == pkt.n_flits - 1
            q = fifos[g]
            q.popleft()
            if not q:
                active.discard(g)
            if g >= n and tail:          # a link FIFO, not an injection queue
                owner[g] = None
            if okey == EJECT:
                assert u == pkt.dst, (pid, u, pkt.dst)
                # wormhole keeps a packet's flits in order on one path:
                # in-order arrival here IS exactly-once delivery
                assert fidx == ejected[pid], (pid, fidx, ejected[pid])
                ejected[pid] += 1
                stats.flits += 1
                tokens.append((pid, fidx, u))
                if ej_log is not None:
                    ej_log.append((c, pid))
                if tail:
                    stats.packets += 1
                    lat = c + 1 - pkt.t_inject
                    stats.latency_sum += lat
                    stats.latency_max = max(stats.latency_max, lat)
                    completions[pid] = c + 1
                    if traced:
                        tracer.instant("pkt", f"node {pkt.dst}", ts=base + c, pid=pid,
                                       src=pkt.src, dst=pkt.dst, flits=pkt.n_flits,
                                       hops=len(nxt[pid]) - 1, inject=pkt.t_inject, lat=lat,
                                       stall=pkt_stall[pid], arb=pkt_arb[pid])
            else:
                dq = fifos[dg]
                dq.append((pid, fidx))
                active.add(dg)
                if fidx == 0:
                    owner[dg] = pid
                link_moves += 1
                stats.link_flits += 1
                stats.max_queue = max(stats.max_queue, len(dq))
                if traced:
                    link_tally[(u, okey)] = link_tally.get((u, okey), 0) + 1
                    if len(dq) > cyc_q:
                        cyc_q = len(dq)
                    if flit_detail:
                        tracer.instant("flit", f"router {u}", ts=base + c, pid=pid, f=fidx,
                                       vc=rings[u][si][1], to=okey)
        stats.peak_link_flits = max(stats.peak_link_flits, link_moves)
        if not moves and not injected:
            if inj_ptr < P:   # idle gap: fast-forward to the next injection
                if traced:
                    tracer.instant("idle_ff", "switch", ts=base + c,
                                   to=packets[order[inj_ptr]].t_inject)
                c = packets[order[inj_ptr]].t_inject
                continue
            report, wedged, wait = _deadlock_report(c, packets, completions, rings,
                                                    fifos, fifo_of, nxt)
            if traced:
                tracer.instant("deadlock", "switch", ts=base + c, wedged=wedged,
                               wait_cycle=wait)
            raise DeadlockError(report)
        if traced:
            tracer.instant("cycle", "switch", ts=base + c, c=c, moves=link_moves,
                           bytes=link_moves * cfg.flit_bytes,
                           stalls=stats.stall_cycles - t_stall0,
                           arb=stats.arb_losses - t_arb0, ejects=stats.flits - t_ej0)
            if cyc_q:
                tracer.counter("queue", "switch queue", cyc_q, ts=base + c)
        c += 1
    stats.cycles = c
    if link_tally:
        # end-of-run per-link totals: what the heatmap and the profiler's
        # hot-link attribution read for buffered runs
        ts_end = base + max(c - 1, 0)
        for (u, v), flits in sorted(link_tally.items()):
            tracer.counter("link", f"link {u}->{v}", flits * cfg.flit_bytes, ts=ts_end)
    assert sum(ejected) == sum(p.n_flits for p in packets)
    return stats, completions, ej_log, tokens


def _deadlock_report(c, packets, completions, rings, fifos, fifo_of,
                     nxt) -> tuple[str, int, int]:
    """The reference's DeadlockError message — the wedged packets and the
    culprit wait cycle over occupied input slots (router order, ring order) —
    with the number of wedged packets and the wait cycle's length."""
    from ..analysis.cdg import find_wait_cycle

    stuck = [(pid, packets[pid].src, packets[pid].dst)
             for pid in range(len(packets)) if completions[pid] < 0]
    # wait-for map: each head flit points at the downstream input FIFO it
    # needs a credit/VC grant from
    waits: dict[tuple[int, int, int], tuple[int, int, int]] = {}
    for u, slots in enumerate(rings):
        for up, vc in slots:
            q = fifos[fifo_of[(u, up, vc)]]
            if not q:
                continue
            pid, _ = q[0]
            okey, _, dvc = nxt[pid][u]
            if okey != EJECT:
                waits[(u, up, vc)] = (okey, u, dvc)
    wcyc = find_wait_cycle(waits)
    culprit = ""
    if wcyc:
        hops = " -> ".join(f"[router {r} <- {'inject' if up == INJECT else up} vc{vc}]"
                           for r, up, vc in wcyc)
        culprit = (f"; culprit wait cycle across {len(wcyc)} router input(s): "
                   f"{hops} -> back to start")
    return (f"cycle {c}: no flit can move, {len(stuck)} packets wedged "
            f"(first few: {stuck[:4]}) — cyclic buffer wait{culprit}",
            len(stuck), len(wcyc) if wcyc else 0)


def _token_bytes(tokens: Sequence[tuple[int, int, int]], fb: int,
                 limit: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per delivered byte: ``(pid, byte offset in the packet, node)`` of every
    ejected token ``(pid, fidx, node)``, each flit cut to ``limit[pid]``."""
    tok = np.asarray(tokens, np.int64).reshape(-1, 3)
    pid, fidx, node = tok[:, 0], tok[:, 1], tok[:, 2]
    start = fidx * fb
    count = np.clip(limit[pid] - start, 0, fb)
    rep = np.repeat(np.arange(len(tok)), count)
    within = np.arange(rep.size) - np.repeat(np.cumsum(count) - count, count)
    return pid[rep], start[rep] + within, node[rep]


def simulate_switch(topo: Topology, packets: Sequence[Packet],
                    cfg: Optional[SwitchConfig] = None,
                    record_ejections: bool = False,
                    verify: bool = True,
                    tracer=None) -> SwitchResult:
    """Cycle-accurate wormhole simulation of ``packets`` over ``topo``.

    Per cycle: every occupied input (port, VC) FIFO head requests its packet's
    next output; per physical output one flit is granted (owner VCs and
    credit-eligible headers compete, round-robin); grants are computed against
    start-of-cycle state and applied atomically.  Raises
    :class:`DeadlockError` on a zero-move fixed point with flits in flight.

    With ``verify=True`` (default) the (topology, n_vcs) combination is first
    proven deadlock-free via the channel-dependency graph (`analysis.cdg`);
    cyclic combinations raise ``ValueError`` with the channel cycle.
    ``verify=False`` lets doomed configurations run into `DeadlockError`.

    Payloads (numpy arrays or tensors) are delivered from the ejected tokens
    on their own device.

    ``tracer`` (a `telemetry.Tracer`, optional) records one ``switch_run``
    instant up front (packet/flit totals and the analytic
    `switch_lower_bound`), one ``cycle`` instant per executed cycle (link
    moves and bytes, stall/arbitration/ejection deltas), a ``queue`` counter
    with the cycle's peak FIFO occupancy when a FIFO grew, ``idle_ff``
    fast-forward markers, one ``pkt`` instant per packet at tail ejection
    (inject cycle, latency, hops, its credit-stall and arbitration-loss
    counts), a ``deadlock`` instant before the error is raised, and per-link
    ``link`` byte counters at the end of the run; ``tracer.detail ==
    "flits"`` adds one ``flit`` instant per link move.  Timestamps are
    ``tracer.clock + cycle``, so the caller positions the run on its
    timeline.  ``tracer=None`` adds no work to the loop beyond its checks."""
    cfg = cfg or SwitchConfig()
    stats, completions, ej_log, tokens = _run_switch(topo, packets, cfg,
                                                     record_ejections, verify, tracer)
    payloads = _deliver_payloads(packets, tokens, cfg.flit_bytes)
    return SwitchResult(stats, completions, payloads, ej_log)


def _deliver_payloads(packets: Sequence[Packet], tokens, fb: int) -> list:
    """Per packet, the flit-padded bytes its ejected tokens carried (None for
    a packet without a payload).  Payloads are grouped by device (numpy ones
    on the CPU, returned as numpy); each group is one gather and one scatter
    over its concatenated payloads."""
    payloads: list = [None] * len(packets)
    groups: dict[torch.device, list] = {}
    for pid, p in enumerate(packets):
        if p.payload is not None:
            is_np = not isinstance(p.payload, torch.Tensor)
            if is_np:
                raw = torch.from_numpy(np.ascontiguousarray(p.payload).reshape(-1).view(np.uint8))
            else:
                raw = p.payload.contiguous().reshape(-1).view(torch.uint8)
            groups.setdefault(raw.device, []).append((pid, raw, is_np))
    if not groups:
        return payloads
    limit = np.array([p.n_flits * fb for p in packets], np.int64)
    tpid, off, _ = _token_bytes(tokens, fb, limit)
    for dev, members in groups.items():
        pids = np.array([pid for pid, _, _ in members], np.int64)
        start = np.zeros(len(packets), np.int64)
        start[pids] = np.cumsum(limit[pids]) - limit[pids]
        keep = np.isin(tpid, pids)
        idx = torch.as_tensor(start[tpid[keep]] + off[keep], device=dev)
        src = torch.cat([torch.nn.functional.pad(raw, (0, int(limit[pid]) - raw.numel()))
                         for pid, raw, _ in members])
        out = torch.zeros_like(src)
        out[idx] = src[idx]
        for pid, _, is_np in members:
            seg = out[int(start[pid]):int(start[pid] + limit[pid])]
            payloads[pid] = seg.numpy() if is_np else seg
    return payloads


# ---------------------------------------------------------------------------
# analytic model: lower bound + saturation
# ---------------------------------------------------------------------------

def link_loads(topo: Topology, packets: Sequence[Packet],
               n_vcs: int = 2) -> dict[tuple[int, int], int]:
    """Flits crossing each directed link under dimension-ordered routing."""
    loads: dict[tuple[int, int], int] = {}
    for p in packets:
        route, _ = dor_route(topo, p.src, p.dst, n_vcs)
        for i in range(len(route) - 1):
            key = (route[i], route[i + 1])
            loads[key] = loads.get(key, 0) + p.n_flits
    return loads


def switch_lower_bound(topo: Topology, packets: Sequence[Packet],
                       cfg: Optional[SwitchConfig] = None) -> int:
    """Exact lower bound on :func:`simulate_switch` drain cycles: the max of
    the pipeline (``t_inject + hops + n_flits``), ejection-port and per-link
    serialization arguments."""
    cfg = cfg or SwitchConfig()
    lb = 0
    eject: dict[int, list[int]] = {}          # dst -> [load, min_lead]
    links: dict[tuple[int, int], list[int]] = {}  # link -> [load, lead, trail]
    for p in packets:
        route, _ = dor_route(topo, p.src, p.dst, cfg.n_vcs)
        hops = len(route) - 1
        lb = max(lb, p.t_inject + hops + p.n_flits)
        e = eject.setdefault(p.dst, [0, p.t_inject + hops])
        e[0] += p.n_flits
        e[1] = min(e[1], p.t_inject + hops)
        for i in range(hops):
            rec = links.setdefault((route[i], route[i + 1]),
                                   [0, p.t_inject + i, hops - i])
            rec[0] += p.n_flits
            rec[1] = min(rec[1], p.t_inject + i)
            rec[2] = min(rec[2], hops - i)
    for load, lead in eject.values():
        lb = max(lb, lead + load)
    for load, lead, trail in links.values():
        lb = max(lb, lead + load + trail)
    return lb


def saturation_rate(topo: Topology, matrix: np.ndarray,
                    n_vcs: int = 2) -> float:
    """Analytic saturation injection rate, flits/cycle/node, for the
    destination distribution ``matrix[s, d]`` (rows sum to 1): the rate at
    which the most-loaded channel (link or ejection port) reaches one flit a
    cycle."""
    n = topo.n_nodes
    matrix = np.asarray(matrix, np.float64)
    assert matrix.shape == (n, n)
    load: dict = {}
    for s in range(n):
        for d in range(n):
            w = float(matrix[s, d])
            if w <= 0.0:
                continue
            route, _ = dor_route(topo, s, d, n_vcs)
            for i in range(len(route) - 1):
                key = (route[i], route[i + 1])
                load[key] = load.get(key, 0.0) + w
            ekey = (EJECT, d)
            load[ekey] = load.get(ekey, 0.0) + w
    if not load:            # no traffic at all (e.g. single-node topology)
        return float("inf")
    return 1.0 / max(load.values())


# ---------------------------------------------------------------------------
# executor adapter: (n, n, buf_bytes) message-cube transport
# ---------------------------------------------------------------------------

def simulate_wormhole_cube(topo: Topology, msgs: torch.Tensor,
                           cfg: Optional[SwitchConfig] = None,
                           pairs: Optional[Sequence[tuple[int, int, int]]] = None,
                           batched: bool = False,
                           tracer=None) -> tuple[torch.Tensor, SwitchStats]:
    """Move one ``(n, n, buf)`` uint8 message cube through the buffered wormhole
    switch: same ``(delivered, stats)`` contract as
    :func:`routing.simulate_schedule` (``delivered[d, s] == msgs[s, d]``).

    ``pairs`` — optional ``(src, dst, nbytes)`` triples naming the occupied
    buffers (the executor passes each wave's compiled pair layout); by default
    every ``(s, d)`` buffer ships in full.  Each occupied buffer becomes ONE
    packet of ``ceil(bytes / flit_bytes)`` flits injected at cycle 0.  With
    ``batched=True`` msgs carries a leading batch axis and the B message sets
    ride inside the same packets (``B * nbytes`` bytes each).

    The delivered cube is rebuilt on ``msgs``' device from the ejection
    record alone: one host index vector, one gather and one scatter.
    ``tracer`` records the switch's events, as in :func:`simulate_switch`."""
    cfg = cfg or SwitchConfig()
    fb = cfg.flit_bytes
    n = topo.n_nodes
    if msgs.dtype != torch.uint8:
        raise TypeError(f"the message cube holds bytes (torch.uint8), got {msgs.dtype}")
    B = msgs.shape[0] if batched else 1
    assert msgs.ndim == (4 if batched else 3) and tuple(msgs.shape[-3:-1]) == (n, n)
    buf = msgs.shape[-1]
    if pairs is None:
        pairs = [(s, d, buf) for s in range(n) for d in range(n)]
    pairs = [(s, d, nb) for s, d, nb in pairs if nb > 0]
    packets = [Packet(s, d, max(1, -(-(B * nb) // fb))) for s, d, nb in pairs]
    stats, _, _, tokens = _run_switch(topo, packets, cfg, False, True, tracer)
    delivered = torch.zeros(msgs.shape, dtype=torch.uint8, device=msgs.device)
    if packets:
        m = np.asarray(pairs, np.int64)
        pid, k, node = _token_bytes(tokens, fb, B * m[:, 2])
        b, j = np.divmod(k, m[pid, 2])            # (set, byte) of each carried byte
        plane = n * n * buf
        src_idx = b * plane + (m[pid, 0] * n + m[pid, 1]) * buf + j
        dst_idx = b * plane + (node * n + m[pid, 0]) * buf + j   # ejected at node
        idx = torch.as_tensor(np.stack([src_idx, dst_idx]), device=msgs.device)
        delivered.view(-1)[idx[1]] = msgs.contiguous().view(-1)[idx[0]]
    return delivered, stats
