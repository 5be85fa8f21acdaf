"""Routing schedules on a device tensor: the round-by-round schedule simulator
and the compiled route programs of ``repro.core.routing``.

The message cube is a device tensor moved one round at a time, so ``rounds``
and ``link_bytes`` count exactly what the reference counts.

* :func:`simulate_schedule` — the handwritten schedules, moved with
  ``torch.roll``; each round's per-node copies are one indexed assignment.
* :func:`compile_routes` — a topology's all-to-all as an explicit,
  value-independent :class:`RouteProgram`: per-axis phases (dimension-ordered
  XY routing) of rounds of single-hop neighbour permutations.
* :func:`simulate_route_program` — the program executed round by round, one
  indexed copy per hop move (bit-identical to :func:`simulate_schedule`).
* :func:`route_program_stats` — analytic rounds and link bytes, matching the
  round-by-round execution exactly.

``run_route_program`` (the device-mesh lowering) belongs to the device-mesh
slice (ROADMAP Queue 1 item 7).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import torch

from .topology import AxisSchedule, FatTree, Mesh2D, Ring, Topology, Torus2D


class ScheduleStats:
    def __init__(self):
        self.rounds = 0
        self.link_bytes = 0

    def __repr__(self):
        return f"ScheduleStats(rounds={self.rounds}, link_bytes={self.link_bytes})"


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _deliver(out: torch.Tensor, buf: torch.Tensor, shift: int, wrap: bool) -> None:
    """Every node i keeps what arrived from ``src = i - shift`` this round:
    ``out[i, src] = buf[i, i]`` for all i with a valid src, in one assignment."""
    n = buf.shape[0]
    dst = torch.arange(n, device=buf.device)
    src = dst - shift
    if wrap:
        src = src % n
    else:
        keep = (src >= 0) & (src < n)
        dst, src = dst[keep], src[keep]
    out[dst, src] = buf[dst, dst]


def _sim_line(buf: torch.Tensor, wrap: bool, stats: ScheduleStats) -> torch.Tensor:
    """buf: (n_nodes, n_dst_axis, *c) per-node buffers; returns (n, n_src, *c).

    Executes the forward/backward rotation schedule round by round, physically
    moving buffers."""
    n = buf.shape[0]
    out = torch.zeros_like(buf)
    diag = torch.arange(n, device=buf.device)
    out[diag, diag] = buf[diag, diag]
    if n == 1:
        return out
    fwd_steps = n // 2 if wrap else n - 1
    bwd_steps = (n - 1) // 2 if wrap else n - 1
    fbuf, bbuf = buf, buf
    nbytes = _nbytes(buf)
    for t in range(1, max(fwd_steps, bwd_steps) + 1):
        stats.rounds += 1
        if t <= fwd_steps:
            fbuf = torch.roll(fbuf, 1, dims=0)
            if not wrap:
                fbuf[0] = 0
            stats.link_bytes += nbytes - (nbytes // n if not wrap else 0)
            _deliver(out, fbuf, t, wrap)
        if t <= bwd_steps:
            bbuf = torch.roll(bbuf, -1, dims=0)
            if not wrap:
                bbuf[-1] = 0
            stats.link_bytes += nbytes - (nbytes // n if not wrap else 0)
            _deliver(out, bbuf, -t, wrap)
    return out


def _sim_ring_unidir(buf: torch.Tensor, stats: ScheduleStats) -> torch.Tensor:
    n = buf.shape[0]
    out = torch.zeros_like(buf)
    diag = torch.arange(n, device=buf.device)
    out[diag, diag] = buf[diag, diag]
    fbuf = buf
    nbytes = _nbytes(buf)
    for t in range(1, n):
        stats.rounds += 1
        fbuf = torch.roll(fbuf, 1, dims=0)
        stats.link_bytes += nbytes
        _deliver(out, fbuf, t, wrap=True)
    return out


def simulate_schedule(topo: Topology, msgs: torch.Tensor, *,
                      batched: bool = False) -> tuple[torch.Tensor, ScheduleStats]:
    """msgs: (n_src, n_dst, *c).  Returns (delivered (n_dst, n_src, *c), stats).

    Semantics oracle: delivered == msgs.transpose(0, 1).

    With ``batched=True`` msgs carries a leading batch axis ``(B, n, n, *c)``
    and B independent message sets move through the topology in ONE
    round-by-round simulation (rounds are counted once, link_bytes scale with
    B).  Returns ``(B, n, n, *c)`` delivered, i.e. ``msgs.transpose(1, 2)``."""
    if batched:
        if msgs.ndim < 3:
            raise ValueError("batched msgs must be (B, n_src, n_dst, *c)")
        inner = torch.movedim(msgs, 0, 2).contiguous()           # (n, n, B, *c)
        delivered, stats = simulate_schedule(topo, inner)
        return torch.movedim(delivered, 2, 0).contiguous(), stats
    n = topo.n_nodes
    if msgs.shape[0] != n or msgs.shape[1] != n:
        raise ValueError(f"msgs {tuple(msgs.shape)} is not (n, n, ...) for n={n}")
    stats = ScheduleStats()
    if isinstance(topo, FatTree):
        stats.rounds = 1
        stats.link_bytes = int(_nbytes(msgs) * (n - 1) / n)
        return msgs.transpose(0, 1).contiguous(), stats
    if isinstance(topo, Ring):
        return _sim_ring_unidir(msgs, stats), stats
    if isinstance(topo, (Torus2D, Mesh2D)):
        wrap = isinstance(topo, Torus2D)
        rx, ry = topo.rx, topo.ry
        c = tuple(msgs.shape[2:])
        # node linear index = y*rx + x; XY dimension-ordered routing.
        m = msgs.reshape(ry, rx, ry, rx, *c)                     # [sy, sx, dy, dx, *c]
        # Phase X: every row runs the line schedule concurrently — all
        # non-(sx,dx) indices ride along as payload, so one _sim_line call is
        # one parallel phase (stats counted once, bytes include all rows).
        b = torch.movedim(m, (1, 3), (0, 1))                     # [sx, dx, sy, dy, *c]
        b = _sim_line(b.contiguous().reshape(rx, rx, -1), wrap, stats)
        b = b.reshape(rx, rx, ry, ry, *c)                        # [dx(node), sx, sy, dy, *c]
        # Phase Y: every column concurrently, keyed by dy.
        b = torch.movedim(b, (2, 3), (0, 1))                     # [sy, dy, dx, sx, *c]
        b = _sim_line(b.contiguous().reshape(ry, ry, -1), wrap, stats)
        b = b.reshape(ry, ry, rx, rx, *c)                        # [dy(node), sy, dx, sx, *c]
        out = torch.movedim(b, (0, 2, 1, 3), (0, 1, 2, 3))       # [dy, dx, sy, sx, *c]
        return out.contiguous().reshape(n, n, *c), stats
    raise TypeError(f"no simulator for {type(topo).__name__}")


# ---------------------------------------------------------------------------
# schedule → permutation-round compiler (hop decomposition)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HopMove:
    """One single-hop buffer rotation inside a round.

    ``buf``       — which rotating buffer moves (0 = forward, 1 = backward);
    ``perm``      — the neighbour (src, dst) pairs of the hop;
    ``src_table`` — per node ``i`` along the axis: the source node whose
                    message addressed to ``i`` arrives with this hop
                    (-1: nothing to commit at ``i``).
    """

    buf: int
    perm: tuple[tuple[int, int], ...]
    src_table: tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class PermuteRound:
    """One synchronous NoC round: every node sends one buffer per link
    direction concurrently (1 move for unidirectional, 2 for bidirectional)."""

    moves: tuple[HopMove, ...]


@dataclasses.dataclass(frozen=True)
class LinePhase:
    """Hop-decomposed all-to-all along one mesh axis."""

    sched: AxisSchedule
    rounds: tuple[PermuteRound, ...]


@dataclasses.dataclass(frozen=True)
class RouteProgram:
    """Compiled routing schedule of a topology's all-to-all exchange."""

    topo_name: str
    n_nodes: int
    axes: tuple[tuple[str, int], ...]    # device-mesh axes (= topology_axes)
    phases: tuple[LinePhase, ...]        # empty → fused crossbar all_to_all

    @property
    def fused(self) -> bool:
        return not self.phases

    @property
    def n_rounds(self) -> int:
        return 1 if self.fused else sum(len(p.rounds) for p in self.phases)


def _compile_line_phase(sched: AxisSchedule) -> LinePhase:
    n = sched.size
    rounds = []
    for t in range(1, max(sched.fwd_steps, sched.bwd_steps) + 1):
        moves = []
        if t <= sched.fwd_steps:
            src = tuple((i - t) % n if sched.wrap else (i - t if i - t >= 0 else -1)
                        for i in range(n))
            moves.append(HopMove(0, sched.fwd_pairs(), src))
        if t <= sched.bwd_steps:
            src = tuple((i + t) % n if sched.wrap else (i + t if i + t < n else -1)
                        for i in range(n))
            moves.append(HopMove(1, sched.bwd_pairs(), src))
        rounds.append(PermuteRound(tuple(moves)))
    return LinePhase(sched, tuple(rounds))


def compile_routes(topo: Topology) -> RouteProgram:
    """Compile a topology's all-to-all into an explicit permutation-round program."""
    phases = tuple(_compile_line_phase(s) for s in topo.axis_schedules())
    return RouteProgram(topo.name, topo.n_nodes, topology_axes(topo), phases)


def topology_axes(topo: Topology) -> tuple[tuple[str, int], ...]:
    """Mesh axes a topology's schedule runs over (``noc`` for ring/fat-tree,
    ``(noc_y, noc_x)`` for mesh/torus)."""
    if isinstance(topo, (Torus2D, Mesh2D)):
        return (("noc_y", topo.ry), ("noc_x", topo.rx))
    return (("noc", topo.n_nodes),)


@functools.lru_cache(maxsize=4096)
def _index(xs: tuple[int, ...], device: torch.device) -> torch.Tensor:
    """A static index list of a compiled program as a device tensor, made
    once per list and device: the copy from host memory synchronizes the
    card, so a repeated run makes none.  Callers only read it."""
    return torch.tensor(xs, dtype=torch.int64, device=device)


def _line_compiled(buf: torch.Tensor, phase: LinePhase, stats: "ScheduleStats",
                   on_move: Optional[Callable[[HopMove, torch.Tensor], torch.Tensor]] = None,
                   on_round: Optional[Callable[[], None]] = None) -> torch.Tensor:
    """Execute one compiled line phase round by round.  ``buf`` is
    (m, m, *c): holder along the axis, destination along the axis, payload;
    returns (m, m_src, *c).  Each hop move is one indexed copy of the moving
    buffer's rows (``nxt[dst] = cur[src]``) and one indexed commit of what
    reached its destination.

    ``on_move(mv, nxt)`` may replace a move's arrived buffer (the bridged
    simulator serializes the pod-crossing rows there) and ``on_round()``
    closes each round."""
    m = phase.sched.size
    dev = buf.device
    out = torch.zeros_like(buf)
    diag = torch.arange(m, device=dev)
    out[diag, diag] = buf[diag, diag]
    row_bytes = _nbytes(buf) // m
    bufs = [buf, buf]
    for rnd in phase.rounds:
        stats.rounds += 1
        for mv in rnd.moves:
            nxt = torch.zeros_like(buf)
            nxt[_index(tuple(d for _, d in mv.perm), dev)] = \
                bufs[mv.buf][_index(tuple(s for s, _ in mv.perm), dev)]
            stats.link_bytes += row_bytes * len(mv.perm)
            if on_move is not None:
                nxt = on_move(mv, nxt)
            bufs[mv.buf] = nxt
            keep = tuple(i for i in range(m) if mv.src_table[i] >= 0)
            ki = _index(keep, dev)
            out[ki, _index(tuple(mv.src_table[i] for i in keep), dev)] = nxt[ki, ki]
        if on_round is not None:
            on_round()
    return out


def simulate_route_program(prog: RouteProgram,
                           msgs: torch.Tensor) -> tuple[torch.Tensor, "ScheduleStats"]:
    """Round-by-round execution of a compiled program on ``msgs``' device.

    msgs: (n_src, n_dst, *c); returns (delivered (n_dst, n_src, *c), stats).
    Bit-identical to :func:`simulate_schedule` on the same topology."""
    n = prog.n_nodes
    if msgs.shape[0] != n or msgs.shape[1] != n:
        raise ValueError(f"msgs {tuple(msgs.shape)} is not (n, n, ...) for n={n}")
    stats = ScheduleStats()
    if prog.fused:
        return msgs.transpose(0, 1).contiguous(), route_program_stats(prog, _nbytes(msgs))
    if len(prog.phases) == 1:
        return _line_compiled(msgs, prog.phases[0], stats), stats
    (_, ry), (_, rx) = prog.axes
    phase_x, phase_y = prog.phases
    c = tuple(msgs.shape[2:])
    m = msgs.reshape(ry, rx, ry, rx, *c)                     # [sy, sx, dy, dx, *c]
    b = torch.movedim(m, (1, 3), (0, 1))                     # [sx, dx, sy, dy, *c]
    b = _line_compiled(b.contiguous().reshape(rx, rx, -1), phase_x, stats)
    b = b.reshape(rx, rx, ry, ry, *c)                        # [dx(node), sx, sy, dy, *c]
    b = torch.movedim(b, (2, 3), (0, 1))                     # [sy, dy, dx, sx, *c]
    b = _line_compiled(b.contiguous().reshape(ry, ry, -1), phase_y, stats)
    b = b.reshape(ry, ry, rx, rx, *c)                        # [dy(node), sy, dx, sx, *c]
    out = torch.movedim(b, (0, 2, 1, 3), (0, 1, 2, 3))
    return out.contiguous().reshape(n, n, *c), stats


def route_program_stats(prog: RouteProgram, cube_nbytes: int) -> ScheduleStats:
    """Analytic ScheduleStats for moving one (n, n, ...) message cube of
    ``cube_nbytes`` total bytes through a compiled program — exactly what
    :func:`simulate_schedule` and :func:`simulate_route_program` count."""
    stats = ScheduleStats()
    n = prog.n_nodes
    if prog.fused:
        stats.rounds = 1
        stats.link_bytes = int(cube_nbytes * (n - 1) / n)
        return stats
    for phase in prog.phases:
        per_row = cube_nbytes // phase.sched.size
        for rnd in phase.rounds:
            stats.rounds += 1
            for mv in rnd.moves:
                stats.link_bytes += per_row * len(mv.perm)
    return stats
