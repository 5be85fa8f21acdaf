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

Device-mesh execution (`core.collectives`): each rank holds its NoC node's
``(n, *chunk)`` destination-indexed row and gets back the ``(n, *chunk)``
source-indexed row it received — the transpose (:func:`transpose_oracle`).

* the handwritten schedules :func:`ring_all_to_all_unidir`,
  :func:`line_all_to_all`, :func:`grid_all_to_all` and
  :func:`crossbar_all_to_all`, picked per topology by :func:`all_to_all_for`;
* :func:`run_route_program` — a compiled program, one `collectives.ppermute`
  per hop move, over the program's own mesh axes or *linearized* over one
  flat axis (``axis_name``), with a replaceable hop transport
  (``transfer=``, the bridged lowering of `core.interchip`).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import torch

from .collectives import MeshAxis, NoCMesh, all_to_all, ppermute
from .topology import (AxisSchedule, FatTree, Mesh2D, Ring, Topology, Torus2D, bwd_pairs,
                       fwd_pairs)


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


# ---------------------------------------------------------------------------
# device-mesh execution (one rank's view: its node's (n, *chunk) row)
# ---------------------------------------------------------------------------

def transpose_oracle(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """Reference semantics: the fused all_to_all (what the schedules equal)."""
    return all_to_all(x, axis)


def ring_all_to_all_unidir(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """Paper-faithful unidirectional ring rotation: n-1 rounds."""
    n, i = axis.size, axis.coord
    out = torch.zeros_like(x)
    out[i] = x[i]
    buf = x
    for t in range(1, n):
        buf = ppermute(buf, axis, fwd_pairs(n, True))
        # after t forward rotations this node holds node (i-t)'s buffer
        out[(i - t) % n] = buf[i]
    return out


def line_all_to_all(x: torch.Tensor, axis: MeshAxis, wrap: bool) -> torch.Tensor:
    """Bidirectional 1D exchange.  wrap=True → torus ring (both directions
    concurrently); wrap=False → mesh line (n-1 rounds)."""
    n, i = axis.size, axis.coord
    out = torch.zeros_like(x)
    out[i] = x[i]
    if n == 1:
        return out
    fwd_steps = n // 2 if wrap else n - 1
    bwd_steps = (n - 1) // 2 if wrap else n - 1
    fbuf, bbuf = x, x
    for t in range(1, max(fwd_steps, bwd_steps) + 1):
        if t <= fwd_steps:
            fbuf = ppermute(fbuf, axis, fwd_pairs(n, wrap))
            src = (i - t) % n if wrap else i - t
            if wrap or src >= 0:
                out[src] = fbuf[i]
        if t <= bwd_steps:
            bbuf = ppermute(bbuf, axis, bwd_pairs(n, wrap))
            src = (i + t) % n if wrap else i + t
            if wrap or src < n:
                out[src] = bbuf[i]
    return out


def grid_all_to_all(x: torch.Tensor, axis_x: MeshAxis, axis_y: MeshAxis,
                    wrap: bool) -> torch.Tensor:
    """Factorized 2D exchange (dimension-ordered XY routing): destination
    linear index d = dy*rx + dx in, source linear index out."""
    rx, ry = axis_x.size, axis_y.size
    c = tuple(x.shape[1:])
    b = torch.movedim(x.reshape(ry, rx, *c), 1, 0)        # (dx, dy, *c)
    b = line_all_to_all(b, axis_x, wrap)                    # (sx, dy, *c)
    b = line_all_to_all(torch.movedim(b, 1, 0), axis_y, wrap)   # (sy, sx, *c)
    return b.reshape(ry * rx, *c)


def crossbar_all_to_all(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """Fat-tree / ideal crossbar: one fused all_to_all."""
    return all_to_all(x, axis)


def all_to_all_for(topo: Topology, mesh: NoCMesh) -> Callable[[torch.Tensor], torch.Tensor]:
    """``fn(x)``: the topology's handwritten schedule over ``mesh``, whose
    axes are ``topology_axes(topo)`` (the axes are looked up once, here)."""
    if isinstance(topo, Ring):
        ax = mesh.axis("noc")
        return lambda x: ring_all_to_all_unidir(x, ax)
    if isinstance(topo, Mesh2D):        # Torus2D is a Mesh2D: wrap tells them apart
        ax_x, ax_y = mesh.axis("noc_x"), mesh.axis("noc_y")
        wrap = isinstance(topo, Torus2D)
        return lambda x: grid_all_to_all(x, ax_x, ax_y, wrap)
    if isinstance(topo, FatTree):
        ax = mesh.axis("noc")
        return lambda x: crossbar_all_to_all(x, ax)
    raise TypeError(f"no schedule for {type(topo).__name__}")


def _line_exchange_compiled(x: torch.Tensor, phase: LinePhase, axis: MeshAxis,
                            coord: Optional[int] = None,
                            expand: Optional[Callable] = None,
                            transfer: Optional[Callable] = None) -> torch.Tensor:
    """Execute one compiled line phase on this rank's row: ``x`` is
    (m, *chunk) destination-indexed along the phase axis, returns
    source-indexed.

    By default the phase runs over ``axis``, the phase's own mesh axis.
    Linearized, ``axis`` is a flat axis that embeds the phase axis: ``coord``
    is this rank's position along the phase axis and ``expand`` maps the
    phase's per-axis (src, dst) hop pairs to flat-axis pairs (every row or
    column at once).  ``transfer(buf, pairs)`` replaces the hop transport (by
    default one `collectives.ppermute`); it gets the expanded pairs, global
    node ids when linearized."""
    i = axis.coord if coord is None else coord
    out = torch.zeros_like(x)
    out[i] = x[i]
    bufs = [x, x]
    for rnd in phase.rounds:
        for mv in rnd.moves:
            perm = expand(mv.perm) if expand is not None else mv.perm
            bufs[mv.buf] = (ppermute(bufs[mv.buf], axis, perm) if transfer is None
                            else transfer(bufs[mv.buf], perm))
            src = mv.src_table[i]
            if src >= 0:
                out[src] = bufs[mv.buf][i]
    return out


def run_route_program(x: torch.Tensor, prog: RouteProgram, mesh: Optional[NoCMesh],
                      axis_name=None, transfer: Optional[Callable] = None) -> torch.Tensor:
    """Execute a compiled RouteProgram on this rank's row of the cube.

    Same contract as the handwritten schedules: ``x`` is this node's
    ``(n, *chunk)`` destination-indexed row; returns the source-indexed row
    it received (== :func:`transpose_oracle`).

    With ``axis_name=None`` the program runs over its own axes of ``mesh``
    (``prog.axes``, the NoC executor's ``mode="spmd"``).  With an
    ``axis_name`` (a mesh axis name, or a tuple of names linearized) the same
    program runs linearized over that one flat axis of size ``prog.n_nodes``
    (node linear id ``y*rx + x`` for 2D topologies): each per-axis hop
    permutation is expanded to the full axis so every row/column exchanges
    at once, exactly one transfer per hop move.

    ``transfer`` (see :func:`_line_exchange_compiled`) swaps the hop transport
    and requires ``axis_name``, so that its pairs are global node ids."""
    if transfer is not None and axis_name is None:
        raise ValueError("transfer= requires linearized execution (axis_name)")
    if prog.fused:
        if transfer is not None:
            # a fused crossbar has no hop moves to re-transport; ignoring the
            # hook would run cut links un-bridged
            raise ValueError("transfer= is not supported for fused programs; use "
                             "interchip.run_bridged_program, which handles the "
                             "crossbar case itself")
        return all_to_all(x, mesh.axis(axis_name or prog.axes[0][0]))
    if len(prog.phases) == 1:
        phase = prog.phases[0]
        return _line_exchange_compiled(x, phase, mesh.axis(axis_name or phase.sched.axis),
                                       transfer=transfer)
    # 2D XY routing: the factorized data motion of grid_all_to_all
    (_, ry), (_, rx) = prog.axes          # axes = (noc_y, noc_x)
    phase_x, phase_y = prog.phases        # phases ordered X then Y
    if axis_name is None:
        ax_x, ax_y = mesh.axis(phase_x.sched.axis), mesh.axis(phase_y.sched.axis)
        cx = cy = ex_x = ex_y = None
    else:
        ax_x = ax_y = mesh.axis(axis_name)
        cx, cy = ax_x.coord % rx, ax_x.coord // rx

        def ex_x(pairs):
            return [(y * rx + s, y * rx + d) for y in range(ry) for s, d in pairs]

        def ex_y(pairs):
            return [(s * rx + xc, d * rx + xc) for xc in range(rx) for s, d in pairs]
    c = tuple(x.shape[1:])
    b = torch.movedim(x.reshape(ry, rx, *c), 1, 0)                 # (dx, dy, *c)
    b = _line_exchange_compiled(b, phase_x, ax_x, cx, ex_x, transfer)   # (sx, dy, *c)
    b = _line_exchange_compiled(torch.movedim(b, 1, 0), phase_y, ax_y, cy, ex_y,
                                transfer)                          # (sy, sx, *c)
    return b.reshape(ry * rx, *c)
