"""Round-by-round schedule simulator on a device tensor (the simulator half of
``repro.core.routing``, lines 414-518 there).

The message cube is a device ``uint8`` tensor moved with ``torch.roll``, one
round at a time, so ``rounds`` and ``link_bytes`` count exactly what the
reference counts.  Each round's per-node copies are one indexed assignment.
"""
from __future__ import annotations

import torch

from .topology import FatTree, Mesh2D, Ring, Topology, Torus2D


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
