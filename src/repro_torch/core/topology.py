"""Virtual network topologies (CONNECT analog).

A copy of ``repro.core.topology`` (pure Python), kept in the port so that it
imports nothing of ``repro``.  The paper generates a packet-switched NoC of a
chosen topology (ring, mesh, torus, fat-tree — Table V) from CONNECT; here a
Topology compiles to a *static schedule* of neighbor exchanges, which
`core.routing.simulate_schedule` executes round by round on a device tensor,
plus an analytic cost model (rounds × bytes/round, hop counts).

Cost model conventions
----------------------
*Round*: one synchronous neighbor-exchange step; every node may send one
buffer over each of its links (bidirectional links = 2 concurrent transfers).
For an all-to-all of per-destination chunks of ``c`` bytes over ``n`` nodes:

  ring(n)      rounds = n - 1 (unidirectional rotation; chunks in transit
               shrink each round)                      link-bytes ≈ c·n(n−1)/2
  mesh(rx,ry)  factorized line-a2a per dim, bidirectional, no wraparound:
               rounds = (rx−1) + (ry−1)
  torus(rx,ry) factorized ring-a2a per dim, bidirectional wraparound:
               rounds = ⌈rx/2⌉ + ⌈ry/2⌉
  fat-tree     ideal full-bisection crossbar: 1 round (fused all_to_all)

This reproduces the paper's observed ordering ring < mesh < torus < fat-tree.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterable


# ---------------------------------------------------------------------------
# neighbor permutation tables — the (src, dst) pairs of one synchronous hop
# along a 1D axis.  These are the raw material of the schedule→ppermute
# compiler: every routing round is one of these permutations applied to a
# rotating buffer.
# ---------------------------------------------------------------------------

def fwd_pairs(n: int, wrap: bool) -> tuple[tuple[int, int], ...]:
    """One +1 hop: node s forwards its buffer to s+1 (wraparound optional)."""
    return tuple((s, (s + 1) % n) for s in range(n) if wrap or s + 1 < n)


def bwd_pairs(n: int, wrap: bool) -> tuple[tuple[int, int], ...]:
    """One -1 hop: node s forwards its buffer to s-1 (wraparound optional)."""
    return tuple((s, (s - 1) % n) for s in range(n) if wrap or s - 1 >= 0)


@dataclasses.dataclass(frozen=True)
class AxisSchedule:
    """Hop-decomposition spec of an all-to-all along one mesh axis.

    ``axis``   — name of the axis the exchange runs over;
    ``size``   — number of nodes along the axis;
    ``wrap``   — wraparound links exist (ring/torus dimension);
    ``unidir`` — rotate one direction only (the paper-faithful CONNECT ring
                 routers forward a single direction).
    """

    axis: str
    size: int
    wrap: bool
    unidir: bool = False

    @property
    def fwd_steps(self) -> int:
        if self.unidir:
            return self.size - 1
        return self.size // 2 if self.wrap else self.size - 1

    @property
    def bwd_steps(self) -> int:
        if self.unidir:
            return 0
        return (self.size - 1) // 2 if self.wrap else self.size - 1

    def fwd_pairs(self) -> tuple[tuple[int, int], ...]:
        return fwd_pairs(self.size, self.wrap)

    def bwd_pairs(self) -> tuple[tuple[int, int], ...]:
        return bwd_pairs(self.size, self.wrap)


@dataclasses.dataclass(frozen=True)
class Topology:
    """Base class; subclasses define connectivity and schedule cost."""

    n_nodes: int

    @property
    def name(self) -> str:
        return type(self).__name__.lower()

    # -- connectivity --------------------------------------------------------
    def neighbors(self, node: int) -> tuple[int, ...]:
        raise NotImplementedError

    def hops(self, src: int, dst: int) -> int:
        raise NotImplementedError

    def avg_hops(self) -> float:
        n = self.n_nodes
        tot = sum(self.hops(s, d) for s in range(n) for d in range(n) if s != d)
        return tot / (n * (n - 1))

    def bisection_links(self) -> int:
        raise NotImplementedError

    # -- schedule spec -------------------------------------------------------
    def axis_schedules(self) -> tuple[AxisSchedule, ...]:
        """Per-axis hop decomposition of this topology's all-to-all.

        Dimension-ordered (XY) routing: phases run in the returned order, one
        line/ring exchange per axis.  An empty tuple means the topology is an
        ideal crossbar (single fused exchange, no hop decomposition)."""
        raise NotImplementedError

    # -- schedule cost -------------------------------------------------------
    def a2a_rounds(self) -> int:
        """Neighbor-exchange rounds for a full all-to-all personalized exchange."""
        raise NotImplementedError

    def a2a_link_bytes(self, chunk_bytes: int) -> int:
        """Total bytes crossing links for an all-to-all of per-dest chunks."""
        n = self.n_nodes
        # sum over (src,dst) pairs of hops(src,dst) * chunk
        tot = sum(self.hops(s, d) for s in range(n) for d in range(n) if s != d)
        return tot * chunk_bytes

    def a2a_time_model(self, chunk_bytes: int, link_bw: float, hop_latency: float) -> float:
        """Simple alpha-beta model: rounds*latency + serialized link traffic."""
        links = max(1, self.n_links())
        return self.a2a_rounds() * hop_latency + self.a2a_link_bytes(chunk_bytes) / (links * link_bw)

    def n_links(self) -> int:
        return sum(len(self.neighbors(i)) for i in range(self.n_nodes)) // 2

    def validate(self) -> None:
        for i in range(self.n_nodes):
            for j in self.neighbors(i):
                assert i in self.neighbors(j), f"asymmetric link {i}->{j}"


@dataclasses.dataclass(frozen=True)
class Ring(Topology):
    def neighbors(self, node: int) -> tuple[int, ...]:
        n = self.n_nodes
        return ((node - 1) % n, (node + 1) % n)

    def hops(self, src: int, dst: int) -> int:
        n = self.n_nodes
        d = abs(src - dst)
        return min(d, n - d)

    def bisection_links(self) -> int:
        return 2

    def axis_schedules(self) -> tuple[AxisSchedule, ...]:
        return (AxisSchedule("noc", self.n_nodes, wrap=True, unidir=True),)

    def a2a_rounds(self) -> int:
        # unidirectional systolic rotation (paper-faithful: CONNECT ring routers
        # forward one direction); n-1 rounds.
        return self.n_nodes - 1


def _factor2d(n: int) -> tuple[int, int]:
    rx = int(math.sqrt(n))
    while n % rx:
        rx -= 1
    return rx, n // rx


@dataclasses.dataclass(frozen=True)
class Mesh2D(Topology):
    rx: int = 0
    ry: int = 0

    def __post_init__(self):
        if self.rx == 0:
            rx, ry = _factor2d(self.n_nodes)
            object.__setattr__(self, "rx", rx)
            object.__setattr__(self, "ry", ry)
        assert self.rx * self.ry == self.n_nodes

    def coords(self, node: int) -> tuple[int, int]:
        return node % self.rx, node // self.rx

    def node(self, x: int, y: int) -> int:
        return y * self.rx + x

    def neighbors(self, node: int) -> tuple[int, ...]:
        x, y = self.coords(node)
        out = []
        if x > 0:
            out.append(self.node(x - 1, y))
        if x < self.rx - 1:
            out.append(self.node(x + 1, y))
        if y > 0:
            out.append(self.node(x, y - 1))
        if y < self.ry - 1:
            out.append(self.node(x, y + 1))
        return tuple(out)

    def hops(self, src: int, dst: int) -> int:
        sx, sy = self.coords(src)
        dx, dy = self.coords(dst)
        return abs(sx - dx) + abs(sy - dy)

    def bisection_links(self) -> int:
        return min(self.rx, self.ry)

    def axis_schedules(self) -> tuple[AxisSchedule, ...]:
        # XY dimension-ordered routing: phase X first, then Y
        wrap = isinstance(self, Torus2D)
        return (AxisSchedule("noc_x", self.rx, wrap=wrap),
                AxisSchedule("noc_y", self.ry, wrap=wrap))

    def a2a_rounds(self) -> int:
        # dimension-ordered, bidirectional line exchange per dim
        return (self.rx - 1) + (self.ry - 1)


@dataclasses.dataclass(frozen=True)
class Torus2D(Mesh2D):
    def neighbors(self, node: int) -> tuple[int, ...]:
        x, y = self.coords(node)
        return tuple(
            {
                self.node((x - 1) % self.rx, y),
                self.node((x + 1) % self.rx, y),
                self.node(x, (y - 1) % self.ry),
                self.node(x, (y + 1) % self.ry),
            }
            - {node}
        )

    def hops(self, src: int, dst: int) -> int:
        sx, sy = self.coords(src)
        dx, dy = self.coords(dst)
        hx = min(abs(sx - dx), self.rx - abs(sx - dx))
        hy = min(abs(sy - dy), self.ry - abs(sy - dy))
        return hx + hy

    def bisection_links(self) -> int:
        return 2 * min(self.rx, self.ry)

    def a2a_rounds(self) -> int:
        return math.ceil(self.rx / 2) + math.ceil(self.ry / 2)


@dataclasses.dataclass(frozen=True)
class FatTree(Topology):
    """Modeled as an ideal full-bisection crossbar (CONNECT's fat tree at the
    radix used in the paper); one fused exchange."""

    def neighbors(self, node: int) -> tuple[int, ...]:
        return tuple(i for i in range(self.n_nodes) if i != node)

    def hops(self, src: int, dst: int) -> int:
        return 1 if src != dst else 0

    def bisection_links(self) -> int:
        return self.n_nodes // 2

    def n_links(self) -> int:
        # full-bisection: n/2 concurrent disjoint paths
        return self.n_nodes // 2

    def axis_schedules(self) -> tuple[AxisSchedule, ...]:
        return ()   # ideal crossbar: one fused exchange, no hop decomposition

    def a2a_rounds(self) -> int:
        return 1


TOPOLOGIES = {"ring": Ring, "mesh": Mesh2D, "torus": Torus2D, "fattree": FatTree,
              # class-name aliases (MoE configs use the explicit 2D names)
              "mesh2d": Mesh2D, "torus2d": Torus2D}


def make_topology(name: str, n_nodes: int) -> Topology:
    try:
        return TOPOLOGIES[name](n_nodes)
    except KeyError:
        raise ValueError(f"unknown topology {name!r}; choose from {sorted(TOPOLOGIES)}")


def compare(n_nodes: int, chunk_bytes: int, names: Iterable[str] = ("ring", "mesh", "torus", "fattree"),
            link_bw: float = 50e9, hop_latency: float = 1e-6) -> list[dict]:
    """Table-V-style analytic comparison."""
    rows = []
    for name in names:
        t = make_topology(name, n_nodes)
        rows.append(
            dict(
                topology=name,
                nodes=n_nodes,
                rounds=t.a2a_rounds(),
                links=t.n_links(),
                avg_hops=round(t.avg_hops(), 3),
                bisection_links=t.bisection_links(),
                a2a_link_bytes=t.a2a_link_bytes(chunk_bytes),
                model_time_us=round(t.a2a_time_model(chunk_bytes, link_bw, hop_latency) * 1e6, 3),
            )
        )
    return rows
