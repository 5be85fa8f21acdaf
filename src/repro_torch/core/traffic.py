"""Synthetic traffic patterns for the buffered wormhole switch (port of
``repro.core.traffic``).

Standard NoC evaluation workloads (Dally & Towles ch. 25 vocabulary), used by
the ``table9_congestion`` benchmark and the property suite:

* ``uniform``   — each packet picks a destination uniformly among the other
                  nodes (the classic baseline; stresses bisection links);
* ``hotspot``   — a fraction ``hotspot_frac`` of packets target one node,
                  the rest uniform (stresses one ejection port / subtree —
                  the MoE "popular expert" regime);
* ``transpose`` — fixed permutation partner per node (matrix-transpose
                  ``(x, y) -> (y, x)`` on square 2D fabrics, bit-reversal
                  analog ``n-1-i`` elsewhere; adversarial for X-Y
                  dimension-ordered routing);
* ``bursty``    — destinations uniform but injection clumps into back-to-back
                  bursts of ``burst_len`` packets with exponential (Poisson
                  process) gaps between bursts, same long-run offered rate.

Injection times model a Poisson-ish open-loop source: per node, inter-packet
gaps are exponential with mean ``packet_flits / injection_rate`` cycles, so
the offered load is ``injection_rate`` flits/cycle/node — directly comparable
to :func:`core.switch.saturation_rate`.
Packets are host data, drawn from ``np.random.default_rng(cfg.seed)`` exactly
as the reference draws them, so the packet lists equal its lists.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .switch import Packet
from .topology import Mesh2D, Topology

PATTERNS = ("uniform", "hotspot", "transpose", "bursty")


@dataclasses.dataclass(frozen=True)
class TrafficConfig:
    pattern: str = "uniform"
    injection_rate: float = 0.1   # offered load, flits/cycle/node
    packet_flits: int = 4
    n_packets: int = 64           # packets per source node
    hotspot: int = 0              # hotspot destination node
    hotspot_frac: float = 0.5     # fraction of traffic aimed at the hotspot
    burst_len: int = 4            # packets per burst (bursty pattern)
    seed: int = 0

    def __post_init__(self):
        if self.pattern not in PATTERNS:
            raise ValueError(f"unknown pattern {self.pattern!r}; "
                             f"expected one of {PATTERNS}")
        if not 0.0 < self.injection_rate:
            raise ValueError("injection_rate must be positive")
        if not 0.0 <= self.hotspot_frac <= 1.0:
            raise ValueError(f"hotspot_frac={self.hotspot_frac} must be "
                             f"in [0, 1]")
        if self.packet_flits < 1:
            raise ValueError("packet_flits must be >= 1")
        if self.burst_len < 1:
            raise ValueError("burst_len must be >= 1")
        if self.n_packets < 0:
            raise ValueError("n_packets must be >= 0")


def transpose_partner(topo: Topology, node: int) -> int:
    """Fixed permutation partner: ``(x, y) -> (y, x)`` on square 2D fabrics,
    index reversal otherwise; self-partners redirect to the next node so the
    pattern always exercises the network."""
    if isinstance(topo, Mesh2D) and topo.rx == topo.ry:
        x, y = topo.coords(node)
        p = topo.node(y, x)
    else:
        p = topo.n_nodes - 1 - node
    if p == node:
        p = (node + 1) % topo.n_nodes
    return p


def traffic_matrix(topo: Topology, cfg: TrafficConfig) -> np.ndarray:
    """Destination distribution ``matrix[s, d]`` (rows sum to 1) for
    ``cfg.pattern`` — the input :func:`core.switch.saturation_rate`
    expects.  ``bursty`` shares uniform's spatial distribution; only its
    injection-time process differs."""
    n = topo.n_nodes
    if n < 2:       # no destination exists; there is no traffic to describe
        return np.zeros((n, n))
    uni = np.full((n, n), 1.0 / (n - 1))
    np.fill_diagonal(uni, 0.0)
    if cfg.pattern in ("uniform", "bursty"):
        return uni
    if cfg.pattern == "hotspot":
        m = (1.0 - cfg.hotspot_frac) * uni
        hot = np.full(n, cfg.hotspot_frac)
        hot[cfg.hotspot] = 0.0
        m[:, cfg.hotspot] += hot
        # renormalize rows (the hotspot's own row lost its hotspot share);
        # at hotspot_frac=1.0 that row is all-zero — it sends uniformly
        # rather than dividing by zero
        sums = m.sum(axis=1, keepdims=True)
        m = np.where(sums > 0.0, m / np.where(sums > 0.0, sums, 1.0), uni)
        return m
    if cfg.pattern == "transpose":
        m = np.zeros((n, n))
        for s in range(n):
            m[s, transpose_partner(topo, s)] = 1.0
        return m
    raise AssertionError(cfg.pattern)


def generate_traffic(topo: Topology, cfg: TrafficConfig) -> list[Packet]:
    """Draw a concrete packet workload: ``cfg.n_packets`` packets per source
    with pattern-distributed destinations and rate-controlled injection
    times.  Deterministic in ``cfg.seed``."""
    n = topo.n_nodes
    if n < 2:       # single-node fabric: nothing can be sent anywhere
        return []
    rng = np.random.default_rng(cfg.seed)
    gap_mean = cfg.packet_flits / cfg.injection_rate
    packets: list[Packet] = []
    for s in range(n):
        if cfg.pattern == "bursty":
            # bursts of burst_len back-to-back packets, exponential gaps
            # between bursts scaled to keep the long-run rate
            t = 0.0
            k = 0
            while k < cfg.n_packets:
                for _ in range(min(cfg.burst_len, cfg.n_packets - k)):
                    packets.append(self_pkt(topo, cfg, rng, s, int(t)))
                    k += 1
                t += rng.exponential(cfg.burst_len * gap_mean)
        else:
            t = 0.0
            for _ in range(cfg.n_packets):
                packets.append(self_pkt(topo, cfg, rng, s, int(t)))
                t += rng.exponential(gap_mean)
    return packets


def self_pkt(topo: Topology, cfg: TrafficConfig, rng: np.random.Generator,
             src: int, t: int) -> Packet:
    """Draw one packet from ``src`` at time ``t`` per the pattern."""
    n = topo.n_nodes
    if cfg.pattern == "transpose":
        dst = transpose_partner(topo, src)
    elif (cfg.pattern == "hotspot" and src != cfg.hotspot
          and rng.random() < cfg.hotspot_frac):
        dst = cfg.hotspot
    else:
        dst = int(rng.integers(n - 1))
        if dst >= src:
            dst += 1
    return Packet(src, dst, cfg.packet_flits, t_inject=t)
