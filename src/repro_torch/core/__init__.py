"""Core library of the port: the paper's framework on torch tensors.

graph      — phase-1 message-passing application model (PEs, channels)
topology   — CONNECT-analog virtual topologies (ring/mesh/torus/fat-tree)
routing    — round-by-round schedule simulator on a device message cube
serdes     — quasi-SERDES framing plan and wire accounting (analytic half)
partition  — phase-2 placement (round-robin, greedy, explicit)
noc        — the executor + flit accounting (Tables I–V analogs)
"""
from .graph import PE, Channel, GraphError, Port, TaskGraph, torch_dtype
from .noc import NoCConfig, NoCExecutor, NoCStats, wrapper_overhead
from .partition import place_greedy, place_round_robin, resolve_placement
from .routing import ScheduleStats, simulate_schedule
from .serdes import (LinkMeta, QuasiSerdesConfig, compression_ratio,
                     link_bytes_on_wire, link_wire_beats, plan)
from .topology import (AxisSchedule, FatTree, Mesh2D, Ring, Topology, Torus2D,
                       bwd_pairs, compare, fwd_pairs, make_topology)

__all__ = [n for n in dir() if not n.startswith("_")]
