"""Core library of the port: the paper's framework on torch tensors.

graph      — phase-1 message-passing application model (PEs, channels)
topology   — CONNECT-analog virtual topologies (ring/mesh/torus/fat-tree)
routing    — schedule simulator and compiled route programs on a device cube
serdes     — quasi-SERDES cut-link endpoints (framing, compression, accounting)
partition  — phase-2 placement (rr, greedy, annealing search) and pod cutting
interchip  — bridge subsystem: compiled route programs across pod cuts
switch     — buffered wormhole switching: FIFOs, arbitration, backpressure
traffic    — synthetic traffic patterns (uniform/hotspot/transpose/bursty)
noc        — the executor + flit accounting (Tables I–V analogs)
"""
from .graph import PE, Channel, GraphError, Port, TaskGraph, torch_dtype
from .interchip import (BridgeConfig, BridgedProgram, BridgeLink, BridgeStats,
                        PodProgram, bridge_program_stats, compile_bridges,
                        simulate_bridged_program)
from .noc import NoCConfig, NoCExecutor, NoCStats, wrapper_overhead
from .partition import (PartitionPlan, candidate_cuts, cut, optimize_placement,
                        optimize_pod_cut, pair_cut_weights, place_greedy,
                        place_round_robin, placement_cost, resolve_placement)
from .routing import (RouteProgram, ScheduleStats, compile_routes, route_program_stats,
                      simulate_route_program, simulate_schedule, topology_axes)
from .serdes import (LinkMeta, QuasiSerdesConfig, compression_ratio, decode, encode,
                     link_bytes_on_wire, link_wire_beats, plan)
from .switch import (DeadlockError, Packet, SwitchConfig, SwitchResult, SwitchStats,
                     dor_route, link_loads, saturation_rate, simulate_switch,
                     simulate_wormhole_cube, switch_lower_bound)
from .traffic import TrafficConfig, generate_traffic, traffic_matrix, transpose_partner
from .topology import (AxisSchedule, FatTree, Mesh2D, Ring, Topology, Torus2D,
                       bwd_pairs, compare, fwd_pairs, make_topology)

__all__ = [n for n in dir() if not n.startswith("_")]
