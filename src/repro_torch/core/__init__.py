"""Core library of the port: the paper's framework on torch tensors.

graph      — phase-1 message-passing application model (PEs, channels)
topology   — CONNECT-analog virtual topologies (ring/mesh/torus/fat-tree)
routing    — schedule simulator, compiled route programs, and both on a device mesh
collectives — ppermute / all_to_all / gathers over torch.distributed (the mesh)
serdes     — quasi-SERDES cut-link endpoints (framing, compression, link transfer)
partition  — phase-2 placement (rr, greedy, annealing search), mesh, pod cutting
interchip  — bridge subsystem: compiled route programs across pod cuts
switch     — buffered wormhole switching: FIFOs, arbitration, backpressure
traffic    — synthetic traffic patterns (uniform/hotspot/transpose/bursty)
noc        — the executor + flit accounting (Tables I–V analogs)
"""
from .collectives import MeshAxis, NoCMesh, TransportStats
from .graph import PE, Channel, GraphError, Port, TaskGraph, torch_dtype
from .interchip import (BridgeConfig, BridgedProgram, BridgeLink, BridgeStats,
                        PodProgram, bridge_program_stats, compile_bridges,
                        run_bridged_program, simulate_bridged_program)
from .noc import NoCConfig, NoCExecutor, NoCStats, wrapper_overhead
from .partition import (PartitionPlan, candidate_cuts, cut, mesh_for_partition,
                        mesh_for_topology, node_device_coords, optimize_placement,
                        optimize_pod_cut, pair_cut_weights, place_greedy,
                        place_round_robin, placement_cost, placement_to_device_coords,
                        resolve_placement)
from .routing import (RouteProgram, ScheduleStats, all_to_all_for, compile_routes,
                      crossbar_all_to_all, grid_all_to_all, line_all_to_all,
                      ring_all_to_all_unidir, route_program_stats, run_route_program,
                      simulate_route_program, simulate_schedule, topology_axes,
                      transpose_oracle)
from .serdes import (LinkMeta, QuasiSerdesConfig, compression_ratio, decode, encode,
                     link_bytes_on_wire, link_wire_beats, plan, send_over_link)
from .switch import (DeadlockError, Packet, SwitchConfig, SwitchResult, SwitchStats,
                     dor_route, link_loads, saturation_rate, simulate_switch,
                     simulate_wormhole_cube, switch_lower_bound)
from .traffic import TrafficConfig, generate_traffic, traffic_matrix, transpose_partner
from .topology import (AxisSchedule, FatTree, Mesh2D, Ring, Topology, Torus2D,
                       bwd_pairs, compare, fwd_pairs, make_topology)

__all__ = [n for n in dir() if not n.startswith("_")]
