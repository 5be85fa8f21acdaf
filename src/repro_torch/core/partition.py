"""Phase-2 of the paper: placement and cutting across pods (the first two
layers of ``repro.core.partition``).

1. **Placement** — map TaskGraph PEs onto topology nodes: round-robin, the
   greedy traffic-aware placer, and the annealing search
   (:func:`optimize_placement`) under the serdes-aware objective
   :func:`placement_cost`.  This is host code: the search draws from
   ``np.random.default_rng(seed)`` in the reference's order, so its
   placements equal the reference's dict for dict.
1b. **Device-mesh assignment** — the NoC mesh a topology's schedule runs
   over in ``mode="spmd"`` (:func:`mesh_for_topology`,
   :func:`mesh_for_partition`): NoC node ``i`` is rank ``i`` of the default
   process group, row-major over the topology's axes, and
   :func:`placement_to_device_coords` says which mesh coordinates each PE's
   messages leave from.
2. **Cutting** — given a node→pod assignment, classify every channel as
   intra-pod or cross-pod (:func:`cut` → :class:`PartitionPlan`), and
   co-optimize the cut with the serdes settings (:func:`optimize_pod_cut`).

The mesh sharding rules of the reference's third layer belong to the LM
stack's mesh slice (ROADMAP Queue 1 item 8(e)).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional, Sequence

import numpy as np

from . import serdes as qserdes
from .collectives import NoCMesh, make_mesh, world_size
from .graph import Channel, TaskGraph
from .topology import Mesh2D, Topology


def place_round_robin(graph: TaskGraph, topo: Topology) -> dict[str, int]:
    names = list(graph.pes)
    return {n: i % topo.n_nodes for i, n in enumerate(names)}


def place_greedy(graph: TaskGraph, topo: Topology) -> dict[str, int]:
    """Traffic-aware: place heavy-talking PE pairs on low-hop node pairs.

    Classic greedy: order PE pairs by traffic desc; for each, put the unplaced
    endpoint on the free node closest to the placed one.
    """
    traffic = graph.traffic_bytes()
    pairs = sorted(traffic.items(), key=lambda kv: -kv[1])
    placement: dict[str, int] = {}
    free = set(range(topo.n_nodes))

    def nearest_free(anchor: int) -> int:
        if not free:
            # more PEs than nodes: fall back to min-load node
            loads: dict[int, int] = {}
            for v in placement.values():
                loads[v] = loads.get(v, 0) + 1
            return min(range(topo.n_nodes), key=lambda n: loads.get(n, 0))
        return min(free, key=lambda n: topo.hops(anchor, n))

    for (a, b), _ in pairs:
        if a not in placement and b not in placement:
            na = min(free) if free else 0
            placement[a] = na
            free.discard(na)
            nb = nearest_free(na)
            placement[b] = nb
            free.discard(nb)
        elif a in placement and b not in placement:
            nb = nearest_free(placement[a])
            placement[b] = nb
            free.discard(nb)
        elif b in placement and a not in placement:
            na = nearest_free(placement[b])
            placement[a] = na
            free.discard(na)
    for n in graph.pes:  # isolated PEs
        if n not in placement:
            node = min(free) if free else 0
            placement[n] = node
            free.discard(node)
    return placement


def pair_cut_weights(graph: TaskGraph,
                     serdes_cfg: qserdes.QuasiSerdesConfig) -> dict[tuple[str, str], int]:
    """Per (src_pe, dst_pe) pair: the serialized wire beats its channels
    occupy when the pair lands across the pod cut (`serdes.link_wire_beats`)."""
    out: dict[tuple[str, str], int] = {}
    for c in graph.channels:
        p = graph.pes[c.src_pe].out_port(c.src_port)
        w = qserdes.link_wire_beats(p.shape, p.dtype, serdes_cfg)
        k = (c.src_pe, c.dst_pe)
        out[k] = out.get(k, 0) + w
    return out


def placement_cost(graph: TaskGraph, topo: Topology, placement: Mapping[str, int],
                   pod_of_node: Optional[Sequence[int]] = None,
                   serdes_cfg: Optional[qserdes.QuasiSerdesConfig] = None,
                   w_cut: float = 1.0) -> float:
    """The placement objective, shared by the annealer and the pod-cut
    co-optimizer: intra-pod edges (all edges when no cut is given) cost
    ``traffic_bytes × hops``; pod-crossing edges cost ``w_cut ×`` their
    serialized wire beats (`pair_cut_weights`)."""
    traffic = graph.traffic_bytes()
    if pod_of_node is None:
        return sum(b * topo.hops(placement[a], placement[c])
                   for (a, c), b in traffic.items())
    beats = pair_cut_weights(graph, serdes_cfg or qserdes.QuasiSerdesConfig())
    cost = 0.0
    for (a, c), b in traffic.items():
        if pod_of_node[placement[a]] == pod_of_node[placement[c]]:
            cost += b * topo.hops(placement[a], placement[c])
        else:
            cost += w_cut * beats[(a, c)]
    return cost


def optimize_placement(graph: TaskGraph, topo: Topology,
                       pod_of_node: Optional[Sequence[int]] = None,
                       init: Optional[Mapping[str, int]] = None,
                       iters: int = 2000, seed: int = 0,
                       w_cut: float = 1.0,
                       max_per_node: Optional[int] = None,
                       serdes_cfg: Optional[qserdes.QuasiSerdesConfig] = None,
                       ) -> dict[str, int]:
    """Annealing/KL-style placement search minimizing :func:`placement_cost`.

    Moves are single-PE relocations and PE↔PE swaps; acceptance is simulated
    annealing with a geometric cooling schedule, deterministic under
    ``seed``; a step re-costs only the moved PEs' channels.  ``max_per_node``
    caps router occupancy (default ``ceil(n_pes / n_nodes)``)."""
    rng = np.random.default_rng(seed)
    names = list(graph.pes)
    n = topo.n_nodes
    if max_per_node is None:
        max_per_node = -(-len(names) // n)

    def occupancy(p):
        o: dict[int, int] = {}
        for node in p.values():
            o[node] = o.get(node, 0) + 1
        return o

    if init is not None:
        placement = dict(init)
    else:
        # greedy seed when it respects capacity; round-robin (always balanced)
        # otherwise
        placement = place_greedy(graph, topo)
        if max(occupancy(placement).values(), default=0) > max_per_node:
            placement = place_round_robin(graph, topo)
    occ = occupancy(placement)
    if max(occ.values(), default=0) > max_per_node:
        raise ValueError(f"initial placement exceeds max_per_node={max_per_node}: "
                         f"occupancy {occ}")
    # symmetric traffic adjacency: pe -> [(other_pe, bytes, cut wire beats)]
    beats = pair_cut_weights(graph, serdes_cfg or qserdes.QuasiSerdesConfig())
    adj: dict[str, list[tuple[str, int, int]]] = {p: [] for p in names}
    for (a, b), by in graph.traffic_bytes().items():
        if a != b:
            adj[a].append((b, by, beats[(a, b)]))
            adj[b].append((a, by, beats[(a, b)]))

    def local(pe: str, node: int) -> float:
        c = 0.0
        for other, by, cw in adj[pe]:
            o = node if other == pe else placement[other]
            if pod_of_node is not None and pod_of_node[node] != pod_of_node[o]:
                c += w_cut * cw
            else:
                c += by * topo.hops(node, o)
        return c

    cost = float(placement_cost(graph, topo, placement, pod_of_node, serdes_cfg, w_cut))
    best_cost, best = cost, dict(placement)
    t0 = max(cost / max(len(names), 1), 1.0)
    t_end = t0 / 1000.0
    for it in range(iters):
        temp = t0 * (t_end / t0) ** (it / max(iters - 1, 1))
        if rng.random() < 0.5 or len(names) < 2:
            # relocate one PE to a random node with free capacity
            pe = names[int(rng.integers(len(names)))]
            old_node = placement[pe]
            new_node = int(rng.integers(n))
            if new_node == old_node or occ.get(new_node, 0) >= max_per_node:
                continue
            before = local(pe, old_node)
            placement[pe] = new_node
            delta = local(pe, new_node) - before
            if delta <= 0 or rng.random() < np.exp(-delta / temp):
                cost += delta
                occ[old_node] -= 1
                occ[new_node] = occ.get(new_node, 0) + 1
            else:
                placement[pe] = old_node
        else:
            # swap two PEs' nodes (KL-style exchange)
            i, j = rng.choice(len(names), size=2, replace=False)
            p, q = names[int(i)], names[int(j)]
            np_, nq = placement[p], placement[q]
            if np_ == nq:
                continue
            before = local(p, np_) + local(q, nq)
            placement[p], placement[q] = nq, np_
            delta = (local(p, nq) + local(q, np_)) - before
            if delta <= 0 or rng.random() < np.exp(-delta / temp):
                cost += delta
            else:
                placement[p], placement[q] = np_, nq
        if cost < best_cost - 1e-9:
            best_cost, best = cost, dict(placement)
    return best


def resolve_placement(graph: TaskGraph, topo: Topology, spec="rr",
                      pod_of_node: Optional[Sequence[int]] = None,
                      seed: int = 0,
                      serdes_cfg: Optional[qserdes.QuasiSerdesConfig] = None,
                      ) -> dict[str, int]:
    """Turn a placement spec into a PE→node map: ``"rr"`` (round-robin),
    ``"greedy"``, ``"opt"`` (:func:`optimize_placement`, cut-aware when
    ``pod_of_node`` is given, weighting cut edges by ``serdes_cfg``'s wire
    beats) or an explicit mapping, which is passed through."""
    if isinstance(spec, Mapping):
        missing = set(graph.pes) - set(spec)
        if missing:
            raise ValueError(f"placement mapping is missing PEs {sorted(missing)}")
        bad = {p: n for p, n in spec.items() if not 0 <= n < topo.n_nodes}
        if bad:
            raise ValueError(f"placement mapping has out-of-range nodes {bad} "
                             f"(topology has {topo.n_nodes} nodes)")
        return dict(spec)
    if spec == "rr":
        return place_round_robin(graph, topo)
    if spec == "greedy":
        return place_greedy(graph, topo)
    if spec == "opt":
        return optimize_placement(graph, topo, pod_of_node=pod_of_node, seed=seed,
                                  serdes_cfg=serdes_cfg)
    raise ValueError(f"unknown placement spec {spec!r}; use 'rr'|'greedy'|'opt' or a mapping")


# ---------------------------------------------------------------------------
# placement → device-mesh assignment (spmd execution of the placed graph)
# ---------------------------------------------------------------------------

def _ranks_for(topo: Topology, need: int, ranks: Optional[Sequence[int]], what: str) -> list[int]:
    """The ranks to build a mesh on (default: the default group's), or the
    actionable error when there are too few or no group at all."""
    have = world_size()
    ranks = list(range(have)) if ranks is None else list(ranks)
    if len(ranks) < need:
        found = (f"have {len(ranks)}" if have else
                 "but no torch.distributed process group is initialized")
        raise RuntimeError(
            f"topology {topo.name!r} needs {need} ranks for {what}, {found}; run under "
            f"torchrun --nproc-per-node {need} and join the group "
            f"(repro_torch.launch.mesh.join_process_group)")
    return ranks


def mesh_for_topology(topo: Topology, ranks: Optional[Sequence[int]] = None) -> NoCMesh:
    """The NoC mesh a topology's compiled routing schedule runs over.

    Mesh axes follow ``routing.topology_axes`` (1D ``noc`` axis for
    ring/fat-tree, ``(noc_y, noc_x)`` for mesh/torus), so NoC node ``i`` is
    rank ``i`` of ``ranks`` (default: the default group's) in mesh row-major
    order — the identity the spmd executor and :func:`node_device_coords`
    rely on.  Every rank of the default group calls it at the same point;
    ranks past the first ``n_nodes`` are off the mesh."""
    from .routing import topology_axes

    axes = topology_axes(topo)
    need = math.prod(s for _, s in axes)
    return make_mesh(axes, _ranks_for(topo, need, ranks, "SPMD execution"))


def mesh_for_partition(topo: Topology, plan: "PartitionPlan",
                       ranks: Optional[Sequence[int]] = None) -> NoCMesh:
    """The NoC mesh for *partitioned* spmd execution (`core.interchip`).

    When the plan's pods are equal-sized contiguous node blocks, the mesh is
    2D ``(pod, node)`` — pod p owns ranks ``[p*k, (p+1)*k)`` and the flat
    linearized index over ``("pod", "node")`` is exactly the global NoC node
    id the bridged program's hop pairs use.  For irregular cuts the topology
    mesh is returned instead (pod membership then lives only in the bridge
    tables; the execution is the same, the bridged program always runs
    linearized over the flat index)."""
    n = topo.n_nodes
    pods = tuple(plan.pod_of_node)
    n_pods = max(pods) + 1 if pods else 1
    blocked = (n_pods > 1 and n % n_pods == 0
               and all(pods[i] == i // (n // n_pods) for i in range(n)))
    if not blocked:
        return mesh_for_topology(topo, ranks)
    return make_mesh((("pod", n_pods), ("node", n // n_pods)),
                     _ranks_for(topo, n, ranks, "partitioned SPMD execution"))


def node_device_coords(topo: Topology, node: int) -> dict[str, int]:
    """Linear NoC node id → mesh-axis coordinates on :func:`mesh_for_topology`."""
    if not 0 <= node < topo.n_nodes:
        raise ValueError(f"node {node} out of range for {topo.n_nodes}-node topology")
    if isinstance(topo, Mesh2D):
        x, y = topo.coords(node)
        return {"noc_y": y, "noc_x": x}
    return {"noc": node}


def placement_to_device_coords(placement: Mapping[str, int],
                               topo: Topology) -> dict[str, dict[str, int]]:
    """Map a PE→node placement (e.g. an ``optimize_placement`` result) onto
    mesh coordinates: which rank each PE's messages leave from when the
    schedule runs on a device mesh."""
    return {pe: node_device_coords(topo, node) for pe, node in placement.items()}


# ---------------------------------------------------------------------------
# cutting across pods
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PartitionPlan:
    """Result of cutting a placed graph across pods (paper Fig. 5)."""

    placement: Mapping[str, int]          # PE -> node
    pod_of_node: tuple[int, ...]          # node -> pod
    intra: tuple[Channel, ...]
    cross: tuple[Channel, ...]            # channels that get serdes endpoints
    serdes_cfg: qserdes.QuasiSerdesConfig = qserdes.QuasiSerdesConfig()

    @property
    def n_pods(self) -> int:
        return max(self.pod_of_node) + 1 if self.pod_of_node else 1

    def cut_bytes(self, graph: TaskGraph) -> int:
        return sum(graph.pes[c.src_pe].out_port(c.src_port).nbytes for c in self.cross)

    def wire_beats(self, graph: TaskGraph) -> int:
        """Serialized wire beats (padded words incl. scale words) the cut
        channels occupy per wave — the cut cost the placement objective charges."""
        return sum(qserdes.link_wire_beats(graph.pes[c.src_pe].out_port(c.src_port).shape,
                                           graph.pes[c.src_pe].out_port(c.src_port).dtype,
                                           self.serdes_cfg)
                   for c in self.cross)

    def wire_bytes(self, graph: TaskGraph) -> int:
        """Bytes on the narrow inter-pod wire: ``wire_beats × beat_bytes``."""
        return self.wire_beats(graph) * self.serdes_cfg.beat_bytes


def cut(graph: TaskGraph, placement: Mapping[str, int], pod_of_node: Sequence[int],
        serdes_cfg: qserdes.QuasiSerdesConfig = qserdes.QuasiSerdesConfig()) -> PartitionPlan:
    intra, cross = [], []
    for c in graph.channels:
        same = pod_of_node[placement[c.src_pe]] == pod_of_node[placement[c.dst_pe]]
        (intra if same else cross).append(c)
    return PartitionPlan(dict(placement), tuple(pod_of_node), tuple(intra), tuple(cross),
                         serdes_cfg)


def candidate_cuts(topo: Topology, n_pods: int) -> list[tuple[int, ...]]:
    """Deterministic node→pod candidates for an ``n_pods``-way cut: linear
    blocks, column blocks for 2D topologies, and strided round-robin (the
    adversarial control)."""
    n = topo.n_nodes
    cands: list[tuple[int, ...]] = []
    if n % n_pods == 0:
        blk = n // n_pods
        cands.append(tuple(i // blk for i in range(n)))
        if isinstance(topo, Mesh2D) and topo.rx % n_pods == 0:
            w = topo.rx // n_pods
            cands.append(tuple((i % topo.rx) // w for i in range(n)))
        cands.append(tuple(i % n_pods for i in range(n)))
    else:
        cands.append(tuple(min(i * n_pods // n, n_pods - 1) for i in range(n)))
    seen, out = set(), []
    for c in cands:
        if c not in seen:
            seen.add(c)
            out.append(c)
    return out


def optimize_pod_cut(graph: TaskGraph, topo: Topology, n_pods: int = 2,
                     serdes_grid: Optional[Sequence[qserdes.QuasiSerdesConfig]] = None,
                     iters: int = 800, seed: int = 0,
                     w_cut: float = 1.0) -> tuple[PartitionPlan, float]:
    """Co-optimize the pod cut with the serdes settings: for every
    :func:`candidate_cuts` cut × config of ``serdes_grid``, anneal the
    placement under :func:`placement_cost` and keep the cheapest.  Returns
    ``(PartitionPlan, cost)``, ready for ``NoCExecutor(plan=...)``."""
    if serdes_grid is None:
        serdes_grid = [qserdes.QuasiSerdesConfig(wire_bits=wb, lanes=ln, compress=cp)
                       for wb in (8, 16, 32) for ln in (1, 8)
                       for cp in ("none", "bf16")]
    best: Optional[tuple[float, dict, tuple, qserdes.QuasiSerdesConfig]] = None
    for pods in candidate_cuts(topo, n_pods):
        for scfg in serdes_grid:
            pl = optimize_placement(graph, topo, pod_of_node=pods, iters=iters,
                                    seed=seed, w_cut=w_cut, serdes_cfg=scfg)
            c = float(placement_cost(graph, topo, pl, pods, scfg, w_cut))
            if best is None or c < best[0]:
                best = (c, pl, pods, scfg)
    cost, pl, pods, scfg = best
    return cut(graph, pl, pods, scfg), cost
