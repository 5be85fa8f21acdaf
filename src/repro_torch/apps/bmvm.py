"""Case study III: GF(2) matrix–vector multiplication, Williams' sub-quadratic
algorithm (paper §VI) — block-Wiedemann-style iterated products A^r·V.

The communication structure is exactly an all-to-all: node i looks up
LUT_i[v_i] and sends word j to node j, which XOR-accumulates — so topology
choice dominates performance (the paper's Table V).  Three realizations:

* ``iterate_kernel``   — single-device datapath: the hand-written LUT-XOR
                         CUDA kernel launched r times.
* ``iterate_noc_sim``  — PE-per-node TaskGraph on a chosen topology with
                         round-by-round routing stats (Table V reproduction).
* ``iterate_spmd``     — one NoC node per rank of a ``torch.distributed``
                         group: the kernel's local lookup in every rank, the
                         topology's schedule, XOR reduce.

Words are int32 on the device (k ≤ 16); the NoC message contracts stay
``np.uint32`` as in the reference — same bytes on the wire — and the PEs move
between the two with bit-preserving views.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .._device import resolve_device
from ..core import PE, NoCMesh, Port, TaskGraph, make_topology, mesh_for_topology
from ..core.collectives import world_size
from ..core.routing import all_to_all_for
from ..kernels import ops as kops
from ..kernels import ref as kref
from . import noc_executor


@dataclasses.dataclass(frozen=True)
class BMVMConfig:
    n: int = 64
    k: int = 8
    fold: int = 2
    topology: str = "mesh"

    @property
    def n_sub(self) -> int:           # sub-vectors
        return self.n // self.k

    @property
    def n_pe(self) -> int:            # PEs after folding
        if self.n_sub % self.fold:
            raise ValueError(f"fold={self.fold} does not divide n/k={self.n_sub}")
        return self.n_sub // self.fold


def preprocess(a_bits, cfg: BMVMConfig, device="cuda") -> torch.Tensor:
    """One-time LUT construction (paper Fig. 13): (C, 2^k, R) int32."""
    dev = resolve_device(device)
    return kref.gf2_preprocess(torch.as_tensor(a_bits, device=dev), cfg.k)


def software_ref(a_bits, v_bits, r: int, device="cuda") -> np.ndarray:
    """The paper's multithreaded-software analog: the direct O(n²) product
    iterated r times (float32 product mod 2 on the device)."""
    dev = resolve_device(device)
    a = torch.as_tensor(np.asarray(a_bits, np.uint8), device=dev)
    v = torch.as_tensor(np.asarray(v_bits, np.uint8), device=dev)
    for _ in range(r):
        v = kref.gf2_matmul_oracle(a, v)
    return v.cpu().numpy()


def iterate_kernel(lut: torch.Tensor, v_bits, cfg: BMVMConfig, r: int,
                   use_kernel: bool = True, device="cuda") -> torch.Tensor:
    """A^r·V via the LUT-XOR kernel; v_bits: (M, n) → (M, n) uint8 bits."""
    dev = resolve_device(device)
    lut = torch.as_tensor(lut, device=dev)
    vw = kref.gf2_pack_vector(torch.as_tensor(v_bits, device=dev), cfg.k)
    for _ in range(r):
        vw = kops.gf2_bmvm(lut, vw, use_kernel=use_kernel)
    return kref.gf2_unpack_vector(vw, cfg.k)


# ---------------------------------------------------------------------------
# NoC simulation (Table V reproduction)
# ---------------------------------------------------------------------------

def build_bmvm_graph(lut: torch.Tensor, cfg: BMVMConfig) -> tuple[TaskGraph, list]:
    """PE_i: lookup its (folded) LUT columns; ACC_j: XOR-accumulate words."""
    npe, f = cfg.n_pe, cfg.fold
    g = TaskGraph("bmvm")

    def mk_lookup(i):
        cols = torch.arange(i * f, (i + 1) * f, device=lut.device)

        def fn(**kw):
            v = kw["v"].view(torch.int32).to(torch.int64)  # (f,) this PE's sub-vectors
            words = lut[cols, v]                            # (f, R) int32
            agg = kref.xor_reduce(words, 0)                # fold-local combine
            return {f"w{j}": agg[j * f:(j + 1) * f].view(torch.uint32) for j in range(npe)}
        return fn

    def acc_fn(**kw):
        vals = torch.stack([kw[f"in{i}"].view(torch.int32) for i in range(npe)])
        return {"v": kref.xor_reduce(vals, 0).view(torch.uint32)}

    for i in range(npe):
        g.add(PE(f"lut{i}", mk_lookup(i),
                 (Port("v", (f,), np.uint32),),
                 tuple(Port(f"w{j}", (f,), np.uint32) for j in range(npe))))
    for j in range(npe):
        g.add(PE(f"acc{j}", acc_fn,
                 tuple(Port(f"in{i}", (f,), np.uint32) for i in range(npe)),
                 (Port("v", (f,), np.uint32),)))
    feedback = []
    for i in range(npe):
        for j in range(npe):
            g.connect(f"lut{i}.w{j}", f"acc{j}.in{i}")
        feedback.append((f"acc{i}.v", f"lut{i}.v"))
    return g, feedback


def iterate_noc_sim(lut, v_bits, cfg: BMVMConfig, r: int,
                    topology: Optional[str] = None, n_nodes: Optional[int] = None,
                    placement="rr", mode: str = "sim",
                    pods: Optional[list[int]] = None, serdes_cfg=None,
                    tracer=None, device="cuda"):
    """(decoded vector (n,) uint8, NoCStats) — the Table-V measurement path.

    ``placement``: 'rr' | 'greedy' | 'opt' (annealing search, cut-aware when
    ``pods`` is given) or an explicit PE→node mapping.  ``mode``: 'sim',
    'spmd' (the same compiled flit program over a device mesh, one NoC node
    per rank: every rank calls it alike), 'buffered' (the wormhole switch:
    same result, ``rounds`` are switch cycles and the ``switch_*`` counters
    fill), 'sim_python' or 'direct'.
    ``pods`` (node→pod) turns on partitioned execution: cut links run through
    quasi-SERDES bridge endpoints (``serdes_cfg``), results stay
    bit-identical and NoCStats gain the ``bridge_*`` counters (analytic ones
    in 'buffered', which routes uncut).  The executor verifies itself
    (``verify="strict"``).  ``tracer``: a `telemetry.Tracer` to record the
    run's events into (``NoCExecutor(trace=)``)."""
    dev = resolve_device(device)
    lut = torch.as_tensor(lut, device=dev)
    topo_name = topology or cfg.topology
    n_nodes = n_nodes or 2 * cfg.n_pe
    g, feedback = build_bmvm_graph(lut, cfg)
    topo = make_topology(topo_name, n_nodes)
    ex = noc_executor(g, topo, placement, pods, serdes_cfg, tracer, dev)
    v1 = torch.as_tensor(v_bits, device=dev).reshape(-1)   # single vector (n,)
    vw = kref.gf2_pack_vector(v1, cfg.k).view(torch.uint32)
    f = cfg.fold
    inputs = {f"lut{i}.v": vw[i * f:(i + 1) * f] for i in range(cfg.n_pe)}
    outs, stats = ex.run_iterative(inputs, feedback, r, mode=mode)
    out_w = torch.cat([outs[f"acc{i}.v"].view(torch.int32) for i in range(cfg.n_pe)])
    return kref.gf2_unpack_vector(out_w, cfg.k).cpu().numpy(), stats


# ---------------------------------------------------------------------------
# device-mesh realization — one NoC node per rank
# ---------------------------------------------------------------------------

def iterate_spmd(lut, v_bits, cfg: BMVMConfig, r: int, mesh: Optional[NoCMesh] = None,
                 topology: str = "fattree", device="cuda") -> torch.Tensor:
    """A^r·V with the PEs over the ranks of a device mesh, routed by the
    topology's schedule; v_bits: (M, n) → (M, n) uint8 bits on every rank.

    Every rank calls it on the same inputs (`core.collectives`).  Node ``i``
    holds ``lut[i*C_loc:(i+1)*C_loc]`` and ``vw[:, i*C_loc:(i+1)*C_loc]``.
    Each iteration: the local lookup ``out[m, r] = XOR_c lut[c, v[m, c], r]``
    through `kernels.ops.gf2_bmvm` (the hand-written kernel for a CUDA tensor,
    with no fallback: a shard it cannot take raises), packets per
    destination node (node j gets words ``[j*R_loc:(j+1)*R_loc]``), the
    topology's all-to-all (`routing.all_to_all_for`), XOR reduce.  The
    shards are gathered at the end.  ``mesh``: a `partition.mesh_for_topology`
    mesh (default: one over the whole default group)."""
    dev = resolve_device(device)
    if mesh is None:
        n = world_size()
        if n == 0:
            raise RuntimeError("bmvm.iterate_spmd needs a torch.distributed process group "
                               "with one rank per NoC node; run under torchrun "
                               "--nproc-per-node N and join the group "
                               "(repro_torch.launch.mesh.join_process_group)")
        topo = make_topology(topology, n)
        mesh = mesh_for_topology(topo)
    else:
        topo = make_topology(topology, mesh.size)
    n = topo.n_nodes
    a2a = all_to_all_for(topo, mesh)
    lut = torch.as_tensor(lut, device=dev)
    C, _, R = lut.shape
    if C % n or R % n:
        raise ValueError(f"LUT {tuple(lut.shape)}: C and R must split over {n} nodes")
    c_loc, r_loc = C // n, R // n
    vw = kref.gf2_pack_vector(torch.as_tensor(v_bits, device=dev), cfg.k)   # (M, C)
    M = vw.shape[0]
    i = mesh.node
    out = torch.zeros((M, r_loc), dtype=torch.int32, device=dev)
    if i >= 0:
        lut_loc = lut[i * c_loc:(i + 1) * c_loc]
        out = vw[:, i * c_loc:(i + 1) * c_loc].contiguous()
        for _ in range(r):
            part = kops.gf2_bmvm(lut_loc, out)                          # (M, R) local partial
            pkts = part.reshape(M, n, r_loc).transpose(0, 1)            # (n, M, r_loc)
            out = kref.xor_reduce(a2a(pkts.contiguous()), 0)            # (M, r_loc) my words
    out_w = mesh.gather_nodes(out).transpose(0, 1).reshape(M, n * r_loc)
    return kref.gf2_unpack_vector(out_w, cfg.k)
