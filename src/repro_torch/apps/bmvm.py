"""Case study III: GF(2) matrix–vector multiplication, Williams' sub-quadratic
algorithm (paper §VI) — block-Wiedemann-style iterated products A^r·V.

The communication structure is exactly an all-to-all: node i looks up
LUT_i[v_i] and sends word j to node j, which XOR-accumulates — so topology
choice dominates performance (the paper's Table V).  Two realizations here:

* ``iterate_kernel``   — single-device datapath: the hand-written LUT-XOR
                         CUDA kernel launched r times.
* ``iterate_noc_sim``  — PE-per-node TaskGraph on a chosen topology with
                         round-by-round routing stats (Table V reproduction).

Words are int32 on the device (k ≤ 16); the NoC message contracts stay
``np.uint32`` as in the reference — same bytes on the wire — and the PEs move
between the two with bit-preserving views.  ``iterate_spmd`` waits for the
device-mesh slice (ROADMAP Queue 1 item 7).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .._device import resolve_device
from ..core import PE, Port, TaskGraph, make_topology
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
    'buffered' (the wormhole switch: same result, ``rounds`` are switch
    cycles and the ``switch_*`` counters fill), 'sim_python' or 'direct'.
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


def iterate_spmd(*args, **kwargs):
    """The shard_map realization of the reference runs the PEs over a device
    mesh; it belongs to the device-mesh slice of the port."""
    raise NotImplementedError("bmvm.iterate_spmd is not ported yet: device-mesh "
                              "execution (ROADMAP Queue 1 item 7)")
