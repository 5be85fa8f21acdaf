"""Case study I: LDPC decoding, min-sum algorithm (paper §IV).

Two realizations, as in ``repro.apps.ldpc``:

* **TaskGraph** — one PE per bit/check node (the paper's N=7 projective-
  geometry code = the Fano plane PG(2,2), 7+7 nodes of degree 3), placed on a
  4×4 mesh NoC (Fig. 9).
* **Vectorized edge arrays** — the scalable form: all check updates of a batch
  of codewords are one ``(B·M, dc)`` block through the min-sum CUDA kernel, bit
  updates are one gather-sum; node↔node message motion is a static edge
  permutation (what the NoC routes).

Channel simulation (``awgn_llr``) and the code tables stay in numpy, as in the
reference.  ``decode_on_noc(pods=...)`` runs the 2-pod cut of Fig. 9.
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


def fano_plane_H() -> np.ndarray:
    """PG(2,2) point-line incidence: the paper's N=7, degree-3 LDPC code."""
    lines = [(0, 1, 2), (0, 3, 4), (0, 5, 6), (1, 3, 5), (1, 4, 6), (2, 3, 6), (2, 4, 5)]
    H = np.zeros((7, 7), np.int8)
    for c, pts in enumerate(lines):
        H[c, list(pts)] = 1
    return H


def pg_ldpc_H(m: int = 7, copies: int = 1) -> np.ndarray:
    """Block-diagonal replication of the Fano code (scaling knob)."""
    H = fano_plane_H()
    if copies == 1:
        return H
    out = np.zeros((7 * copies, 7 * copies), np.int8)
    for i in range(copies):
        out[7 * i:7 * i + 7, 7 * i:7 * i + 7] = H
    return out


@dataclasses.dataclass
class EdgeIndex:
    """Static routing tables for a regular LDPC code (dc, dv constant)."""

    H: np.ndarray
    check_edges: np.ndarray   # (M, dc) edge ids in check-major order
    bit_edges: np.ndarray     # (N, dv) edge ids in bit-major order
    edge_bit: np.ndarray      # (E,) bit index of edge e (check-major)
    n_edges: int


def build_edge_index(H: np.ndarray) -> EdgeIndex:
    M, N = H.shape
    cs, bs = np.nonzero(H)
    E = len(cs)
    dc = E // M
    check_edges = np.arange(E).reshape(M, dc)           # check-major enumeration
    bit_edges = np.zeros((N, (H.sum(0)).max()), np.int64)
    for b in range(N):
        bit_edges[b] = np.nonzero(bs == b)[0]
    return EdgeIndex(H, check_edges, bit_edges, bs, E)


def decode_minsum(idx: EdgeIndex, llr, n_iters: int, use_kernel: bool = True,
                  device="cuda") -> tuple[torch.Tensor, torch.Tensor]:
    """llr: (..., N) channel LLRs → (decoded bits (..., N) int8, posterior).

    The reference's ``vmap`` over codewords is a batch dimension here: each
    iteration hands the kernel one ``(B·M, dc)`` block."""
    dev = resolve_device(device)
    M, dc = idx.check_edges.shape
    ce = torch.as_tensor(idx.check_edges.reshape(-1), device=dev)
    be = torch.as_tensor(idx.bit_edges, device=dev)
    eb = torch.as_tensor(idx.edge_bit, device=dev)
    llr = torch.as_tensor(llr, dtype=torch.float32, device=dev)
    flat = llr.reshape(-1, llr.shape[-1])                      # (B, N)
    B = flat.shape[0]
    u = flat[:, eb]                                            # bit->check messages (B, E)
    be_flat = be.reshape(-1)
    total = flat
    for _ in range(n_iters):
        uc = u[:, ce].reshape(B * M, dc)                       # Data Collector gather
        v = kops.minsum_check(uc, use_kernel=use_kernel).reshape(B, -1)  # check->bit on edges
        vb = v[:, be]                                          # (B, N, dv)
        total = flat + vb.sum(-1)                              # bit node (Listing 3)
        u_bit = total[..., None] - vb                          # exclude self
        u = torch.zeros_like(u)
        u[:, be_flat] = u_bit.reshape(B, -1)
    return (total < 0).to(torch.int8).reshape(llr.shape), total.reshape(llr.shape)


# ---------------------------------------------------------------------------
# TaskGraph realization (paper Fig. 9)
# ---------------------------------------------------------------------------

def build_ldpc_graph(H: np.ndarray) -> tuple[TaskGraph, list[tuple[str, str]]]:
    """One PE per node; returns (graph, feedback wiring for run_iterative)."""
    M, N = H.shape
    g = TaskGraph("ldpc_minsum")
    deg_c = int(H.sum(1).max())
    deg_v = int(H.sum(0).max())

    def check_fn(**u):
        arr = torch.stack([u[f"u{i}"] for i in range(deg_c)])[None, :, 0]
        v = kref.minsum_check(arr)[0]
        return {f"v{i}": v[i:i + 1] for i in range(deg_c)}

    def bit_fn(**kw):
        u0 = kw["u0"]
        vs = torch.stack([kw[f"v{i}"] for i in range(deg_v)])[:, 0]
        total = u0 + vs.sum()
        out = {f"u{i}": total - vs[i:i + 1] for i in range(deg_v)}
        out["post"] = total
        return out

    for c in range(M):
        g.add(PE(f"chk{c}", check_fn,
                 tuple(Port(f"u{i}", (1,)) for i in range(deg_c)),
                 tuple(Port(f"v{i}", (1,)) for i in range(deg_c))))
    for b in range(N):
        g.add(PE(f"bit{b}", bit_fn,
                 (Port("u0", (1,)),) + tuple(Port(f"v{i}", (1,)) for i in range(deg_v)),
                 tuple(Port(f"u{i}", (1,)) for i in range(deg_v)) + (Port("post", (1,)),)))
    # wire: edge (c, b) — check input slot j_c, bit input slot j_b
    feedback = []
    for c in range(M):
        for j_c, b in enumerate(np.nonzero(H[c])[0]):
            j_b = list(np.nonzero(H[:, b])[0]).index(c)
            g.connect(f"chk{c}.v{j_c}", f"bit{b}.v{j_b}")
            feedback.append((f"bit{b}.u{j_b}", f"chk{c}.u{j_c}"))
    return g, feedback


def decode_on_noc(H: np.ndarray, llr: np.ndarray, n_iters: int,
                  topology: str = "mesh", n_nodes: int = 16,
                  pods: Optional[list[int]] = None,
                  placement="rr", mode: str = "sim", serdes_cfg=None,
                  tracer=None, device="cuda"):
    """Full paper flow: graph → placement → sim.  Returns (bits int8 (N,),
    posterior (N,), NoCStats) as numpy.

    ``placement``: 'rr' | 'greedy' | 'opt' (annealing search, cut-aware when
    ``pods`` is given) or an explicit PE→node mapping.  Initial check inputs
    are the channel LLRs of the connected bits (the standard initialization
    u_ij^{(0)} = llr_j).  ``mode``: 'sim', 'spmd' (the messages move over a
    device mesh, one NoC node per rank of the default process group; every
    rank calls it alike), 'buffered' (the wormhole switch: same decode,
    ``rounds`` are switch cycles and the ``switch_*`` counters fill),
    'sim_python' or 'direct'.  With ``pods`` the decode runs
    partitioned: cut links go through quasi-SERDES bridge endpoints
    (``serdes_cfg``), bit-identically to the uncut run, and the NoCStats carry
    the ``bridge_*`` counters (analytic ones in 'buffered', which routes
    uncut).  The executor verifies itself (``verify="strict"``).  ``tracer``:
    a `telemetry.Tracer` to record the run's events into
    (``NoCExecutor(trace=)``)."""
    dev = resolve_device(device)
    g, feedback = build_ldpc_graph(H)
    topo = make_topology(topology, n_nodes)
    ex = noc_executor(g, topo, placement, pods, serdes_cfg, tracer, dev)
    M, N = H.shape
    llr_t = torch.as_tensor(np.asarray(llr, np.float32), device=dev)
    inputs = {}
    for b in range(N):
        inputs[f"bit{b}.u0"] = llr_t[b:b + 1]
    for c in range(M):
        for j_c, b in enumerate(np.nonzero(H[c])[0]):
            inputs[f"chk{c}.u{j_c}"] = llr_t[b:b + 1]
    outs, stats = ex.run_iterative(inputs, feedback, n_iters, mode=mode)
    post = torch.cat([outs[f"bit{b}.post"] for b in range(N)]).cpu().numpy().astype(np.float64)
    return (post < 0).astype(np.int8), post, stats


# ---------------------------------------------------------------------------
# channel simulation
# ---------------------------------------------------------------------------

def awgn_llr(bits: np.ndarray, snr_db: float, rng) -> np.ndarray:
    """BPSK over AWGN → channel LLRs."""
    x = 1.0 - 2.0 * bits.astype(np.float64)
    sigma = np.sqrt(0.5 * 10 ** (-snr_db / 10))
    y = x + sigma * rng.normal(size=x.shape)
    return (2.0 * y / (sigma ** 2)).astype(np.float32)
