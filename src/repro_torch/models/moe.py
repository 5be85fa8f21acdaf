"""Mixture-of-Experts layer (counterpart of ``repro/models/moe.py``): tokens
are packets, the router's top-k gate writes each packet's destination expert,
and each (source block, expert) dispatch FIFO holds ``dispatch_capacity``
token slots, the CONNECT flit-buffer-depth analog; packets past it are
dropped, as a bounded FIFO back-pressures.

Engines, by ``MoEConfig.impl``:

* ``"dense"`` — `dense_ref`, every token through every expert, gate-combined.
* ``"gather"`` — the reference's ``_gather_local`` with one rank: one source
  block, every expert local, the capacity-bounded dispatch and no collective.
  That is what the reference computes under a one-device ``("data",
  "model")`` mesh, the mesh its serve and train CLIs enter.  The port has
  no mesh, so it does not take the reference's no-mesh fallback to
  `dense_ref`: on one card the gather engine always runs.
* ``"noc"`` — the packet route over a device mesh; it raises until
  device-mesh execution lands.

The drop set is the reference's: each expert keeps the first ``cap`` packets
in arrival order (packet ``t·k + j`` is token t's j-th choice).  The port
ranks packets within their expert by a stable sort where the reference takes
``lax.top_k`` of arrival scores; a slot past an expert's demand holds packet 0
with weight 0 and contributes exact zeros.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F

from ..core.noc import NoCConfig
from .layers import ParamSpec, _act


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    n_experts: int
    top_k: int
    d_ff: int
    capacity_factor: float = 1.25
    impl: str = "gather"            # gather | noc | dense
    noc_topology: str = "fattree"   # fattree | ring | mesh2d | torus2d
    act: str = "silu"
    # when set, flit_buffer_depth is the capacity knob (capacity_factor is
    # then derived; see dispatch_capacity)
    noc: Optional[NoCConfig] = None


@dataclasses.dataclass
class MoEDispatchStats:
    """Per-invocation dispatch accounting, returned by :func:`moe_apply`.

    ``drops`` / ``peak_occupancy`` are data-dependent (0-d tensors on the
    activations' device); the rest follows from shapes.  The one-rank gather
    engine moves nothing over links, so ``flits``, ``rounds`` and
    ``link_bytes`` are 0."""

    engine: str                     # engine that actually ran
    topology: Optional[str]         # noc engine: the routed topology
    fallback: Optional[str]         # reason a requested engine was not used
    capacity: int                   # per-(src, expert) FIFO depth, token slots
    capacity_factor: float          # effective (possibly derived) factor
    flits: int                      # framed flits on the links (out + back)
    rounds: int                     # ppermute rounds (out + back)
    link_bytes: int                 # bytes crossing topology links
    drops: Any = 0                  # tokens dropped by capacity
    peak_occupancy: Any = 0         # max tokens demanded of one (src,dst) buffer

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def publish(self, registry=None) -> None:
        """Publish into the telemetry metrics registry under the canonical
        ``noc.moe.*`` names; a no-op when metrics are off."""
        if registry is None:
            from ..telemetry.metrics import get_registry
            registry = get_registry()
        if registry is not None:
            registry.record_moe_stats(self)


def moe_specs(c: MoEConfig, dtype=torch.float32) -> dict:
    E, d, f = c.n_experts, c.d_model, c.d_ff
    return {
        "router": ParamSpec((d, E), ("embed", None), dtype, init="small"),
        "gate": ParamSpec((E, d, f), ("experts", "embed", "expert_mlp"), dtype),
        "up": ParamSpec((E, d, f), ("experts", "embed", "expert_mlp"), dtype),
        "down": ParamSpec((E, f, d), ("experts", "expert_mlp", "embed"), dtype),
    }


# ---------------------------------------------------------------------------
# capacity: one formula for every engine
# ---------------------------------------------------------------------------

def dispatch_capacity(tokens_per_src: int, c: MoEConfig) -> int:
    """Per-(source block, expert) dispatch-FIFO depth in token slots.

    With an attached NoCConfig its ``flit_buffer_depth`` is the depth;
    without one, ``tokens·top_k·capacity_factor / n_experts`` with a floor of
    8 slots.  Clamped to [1, tokens_per_src·top_k]."""
    if c.noc is not None:
        cap = c.noc.flit_buffer_depth
    else:
        cap = max(8, int(tokens_per_src * c.top_k * c.capacity_factor / c.n_experts))
    return max(1, min(cap, tokens_per_src * c.top_k))


def effective_capacity_factor(tokens_per_src: int, c: MoEConfig) -> float:
    """The capacity_factor implied by :func:`dispatch_capacity`."""
    cap = dispatch_capacity(tokens_per_src, c)
    return cap * c.n_experts / (tokens_per_src * c.top_k)


def _dispatch_counts(flat_dst, blk_of_pkt, n_experts: int, n_blocks: int):
    """Demanded packets per (expert, source block), (E, n_blocks) int32."""
    key = flat_dst * n_blocks + blk_of_pkt
    counts = torch.zeros(n_experts * n_blocks, dtype=torch.int32, device=key.device)
    return counts.index_add_(0, key, torch.ones_like(key, dtype=torch.int32)).view(
        n_experts, n_blocks)


def _dispatch_slots(flat_dst, blk_of_pkt, n_experts: int, n_blocks: int, cap: int):
    """First-``cap`` (arrival order) packet slots per (expert, source block).

    flat_dst: (P,) destination expert of each packet; blk_of_pkt: (P,) its
    source block.  Returns (slots, valid), each (n_experts, n_blocks, cap): a
    packet's rank among the earlier packets of its (expert, block) by a stable
    sort, and slot ``rank`` of that FIFO when ``rank < cap``.  Slots past the
    demand hold packet 0 with ``valid`` False.  No host synchronization."""
    npkt = flat_dst.shape[0]
    dev = flat_dst.device
    key = flat_dst * n_blocks + blk_of_pkt
    order = torch.sort(key, stable=True).indices
    counts = _dispatch_counts(flat_dst, blk_of_pkt, n_experts, n_blocks).view(-1).long()
    start = torch.cumsum(counts, 0) - counts
    pkt = torch.arange(npkt, device=dev)
    rank = torch.empty_like(pkt)
    rank[order] = pkt - start[key[order]]
    n_slots = n_experts * n_blocks * cap
    # packets past capacity land in one spare slot, cut off below
    dest = torch.where(rank < cap, key * cap + rank, n_slots)
    slots = torch.zeros(n_slots + 1, dtype=torch.long, device=dev).scatter_(0, dest, pkt)
    valid = torch.zeros(n_slots + 1, dtype=torch.bool, device=dev).scatter_(
        0, dest, torch.ones_like(dest, dtype=torch.bool))
    shape = (n_experts, n_blocks, cap)
    return slots[:n_slots].view(shape), valid[:n_slots].view(shape)


def _drops_and_peak(counts, cap: int, n_ranks: int):
    """(Σ relu(load - cap), max per-(src-block, dst-rank) demand), 0-d int32."""
    epr = counts.shape[0] // n_ranks
    drops = torch.clamp_min(counts - cap, 0).sum(dtype=torch.int32)
    per_pair = counts.reshape(n_ranks, epr, -1).sum(1)     # (dst_rank, blk)
    return drops, per_pair.max().to(torch.int32)


def _router(x_flat, wr, c: MoEConfig):
    """x_flat (T, d) -> (weights (T, k), idx (T, k), aux_loss, (me, ce)).

    The router's operands are x's dtype and the dot accumulates in float32
    (the reference's ``preferred_element_type``); the product of two bf16
    numbers is exact in float32, so ``float()`` of the operands computes it.
    The cast's backward hands x a cotangent in x's own dtype."""
    logits = x_flat.float() @ wr.to(x_flat.dtype).float()
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.topk(probs, c.top_k, dim=-1)
    w = w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-9)
    # Switch-style load-balance loss (mean of each term before the product)
    E = c.n_experts
    me = probs.mean(0)
    ce = F.one_hot(idx[:, 0], E).float().mean(0)
    aux = E * (me * ce).sum()
    return w.to(x_flat.dtype), idx, aux, (me, ce)


def dense_ref(params, x, c: MoEConfig):
    """Every token through every expert, gate-combined: O(E·T·d·f)."""
    B, S, d = x.shape
    xf = x.reshape(-1, d)
    w, idx, aux, _ = _router(xf, params["router"], c)
    gate_full = torch.zeros((xf.shape[0], c.n_experts), dtype=x.dtype,
                            device=x.device).scatter(1, idx, w)
    h = torch.einsum("td,edf->tef", xf, params["gate"].to(x.dtype))
    u = torch.einsum("td,edf->tef", xf, params["up"].to(x.dtype))
    y = torch.einsum("tef,efd->ted", _act(h, c.act) * u, params["down"].to(x.dtype))
    out = torch.einsum("ted,te->td", y, gate_full)
    return out.reshape(B, S, d), aux


def _expert_ffn(xe, wg, wu, wd, act):
    """xe (E, C, d) through the stacked experts (E, d, f), (E, f, d)."""
    return torch.bmm(_act(torch.bmm(xe, wg), act) * torch.bmm(xe, wu), wd)


def _gather_local(x_flat, wr, wg, wu, wd, c: MoEConfig):
    """The gather engine on one rank: every expert local, one source block.
    Returns (out (T, d), aux, drops, peak)."""
    T, d = x_flat.shape
    E = c.n_experts
    cap = dispatch_capacity(T, c)
    w, idx, aux, _ = _router(x_flat, wr, c)
    flat_dst = idx.reshape(-1)                                  # (T*k,) expert id
    flat_w = w.reshape(-1)
    tok_of = torch.arange(T, device=x_flat.device).repeat_interleave(c.top_k)
    blk0 = torch.zeros_like(flat_dst)
    slots, valid = _dispatch_slots(flat_dst, blk0, E, 1, cap)
    slots, valid = slots.view(E, cap), valid.view(E, cap)
    toks = tok_of[slots]
    xe = x_flat[toks] * valid[..., None].to(x_flat.dtype)       # (E, cap, d)
    ye = _expert_ffn(xe, wg, wu, wd, c.act)
    comb = (flat_w[slots] * valid.to(flat_w.dtype))[..., None]
    out = torch.zeros_like(x_flat).index_add(0, toks.reshape(-1), (ye * comb).reshape(-1, d))
    drops, peak = _drops_and_peak(_dispatch_counts(flat_dst, blk0, E, 1), cap, 1)
    return out, aux, drops, peak


def _static_stats(engine: str, c: MoEConfig, *, capacity=0, tokens_per_src=0,
                  drops=0, peak=0) -> MoEDispatchStats:
    cf = (effective_capacity_factor(tokens_per_src, c) if tokens_per_src
          else c.capacity_factor)
    return MoEDispatchStats(engine=engine, topology=None, fallback=None,
                            capacity=capacity, capacity_factor=cf, flits=0, rounds=0,
                            link_bytes=0, drops=drops, peak_occupancy=peak)


def moe_apply(params: dict, x: torch.Tensor, c: MoEConfig):
    """x: (B, S, d) -> (out, aux_loss, MoEDispatchStats), engine per ``c.impl``."""
    if c.impl == "dense":
        out, aux = dense_ref(params, x, c)
        return out, aux, _static_stats("dense", c)
    if c.impl == "noc":
        raise NotImplementedError(
            "moe_impl='noc' routes packets over a device mesh with the route programs of "
            "ROADMAP item 7 (device-mesh execution) and waits for item 8(e) (the mesh half "
            "of the LM stack); use 'gather' on one card")
    if c.impl != "gather":
        raise ValueError(f"moe impl must be 'gather', 'dense' or 'noc', got {c.impl!r}")
    B, S, d = x.shape
    T = B * S
    out, aux, drops, peak = _gather_local(
        x.reshape(T, d), *(params[n].to(x.dtype) for n in ("router", "gate", "up", "down")),
        c)
    stats = _static_stats("gather", c, capacity=dispatch_capacity(T, c), tokens_per_src=T,
                          drops=drops, peak=peak)
    return out.reshape(B, S, d), aux, stats
