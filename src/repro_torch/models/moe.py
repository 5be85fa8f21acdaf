"""Mixture-of-Experts layer (counterpart of ``repro/models/moe.py``): tokens
are packets, the router's top-k gate writes each packet's destination expert,
and each (source block, expert) dispatch FIFO holds ``dispatch_capacity``
token slots, the CONNECT flit-buffer-depth analog; packets past it are
dropped, as a bounded FIFO back-pressures.

Engines, by ``MoEConfig.impl``:

* ``"dense"`` — `dense_ref`, every token through every expert, gate-combined.
* ``"gather"`` — expert parallelism over model-replicated activations: each
  model rank takes the packets addressed to its ``E / n_ranks`` experts
  (capacity-bounded per (source block, expert)), computes, scatter-adds,
  and a psum over ``model`` combines.
* ``"noc"`` — the paper's packet route: the sequence is sharded over
  ``model``; per-destination-rank token cubes go out and back through the
  topology's compiled route program (`core.routing.run_route_program`
  linearized over the ``model`` axis: fat-tree one all_to_all, ring/mesh/
  torus ppermute rounds), and the stats carry ``2 ×
  route_program_stats`` of the cube.

The mesh is the ambient one (`core.collectives.current_mesh`, entered with
`launch.mesh.set_mesh`); the port is SPMD, so every rank runs the layer on
the same activations and `moe_apply` cuts the rank's block on the way in and
all-gathers on the way out (see its docstring), or, inside the LM's
data-parallel forward, runs on the rank's batch rows.  Gradients go through
every engine.  With no mesh both engines
run on one rank with every expert local and no transfer: what the reference
computes under a one-device ``("data", "model")`` mesh.  The port does not
take the reference's no-mesh fallback to `dense_ref` (a decided divergence);
it keeps the reference's other fallbacks (E not divisible by the ranks:
`dense_ref`; ``noc`` on a decode-shaped input: ``gather``).

The drop set is the reference's: each expert keeps the first ``cap`` packets
in arrival order (packet ``t·k + j`` is token t's j-th choice).  The port
ranks packets within their expert by a stable sort where the reference takes
``lax.top_k`` of arrival scores; a slot past an expert's demand holds packet 0
with weight 0 and contributes exact zeros.
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Any, Optional

import torch
import torch.nn.functional as F

from ..core import collectives as coll
from ..core.noc import NoCConfig
from ..core.routing import compile_routes, route_program_stats, run_route_program
from ..core.topology import make_topology
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
    activations' device); the rest follows from shapes and, for ``noc``, the
    compiled route program: ``flits``, ``rounds`` and ``link_bytes`` are
    ``2 ×`` its counters for the dispatched cube (out and back), 0 for the
    gather engine.  Counters are per model-axis invocation."""

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


def _dispatch_slots(flat_dst, blk_of_pkt, experts, n_blocks: int, cap: int):
    """First-``cap`` (arrival order) packet slots per (expert, source block).

    flat_dst: (P,) destination expert of each packet; blk_of_pkt: (P,) its
    source block; experts: the expert ids to dispatch, a (E',) tensor, or a
    count E for ``0..E-1``.  Returns (slots, valid), each (E', n_blocks,
    cap): a packet's rank among the earlier packets of its (expert, block)
    by a stable sort, and slot ``rank`` of that FIFO when ``rank < cap``.
    Slots past the demand hold packet 0 with ``valid`` False.  No host
    synchronization."""
    npkt = flat_dst.shape[0]
    dev = flat_dst.device
    if isinstance(experts, int):
        ne, pos = experts, flat_dst
    else:
        # each packet's position in ``experts``; packets for other experts
        # go to one spare key past the last FIFO
        ne = experts.shape[0]
        match = flat_dst[:, None] == experts[None, :]
        pos = torch.where(match.any(1), match.long().argmax(1), ne)
    key = pos * n_blocks + blk_of_pkt
    order = torch.sort(key, stable=True).indices
    counts = _dispatch_counts(pos, blk_of_pkt, ne + 1, n_blocks).view(-1).long()
    start = torch.cumsum(counts, 0) - counts
    pkt = torch.arange(npkt, device=dev)
    rank = torch.empty_like(pkt)
    rank[order] = pkt - start[key[order]]
    n_slots = ne * n_blocks * cap
    # packets past capacity, or for other experts, land in one spare slot,
    # cut off below
    dest = torch.where((rank < cap) & (pos < ne), key * cap + rank, n_slots)
    slots = torch.zeros(n_slots + 1, dtype=torch.long, device=dev).scatter_(0, dest, pkt)
    valid = torch.zeros(n_slots + 1, dtype=torch.bool, device=dev).scatter_(
        0, dest, torch.ones_like(dest, dtype=torch.bool))
    shape = (ne, n_blocks, cap)
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
    out, aux, _ = _dense(params, x, c, None)
    return out, aux


def _dense(params, x, c: MoEConfig, axis):
    """`dense_ref` -> (out, aux, (me, ce)); with the model ``axis`` (None:
    one rank) the expert leaves hold the rank's block of experts, which
    every token passes through, and the ranks' parts are added."""
    B, S, d = x.shape
    xf = x.reshape(-1, d)
    w, idx, aux, mece = _router(xf, params["router"], c)
    gate_full = torch.zeros((xf.shape[0], c.n_experts), dtype=x.dtype,
                            device=x.device).scatter(1, idx, w)
    if axis is not None:
        epr = c.n_experts // axis.size
        gate_full = coll.copy_to(gate_full, axis)[:, axis.coord * epr:(axis.coord + 1) * epr]
        xf = coll.copy_to(xf, axis)
    h = torch.einsum("td,edf->tef", xf, params["gate"].to(x.dtype))
    u = torch.einsum("td,edf->tef", xf, params["up"].to(x.dtype))
    y = torch.einsum("tef,efd->ted", _act(h, c.act) * u, params["down"].to(x.dtype))
    out = coll.reduce_from(torch.einsum("ted,te->td", y, gate_full), axis)
    return out.reshape(B, S, d), aux, mece


def _expert_ffn(xe, wg, wu, wd, act):
    """xe (E, C, d) through the stacked experts (E, d, f), (E, f, d)."""
    return torch.bmm(_act(torch.bmm(xe, wg), act) * torch.bmm(xe, wu), wd)


def _combine(contrib, slots, valid, idx):
    """out (T, d): each token's kept packets' contributions added in
    ascending expert order, the order a serial scatter-add over the
    expert-major slots takes, with no atomics, so the card gives the same
    bits on every run.  contrib (E', C, d) per slot; slots, valid (E', C);
    idx (T, k) each token's experts."""
    T, k = idx.shape
    d = contrib.shape[-1]
    # one row per packet (a packet holds at most one slot); empty slots
    # write a spare row past the end
    dest = torch.where(valid, slots, T * k).reshape(-1)
    per_pkt = contrib.new_zeros(T * k + 1, d)
    per_pkt[dest] = contrib.reshape(-1, d)
    order = idx.argsort(dim=1)[..., None].expand(T, k, d)
    per = per_pkt[:T * k].view(T, k, d).gather(1, order)
    out = per[:, 0]
    for j in range(1, k):
        out = out + per[:, j]
    return out


def _gather_local(x_flat, wr, wg, wu, wd, c: MoEConfig, axis, blk_of, n_blocks: int):
    """The gather engine on this rank's tokens (T, d), replicated over
    ``axis`` (the model axis; None: one rank): the rank's ``E / n_ranks``
    experts take the first ``cap`` packets of each (source block, expert),
    compute, scatter-add, and a psum over ``axis`` combines.  blk_of: (T,)
    source block of each token.  Returns (out, aux, (me, ce), drops, peak),
    the drops and peak of the whole layer (replicated over ``axis``)."""
    T, d = x_flat.shape
    E = c.n_experts
    n_ranks = axis.size if axis is not None else 1
    epr = E // n_ranks
    cap = dispatch_capacity(T // n_blocks, c)
    w, idx, aux, mece = _router(x_flat, wr, c)
    flat_dst = idx.reshape(-1)                                  # (T*k,) expert id
    flat_w = w.reshape(-1)
    tok_of = torch.arange(T, device=x_flat.device).repeat_interleave(c.top_k)
    blk_of_pkt = blk_of.repeat_interleave(c.top_k)
    local_e = (E if n_ranks == 1 else
               axis.coord * epr + torch.arange(epr, device=x_flat.device))
    slots, valid = _dispatch_slots(flat_dst, blk_of_pkt, local_e, n_blocks, cap)
    slots, valid = slots.reshape(epr, -1), valid.reshape(epr, -1)   # (epr, n_blocks*cap)
    toks = tok_of[slots]
    # x and the gate weights feed the rank's experts only: copy_to
    xe = coll.copy_to(x_flat, axis)[toks] * valid[..., None].to(x_flat.dtype)
    ye = _expert_ffn(xe, wg, wu, wd, c.act)
    comb = (coll.copy_to(flat_w, axis)[slots] * valid.to(flat_w.dtype))[..., None]
    out = _combine(ye * comb, slots, valid, idx)
    out = coll.reduce_from(out, axis)                           # combine expert ranks
    counts = _dispatch_counts(flat_dst, blk_of_pkt, E, n_blocks)
    drops, peak = _drops_and_peak(counts, cap, n_ranks)
    return out, aux, mece, drops, peak


def _noc_local(x_flat, wr, wg, wu, wd, c: MoEConfig, axis, prog, cap: int):
    """The noc engine on this rank's sequence shard (T_loc, d): pack one
    token cube per destination rank (static (expert, slot) framing), move it
    out and back with the compiled route program linearized over ``axis``
    (the model axis; None: one rank, the cube stays local), compute,
    combine.  Returns (out, aux, (me, ce), drops, peak), this shard's share
    of the drops."""
    T, d = x_flat.shape
    E = c.n_experts
    n_ranks = axis.size if axis is not None else 1
    epr = E // n_ranks
    w, idx, aux, mece = _router(x_flat, wr, c)
    flat_dst = idx.reshape(-1)
    flat_w = w.reshape(-1)
    tok_of = torch.arange(T, device=x_flat.device).repeat_interleave(c.top_k)
    blk0 = torch.zeros_like(flat_dst)                           # one local source block
    slots, valid = _dispatch_slots(flat_dst, blk0, E, 1, cap)
    slots, valid = slots[:, 0], valid[:, 0]                     # (E, cap)
    toks = tok_of[slots]
    payload = x_flat[toks] * valid[..., None].to(x_flat.dtype)  # (E, cap, d)

    def route(cube):
        if n_ranks == 1:
            return cube
        return _Route.apply(cube, prog, axis)

    # outbound: row e = (destination rank e // epr, local expert e % epr), so
    # the (n_ranks, epr*cap, d) cube is destination-indexed
    rx = route(payload.reshape(n_ranks, epr * cap, d))         # (src rank, epr*cap, d)
    xe = rx.reshape(n_ranks, epr, cap, d).movedim(1, 0).reshape(epr, n_ranks * cap, d)
    ye = _expert_ffn(xe, wg, wu, wd, c.act)                     # (epr, R*cap, d)
    # return trip: the same program, the cube destination-indexed by source rank
    ycube = ye.reshape(epr, n_ranks, cap, d).movedim(1, 0).reshape(n_ranks, epr * cap, d)
    back = route(ycube).reshape(E, cap, d)                      # slot-aligned with payload
    contrib = back * (flat_w[slots] * valid.to(flat_w.dtype))[..., None]
    out = _combine(contrib, slots, valid, idx)
    drops, peak = _drops_and_peak(_dispatch_counts(flat_dst, blk0, E, 1), cap, n_ranks)
    return out, aux, mece, drops, peak


class _Route(torch.autograd.Function):
    """The route program over the model axis, linearized: a transpose of the
    destination-indexed cube, its own adjoint, so the backward routes the
    cotangent cube the same way."""

    @staticmethod
    def forward(ctx, cube, prog, axis):
        ctx.prog, ctx.axis = prog, axis
        return run_route_program(cube, prog, axis.mesh, axis_name=axis.names)

    @staticmethod
    def backward(ctx, g):
        return (run_route_program(g.contiguous(), ctx.prog, ctx.axis.mesh,
                                  axis_name=ctx.axis.names), None, None)


def _static_stats(engine: str, c: MoEConfig, *, fallback=None, topology=None, capacity=0,
                  tokens_per_src=0, flits=0, rounds=0, link_bytes=0, drops=0,
                  peak=0) -> MoEDispatchStats:
    cf = (effective_capacity_factor(tokens_per_src, c) if tokens_per_src
          else c.capacity_factor)
    return MoEDispatchStats(engine=engine, topology=topology, fallback=fallback,
                            capacity=capacity, capacity_factor=cf, flits=flits,
                            rounds=rounds, link_bytes=link_bytes, drops=drops,
                            peak_occupancy=peak)


def moe_apply(params: dict, x: torch.Tensor, c: MoEConfig, *, batch_local: bool = False):
    """x: (B, S, d) -> (out, aux_loss, MoEDispatchStats), engine per ``c.impl``.

    Under an ambient mesh with a ``model`` axis (`launch.mesh.set_mesh`)
    every rank calls it with the same non-expert weights; the expert leaves
    hold the rank's ``E / n_model`` experts (`models.layers.shard_params`
    by the ``experts`` rule), or all E.  x is the same on every rank, and
    the rank takes its block (the batch over the data axes when they divide
    B, and for ``noc`` the sequence over ``model``), runs the engine and
    all-gathers the blocks, so every rank returns the whole (B, S, d).  With
    ``batch_local`` (the LM's data-parallel forward) x is the rank's block
    of the batch already and the output is the rank's block; aux, drops and
    peak cover the whole batch either way.  ``dense`` runs every token on
    every rank, with the experts split over ``model`` when the leaves hold a
    block of them.  Without a mesh (or
    a model axis) the engines run on one rank with every expert, as the
    reference does under a one-device mesh.

    Gradients go through every engine on a mesh: the transfers are the
    autograd-aware collectives of `core.collectives` and the route program
    is its own adjoint.  The loss is taken as replicated over the model
    axis, and over the data axes unless ``batch_local``, whose gradients the
    train step averages.

    Fallbacks, each recorded in ``stats.fallback`` with a ``UserWarning``:
    E not divisible by the model ranks runs `dense_ref` (the expert leaves
    then hold all E); ``noc`` on a sequence the model ranks do not divide
    (decode) runs ``gather``."""
    if c.impl not in ("gather", "noc", "dense"):
        raise ValueError(f"moe impl must be 'gather', 'dense' or 'noc', got {c.impl!r}")
    mesh = coll.current_mesh()
    has_model = mesh is not None and "model" in mesh.axis_names
    n_ranks = mesh.shape[mesh.axis_names.index("model")] if has_model else 1
    B, S, d = x.shape
    batch_axes = tuple(a for a in ("pod", "data") if mesh is not None and a in mesh.axis_names)
    n_batch = math.prod(mesh.shape[mesh.axis_names.index(a)] for a in batch_axes)
    if not batch_local and B % n_batch:
        batch_axes, n_batch = (), 1          # tiny-batch decode: replicate over data axes
    baxis = mesh.axis(batch_axes) if n_batch > 1 else None
    # the gradient scale of a mean over the data axes (see the docstring)
    bscale = 1.0 if batch_local else 1.0 / n_batch

    def aux_of(aux, mece, axis, scale):
        if axis is None or axis.size == 1:
            return aux
        me, ce = (coll.mean_from(t, axis, scale) for t in mece)
        return c.n_experts * (me * ce).sum()

    def dense(reason=None):
        # every token of x on every rank; the experts split over the model
        # axis when the leaves hold a block of them
        maxis = (mesh.axis("model") if has_model and params["gate"].shape[0] != c.n_experts
                 else None)
        out, aux, mece = _dense(params, x, c, maxis)
        aux = aux_of(aux, mece, baxis, 1.0) if batch_local else aux
        return out, aux, _static_stats("dense", c, fallback=reason)

    if c.impl == "dense":
        return dense()
    if c.n_experts % n_ranks:
        reason = (f"n_experts={c.n_experts} not divisible by model ranks="
                  f"{n_ranks}: dense_ref fallback, O(E*T*d*f) per token")
        warnings.warn(f"moe_apply: {reason}", stacklevel=2)
        return dense(reason)

    impl, fallback = c.impl, None
    if impl == "noc" and (S < n_ranks or S % n_ranks):
        fallback = (f"impl='noc' needs seq len {S} divisible by model ranks="
                    f"{n_ranks} (decode-shaped input): using 'gather'")
        warnings.warn(f"moe_apply: {fallback}", stacklevel=2)
        impl = "gather"

    maxis = mesh.axis("model") if n_ranks > 1 else None
    epr = c.n_experts // n_ranks
    for k in ("gate", "up", "down"):
        if params[k].shape[0] != epr:
            raise ValueError(f"moe_apply: the {k!r} leaf holds {params[k].shape[0]} experts; on "
                             f"{n_ranks} model ranks it holds the rank's {epr} "
                             "(models.layers.shard_params)")
    # the weights read rank-local tokens: over the data axes, unless the
    # train step averages their gradients there
    wr, wg, wu, wd = (coll.copy_to(params[k], None if batch_local else baxis).to(x.dtype)
                      for k in ("router", "gate", "up", "down"))
    xb = x if batch_local else coll.scatter_to(x, baxis, 0)
    B_loc = xb.shape[0]

    if impl == "gather":
        T = B_loc * S
        # source blocks == the noc engine's sequence shards when S divides,
        # so both engines enforce the same per-(source, expert) capacity
        n_blocks = n_ranks if S % n_ranks == 0 else 1
        blk_of = (torch.arange(T, device=x.device) % S) // (S // n_blocks)
        out, aux, mece, drops, peak = _gather_local(xb.reshape(T, d), wr, wg, wu, wd, c,
                                                    maxis, blk_of, n_blocks)
        aux = aux_of(aux, mece, baxis, bscale)
        if baxis is not None:    # drops replicated over 'model'; sum the replicas
            drops, peak = coll.psum(drops, baxis), coll.pmax(peak, baxis)
        out = out.reshape(B_loc, S, d)
        if not batch_local:
            out = coll.gather_from(out, baxis, 0)
        stats = _static_stats("gather", c, fallback=fallback,
                              capacity=dispatch_capacity(T // n_blocks, c),
                              tokens_per_src=T // n_blocks, drops=drops, peak=peak)
        return out, aux, stats

    # impl == "noc": the topology's route program over the model ranks
    prog = compile_routes(make_topology(c.noc_topology, n_ranks))
    ncfg = c.noc or NoCConfig()
    S_loc = S // n_ranks
    T_loc = B_loc * S_loc
    cap = dispatch_capacity(T_loc, c)
    msg_nbytes = epr * cap * d * x.element_size()              # one (src, dst) token cube
    sstats = route_program_stats(prog, n_ranks * n_ranks * msg_nbytes)
    # the router reads the rank's sequence block: its gradient adds over model
    xl = coll.scatter_to(xb, maxis, 1)                          # row-major (b, s) tokens
    out, aux, mece, drops, peak = _noc_local(xl.reshape(T_loc, d), coll.copy_to(wr, maxis),
                                             wg, wu, wd, c, maxis, prog, cap)
    ball = mesh.axis(batch_axes + ("model",)) if mesh is not None and has_model else None
    aux = aux_of(aux, mece, ball, bscale / n_ranks)
    if ball is not None and ball.size > 1:
        drops, peak = coll.psum(drops, ball), coll.pmax(peak, ball)
    out = coll.gather_from(out.reshape(B_loc, S_loc, d), maxis, 1)
    if not batch_local:
        out = coll.gather_from(out, baxis, 0)
    stats = _static_stats(
        "noc", c, fallback=fallback, topology=c.noc_topology, capacity=cap,
        tokens_per_src=T_loc,
        # out + back trips of the same program; flits frame all n^2 buffers
        flits=2 * n_ranks * n_ranks * ncfg.flits_for(msg_nbytes),
        rounds=2 * sstats.rounds, link_bytes=2 * sstats.link_bytes, drops=drops, peak=peak)
    return out, aux, stats
