"""Collectives of device-mesh execution over ``torch.distributed``: the port's
counterparts of ``lax.ppermute``, ``lax.all_to_all``, ``lax.psum``,
``lax.pmean``, ``lax.pmax``, ``lax.all_gather`` and the assembled output of a
``shard_map``, and the ambient mesh a model call reads.

The execution model
-------------------
The reference is single-controller: one program drives every device of a
``jax.sharding.Mesh``, and ``shard_map`` hands each device its block.  The
port is SPMD in torch's sense: every rank of the default process group runs
the same program on the same inputs.  A :class:`NoCMesh` names the ranks that
are NoC nodes — the first ``n`` ranks of the default group, node ``i`` = rank
``i``, row-major over the mesh axes (`partition.mesh_for_topology`) — and a
:class:`MeshAxis` is one rank's view of one axis, or of several linearized
into one: the group, the ranks along it and this rank's coordinate.  It is
the counterpart of an axis name inside ``shard_map``, built once per mesh.

A mesh made with ``axis_groups=True`` (the LM's ``("data", "model")`` meshes,
`launch.mesh.make_host_mesh`) also holds a process group for each row of
each set of its axes, made collectively when the mesh is made: every rank of
the default group calls ``dist.new_group`` for every row, in the same order.
The reductions and the all-gather run over such a row; without one, only an
axis that holds every node of the mesh (the mesh's own group) can.

The ambient mesh (the counterpart of ``jax.sharding.get_abstract_mesh()``)
is a ``contextvars`` variable: :func:`use_mesh` enters a mesh
(`launch.mesh.set_mesh` wraps it) and :func:`current_mesh` reads it.

Transport semantics
-------------------
* :func:`ppermute` (``lax.ppermute``): one ``dist.batch_isend_irecv`` of the
  pairs that touch this rank, waited on before it returns, so two moves
  between the same pair of ranks are never in flight together (on a 2-wide
  axis the forward and backward neighbours coincide).  A rank that is the
  destination of no pair receives zeros, as under ``ppermute``; a self pair
  is a local copy.
* :func:`all_to_all` (``lax.all_to_all`` with split and concat axis 0):
  ``dist.all_to_all_single`` over the axis's group.
* :func:`all_gather`, :func:`psum`, :func:`pmean`, :func:`pmax`: one
  ``dist.all_gather`` over the axis's group, then, for the reductions, a sum
  (or max) in axis order on the tensor's device, so every rank of the row
  gets the same bits whatever the backend's reduction order (a bf16/fp16
  sum in float32, rounded once).  An axis of
  one rank moves nothing.
* :meth:`NoCMesh.gather_nodes` (a ``shard_map`` output assembled):
  ``dist.all_gather`` over the default group, so every rank, a node of the
  mesh or not, returns the same rows.
* :func:`copy_to`, :func:`reduce_from`, :func:`gather_from`,
  :func:`scatter_to` and :func:`mean_from` are the collectives that autograd
  goes through (the Megatron pairs; the raw ones above move bytes and cut the
  graph).  A tensor replicated over an axis carries one cotangent, held
  replicated: ``copy_to`` is the identity forward and a psum backward (a
  replicated tensor entering a computation each rank does a part of),
  ``reduce_from`` a psum forward and the identity backward, ``gather_from``
  an all-gather forward and the rank's own block backward, ``scatter_to`` the
  reverse.  ``mean_from`` is a pmean whose backward scales by a factor the
  caller states: ``1 / n`` over an axis the loss is replicated on, 1 over the
  data axes, whose gradients the train step averages afterwards.
* Every transfer moves the tensor's bytes (a uint8 view), so any dtype goes.
  gloo reads host memory: under gloo a CUDA tensor is staged through the host
  with explicit ``.cpu()`` / ``.to(device)`` around each transfer, and the
  mesh's :class:`TransportStats` count the staged bytes.  Under NCCL a CUDA
  tensor goes direct.  The transport never picks a backend: whoever
  initializes the default group does (`launch.mesh.join_process_group`).

Counting
--------
Under :func:`count_collectives` (what `launch.roofline.CostCounter` enters)
each collective over more than one rank is reported to the counter once, by
its meaning, at its output bytes, under the HLO name of the reference's
parser: ``all-reduce`` (:func:`psum`, :func:`pmean`, :func:`pmax`, so
:func:`reduce_from`, :func:`mean_from` and the backward of :func:`copy_to`
too), ``all-gather`` (:func:`all_gather`, so :func:`gather_blocks` and
:func:`gather_from`, and :meth:`NoCMesh.gather_nodes`), ``all-to-all`` and
``collective-permute`` (:func:`ppermute`).  The transport inside a
collective (a psum's all-gather and adds, the staging copies) is not
counted again; :class:`TransportStats` go on counting it.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
import itertools
import math
import time
from typing import Any, Iterator, Optional, Sequence, Union

import torch
import torch.distributed as dist


@dataclasses.dataclass
class TransportStats:
    """What one mesh's transfers cost this rank: transfers made, host
    seconds inside them, and bytes copied between the card and the host (both
    ways) with the host seconds of those copies, which include the wait for
    the card's queued work."""

    calls: int = 0
    seconds: float = 0.0
    staged_bytes: int = 0
    staging_seconds: float = 0.0

    def reset(self) -> None:
        self.calls, self.seconds, self.staged_bytes, self.staging_seconds = 0, 0.0, 0, 0.0


def world_size() -> int:
    """Ranks of the default process group; 0 when none is initialized."""
    if not dist.is_available() or not dist.is_initialized():
        return 0
    return dist.get_world_size()


_NO_GROUP = object()     # an axis row with no process group of its own

# the counters of count_collectives, innermost last: a module global, not a
# context variable, since a backward runs on autograd's device threads
_COUNTERS: list = []


@contextlib.contextmanager
def count_collectives(counter) -> Iterator:
    """Report every collective of the block to ``counter``:
    ``counter.collective(kind, out)`` after it, with ``counter.suspended()``
    entered around its transport."""
    _COUNTERS.append(counter)
    try:
        yield counter
    finally:
        _COUNTERS.remove(counter)


def _counted(kind: str):
    """Report each call of the collective (one over more than one rank:
    its second argument's ``size``) to the innermost counter as one ``kind``
    op at its output's bytes; the collectives it calls inside are not
    reported."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args):
            if not _COUNTERS or args[1].size == 1:
                return fn(*args)
            counter = _COUNTERS.pop()
            try:
                with counter.suspended():
                    out = fn(*args)
            finally:
                _COUNTERS.append(counter)
            counter.collective(kind, out)
            return out
        return run
    return wrap


@dataclasses.dataclass(frozen=True, eq=False)
class MeshAxis:
    """One rank's view of a mesh axis (``names`` linearized row-major when
    there are several): the ranks along it through this rank, in axis order,
    this rank's coordinate among them, and the process group of exactly
    those ranks (``None``: the default group; ``_NO_GROUP``: none was made)."""

    mesh: "NoCMesh"
    names: tuple[str, ...]
    ranks: tuple[int, ...]
    coord: int
    group: Any = _NO_GROUP

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def grouped(self) -> bool:
        """Whether the reductions and the all-gather can run over it."""
        return self.group is not _NO_GROUP


class NoCMesh:
    """The ranks of the default process group that play NoC nodes, shaped by
    named axes (the counterpart of ``jax.sharding.Mesh``).  ``group`` is the
    process group of exactly those ranks (None: the default group);
    ``node`` is this rank's node id, -1 when it is not on the mesh."""

    def __init__(self, axis_names: Sequence[str], shape: Sequence[int],
                 ranks: Sequence[int], group=None):
        if math.prod(shape) != len(ranks):
            raise ValueError(f"mesh shape {tuple(shape)} does not hold {len(ranks)} ranks")
        self.axis_names = tuple(axis_names)
        self.shape = tuple(shape)
        self.ranks = tuple(ranks)
        self.group = group
        self.rank = dist.get_rank()
        self.node = self.ranks.index(self.rank) if self.rank in self.ranks else -1
        self.backend = str(dist.get_backend())
        self.stats = TransportStats()
        self._axes: dict[tuple[str, ...], MeshAxis] = {}
        # sorted ranks of an axis row -> the row's process group
        self._row_groups: dict[tuple[int, ...], Any] = {}

    def rows(self, names: Sequence[str]) -> list[tuple[int, ...]]:
        """Every row of the axes ``names``: the ranks that share their
        coordinates on the other axes, in mesh order, rows in mesh order."""
        dims = [self.axis_names.index(a) for a in names]
        rest = [d for d in range(len(self.shape)) if d not in dims]
        rows = []
        for fixed in itertools.product(*(range(self.shape[d]) for d in rest)):
            row = []
            for node in range(self.size):
                c = self._coords(node)
                if all(c[d] == f for d, f in zip(rest, fixed)):
                    row.append(self.ranks[node])
            rows.append(tuple(row))
        return rows

    def make_axis_groups(self) -> None:
        """A process group for each row of each non-empty set of the mesh's
        axes (rows of one rank need none, a row of every node is the mesh's
        own group, rows of the same ranks share one).  Collective: every rank
        of the default group calls it at the same point, and makes the
        groups in the same order."""
        names = self.axis_names
        for k in range(1, len(names) + 1):
            for subset in itertools.combinations(names, k):
                for row in self.rows(subset):
                    key = tuple(sorted(row))
                    if len(row) > 1 and set(row) != set(self.ranks) and key not in self._row_groups:
                        self._row_groups[key] = dist.new_group(list(row))

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def stages_cuda(self) -> bool:
        """CUDA tensors go through the host: the backend has no CUDA transport."""
        return "nccl" not in self.backend

    def axis(self, names: Union[str, Sequence[str]]) -> MeshAxis:
        """This rank's :class:`MeshAxis` over ``names`` (one axis name, or a
        tuple of names linearized row-major in the order given)."""
        names = (names,) if isinstance(names, str) else tuple(names)
        ax = self._axes.get(names)
        if ax is not None:
            return ax
        if self.node < 0:
            raise RuntimeError(f"rank {self.rank} is not a node of this mesh")
        bad = [a for a in names if a not in self.axis_names]
        if bad or len(set(names)) != len(names):
            raise ValueError(f"axes {names} are not distinct axes of the mesh {self.axis_names}")
        dims = [self.axis_names.index(a) for a in names]
        me = self._coords(self.node)
        ranks, coord = [], -1
        for pos in itertools.product(*(range(self.shape[d]) for d in dims)):
            c = list(me)
            for d, p in zip(dims, pos):
                c[d] = p
            node = self._node(c)
            if node == self.node:
                coord = len(ranks)
            ranks.append(self.ranks[node])
        ranks = tuple(ranks)
        if set(ranks) == set(self.ranks):
            group = self.group
        else:
            group = self._row_groups.get(tuple(sorted(ranks)), _NO_GROUP)
        ax = self._axes[names] = MeshAxis(self, names, ranks, coord, group)
        return ax

    def _coords(self, node: int) -> list[int]:
        out = []
        for s in reversed(self.shape):
            out.append(node % s)
            node //= s
        return out[::-1]

    def _node(self, coords: Sequence[int]) -> int:
        node = 0
        for c, s in zip(coords, self.shape):
            node = node * s + c
        return node

    # -- the wire: byte views, staged through the host where the backend reads it
    def _to_wire(self, b: torch.Tensor) -> torch.Tensor:
        if b.is_cuda and self.stages_cuda:
            b = self._stage(b, torch.device("cpu"))
        return b

    def _from_wire(self, b: torch.Tensor, device: torch.device) -> torch.Tensor:
        return b if b.device == device else self._stage(b, device)

    def _stage(self, b: torch.Tensor, device: torch.device) -> torch.Tensor:
        t0 = time.perf_counter()
        out = b.to(device)
        self.stats.staging_seconds += time.perf_counter() - t0
        self.stats.staged_bytes += b.numel()
        return out

    def _wire_device(self, device: torch.device) -> torch.device:
        return torch.device("cpu") if device.type == "cuda" and self.stages_cuda else device

    def gather_nodes(self, row: torch.Tensor) -> torch.Tensor:
        """Every node's ``row`` stacked in node order, ``(n, *row.shape)``, on
        every rank of the default group (ranks off the mesh pass any row of
        the same shape and dtype)."""
        return _gather_nodes(row, self)

    def _count(self, t0: float) -> None:
        self.stats.calls += 1
        self.stats.seconds += time.perf_counter() - t0


def make_mesh(axes: Sequence[tuple[str, int]], ranks: Sequence[int],
              axis_groups: bool = False) -> NoCMesh:
    """A :class:`NoCMesh` of ``axes`` ((name, size) pairs) over the first
    ``prod(sizes)`` of ``ranks``, with the process group of exactly those
    ranks, and with ``axis_groups`` a group for each row of each set of its
    axes (:meth:`NoCMesh.make_axis_groups`).  Every rank of the default group
    calls it at the same point (a new group is collective); under NCCL the
    mesh's ranks meet at a barrier, so each communicator is created with all
    of them present."""
    shape = tuple(s for _, s in axes)
    ranks = tuple(ranks)[:math.prod(shape)]
    group = None
    if ranks != tuple(range(dist.get_world_size())):
        group = dist.new_group(list(ranks))
    mesh = NoCMesh(tuple(a for a, _ in axes), shape, ranks, group)
    if axis_groups:
        mesh.make_axis_groups()
    if not mesh.stages_cuda and mesh.node >= 0:
        dist.barrier(group=group, device_ids=[torch.cuda.current_device()])
    return mesh


@_counted("all-gather")
def _gather_nodes(row: torch.Tensor, mesh: NoCMesh) -> torch.Tensor:
    t0 = time.perf_counter()
    wire = mesh._to_wire(_bytes(row))
    bufs = [torch.empty_like(wire) for _ in range(dist.get_world_size())]
    dist.all_gather(bufs, wire)
    out = mesh._from_wire(torch.stack([bufs[r] for r in mesh.ranks]), row.device)
    mesh._count(t0)
    return out.view(row.dtype).reshape((mesh.size,) + tuple(row.shape))


def _bytes(x: torch.Tensor) -> torch.Tensor:
    """The bytes of ``x`` in memory order, as a flat uint8 view."""
    return x.contiguous().reshape(-1).view(torch.uint8)


@_counted("collective-permute")
def ppermute(x: torch.Tensor, axis: MeshAxis, perm: Sequence[tuple[int, int]]) -> torch.Tensor:
    """``lax.ppermute(x, axis, perm)`` for this rank: send ``x`` to ``d`` for
    each pair ``(coord, d)``, return what arrives from ``s`` for the pair
    ``(s, coord)``, zeros when no pair ends here.  ``perm`` is in axis
    coordinates and has distinct sources and distinct destinations."""
    mesh, c = axis.mesh, axis.coord
    t0 = time.perf_counter()
    xb = _bytes(x)
    out, ops, wire, rbuf = None, [], None, None
    for s, d in perm:
        if s == c and d == c:
            out = xb.clone()
        elif s == c:
            wire = mesh._to_wire(xb) if wire is None else wire
            ops.append(dist.P2POp(dist.isend, wire, axis.ranks[d], mesh.group))
        elif d == c:
            rbuf = torch.empty_like(xb, device=mesh._wire_device(xb.device))
            ops.append(dist.P2POp(dist.irecv, rbuf, axis.ranks[s], mesh.group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    if rbuf is not None:
        out = mesh._from_wire(rbuf, xb.device)
    elif out is None:
        out = torch.zeros_like(xb)
    mesh._count(t0)
    return out.view(x.dtype).reshape(x.shape)


def _group_order(axis: MeshAxis) -> tuple[Any, list[int]]:
    """The axis's process group, and for each of its group ranks the axis
    coordinate of that rank.  Raises for an axis that has no group."""
    if axis.group is _NO_GROUP:
        raise ValueError(f"a collective over {axis.names} needs an axis that holds every "
                         f"node of the mesh, or a mesh made with axis_groups=True")
    group_ranks = dist.get_process_group_ranks(
        axis.group if axis.group is not None else dist.group.WORLD)
    return axis.group, [axis.ranks.index(r) for r in group_ranks]


@_counted("all-to-all")
def all_to_all(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """``lax.all_to_all(x, axis, split_axis=0, concat_axis=0)``: ``x[d]`` goes
    to node ``d`` of the axis; returns ``out[s]``, what node ``s`` sent here."""
    if x.shape[0] != axis.size:
        raise ValueError(f"all_to_all over {axis.size} nodes got {x.shape[0]} rows")
    if axis.size == 1:
        return x.clone()
    group, order = _group_order(axis)
    mesh = axis.mesh
    t0 = time.perf_counter()
    ident = order == list(range(axis.size))
    src = x if ident else x[order]                 # rows in group-rank order
    wire = mesh._to_wire(_bytes(src))
    recv = torch.empty_like(wire)
    dist.all_to_all_single(recv, wire, group=group)
    out = mesh._from_wire(recv, x.device).view(x.dtype).reshape(x.shape)
    if not ident:
        out = out[torch.as_tensor(order, device=out.device).argsort()]
    mesh._count(t0)
    return out


@_counted("all-gather")
def all_gather(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """``lax.all_gather(x, axis)``: every node's ``x`` stacked in axis order,
    ``(axis.size, *x.shape)``, on every rank of the row."""
    if axis.size == 1:
        return x.unsqueeze(0)
    group, order = _group_order(axis)
    mesh = axis.mesh
    t0 = time.perf_counter()
    wire = mesh._to_wire(_bytes(x))
    bufs = [torch.empty_like(wire) for _ in range(axis.size)]
    dist.all_gather(bufs, wire, group=group)
    by_coord = [None] * axis.size
    for buf, c in zip(bufs, order):
        by_coord[c] = buf
    out = mesh._from_wire(torch.stack(by_coord), x.device)
    mesh._count(t0)
    return out.view(x.dtype).reshape((axis.size,) + tuple(x.shape))


@_counted("all-reduce")
def psum(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """``lax.psum(x, axis)``: the row's tensors added in axis order; a
    bf16/fp16 sum accumulates in float32 and rounds once."""
    if axis.size == 1:
        return x
    parts = all_gather(x, axis)
    wide = parts.is_floating_point() and parts.element_size() < 4
    if wide:
        parts = parts.float()
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out.to(x.dtype) if wide else out


@_counted("all-reduce")
def pmean(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """``lax.pmean(x, axis)``: :func:`psum` over the axis's size."""
    return x if axis.size == 1 else psum(x, axis) / axis.size


@_counted("all-reduce")
def pmax(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """``lax.pmax(x, axis)``: the row's elementwise maximum."""
    return x if axis.size == 1 else all_gather(x, axis).amax(0)


# -- autograd through the axis collectives ------------------------------------------

def gather_blocks(x: torch.Tensor, axis: MeshAxis, dim: int) -> torch.Tensor:
    """The row's blocks ``x`` concatenated along ``dim`` in axis order (one
    :func:`all_gather`; moves bytes, no gradient)."""
    return torch.cat(all_gather(x.contiguous(), axis).unbind(0), dim)


def own_block(x: torch.Tensor, axis: MeshAxis, dim: int) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` on ``axis`` (a view)."""
    n = x.shape[dim] // axis.size
    return x.narrow(dim, axis.coord * n, n)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return psum(g.contiguous(), ctx.axis), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return psum(x.contiguous(), axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return gather_blocks(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return own_block(g, ctx.axis, ctx.dim), None, None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return own_block(x, axis, dim).clone()

    @staticmethod
    def backward(ctx, g):
        return gather_blocks(g, ctx.axis, ctx.dim), None, None


class _MeanFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, grad_scale):
        ctx.grad_scale = grad_scale
        return pmean(x.contiguous(), axis)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.grad_scale, None, None


def _trivial(axis: Optional[MeshAxis]) -> bool:
    return axis is None or axis.size == 1


def copy_to(x: torch.Tensor, axis: Optional[MeshAxis]) -> torch.Tensor:
    """Identity forward, psum over ``axis`` backward: a replicated tensor
    entering a computation each rank of the axis does a part of."""
    return x if _trivial(axis) else _CopyTo.apply(x, axis)


def reduce_from(x: torch.Tensor, axis: Optional[MeshAxis]) -> torch.Tensor:
    """psum over ``axis`` forward (:func:`psum`), identity backward: the
    ranks' parts added into a replicated tensor."""
    return x if _trivial(axis) else _ReduceFrom.apply(x, axis)


def gather_from(x: torch.Tensor, axis: Optional[MeshAxis], dim: int) -> torch.Tensor:
    """The ranks' blocks concatenated along ``dim`` in axis order forward,
    this rank's block of the cotangent backward."""
    return x if _trivial(axis) else _GatherFrom.apply(x, axis, dim)


def scatter_to(x: torch.Tensor, axis: Optional[MeshAxis], dim: int) -> torch.Tensor:
    """This rank's block along ``dim`` forward, the blocks' cotangents
    all-gathered backward."""
    return x if _trivial(axis) else _ScatterTo.apply(x, axis, dim)


def mean_from(x: torch.Tensor, axis: Optional[MeshAxis], grad_scale: float) -> torch.Tensor:
    """pmean over ``axis`` forward, the cotangent times ``grad_scale``
    backward (see the module docstring)."""
    return x if _trivial(axis) else _MeanFrom.apply(x, axis, grad_scale)


# -- the ambient mesh -------------------------------------------------------------

_CURRENT: contextvars.ContextVar[Optional[NoCMesh]] = contextvars.ContextVar(
    "repro_torch_current_mesh", default=None)


def current_mesh() -> Optional[NoCMesh]:
    """The mesh entered by the innermost :func:`use_mesh`, or None."""
    return _CURRENT.get()


@contextlib.contextmanager
def use_mesh(mesh: Optional[NoCMesh]) -> Iterator[Optional[NoCMesh]]:
    """Enter ``mesh`` as the ambient mesh for the block (None: no mesh)."""
    token = _CURRENT.set(mesh)
    try:
        yield mesh
    finally:
        _CURRENT.reset(token)
