"""Collectives of device-mesh execution over ``torch.distributed``: the port's
counterparts of ``lax.ppermute``, ``lax.all_to_all`` and the assembled output
of a ``shard_map``.

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

Transport semantics
-------------------
* :func:`ppermute` (``lax.ppermute``): one ``dist.batch_isend_irecv`` of the
  pairs that touch this rank, waited on before it returns, so two moves
  between the same pair of ranks are never in flight together (on a 2-wide
  axis the forward and backward neighbours coincide).  A rank that is the
  destination of no pair receives zeros, as under ``ppermute``; a self pair
  is a local copy.
* :func:`all_to_all` (``lax.all_to_all`` with split and concat axis 0):
  ``dist.all_to_all_single`` over an axis that spans the mesh.
* :meth:`NoCMesh.gather_nodes` (a ``shard_map`` output assembled):
  ``dist.all_gather`` over the default group, so every rank, a node of the
  mesh or not, returns the same rows.
* Every transfer moves the tensor's bytes (a uint8 view), so any dtype goes.
  gloo reads host memory: under gloo a CUDA tensor is staged through the host
  with explicit ``.cpu()`` / ``.to(device)`` around each transfer, and the
  mesh's :class:`TransportStats` count the staged bytes.  Under NCCL a CUDA
  tensor goes direct.  The transport never picks a backend: whoever
  initializes the default group does (`launch.mesh.join_process_group`).
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import time
from typing import Sequence, Union

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


@dataclasses.dataclass(frozen=True, eq=False)
class MeshAxis:
    """One rank's view of a mesh axis (``names`` linearized row-major when
    there are several): the ranks along it through this rank, in axis order,
    and this rank's coordinate among them."""

    mesh: "NoCMesh"
    names: tuple[str, ...]
    ranks: tuple[int, ...]
    coord: int

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def spans_mesh(self) -> bool:
        """The axis holds every node of the mesh in node order, so a group
        collective over the mesh's group runs along it."""
        return self.ranks == self.mesh.ranks


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
        ax = self._axes[names] = MeshAxis(self, names, tuple(ranks), coord)
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
        t0 = time.perf_counter()
        wire = self._to_wire(_bytes(row))
        bufs = [torch.empty_like(wire) for _ in range(dist.get_world_size())]
        dist.all_gather(bufs, wire)
        out = self._from_wire(torch.stack([bufs[r] for r in self.ranks]), row.device)
        self._count(t0)
        return out.view(row.dtype).reshape((self.size,) + tuple(row.shape))

    def _count(self, t0: float) -> None:
        self.stats.calls += 1
        self.stats.seconds += time.perf_counter() - t0


def make_mesh(axes: Sequence[tuple[str, int]], ranks: Sequence[int]) -> NoCMesh:
    """A :class:`NoCMesh` of ``axes`` ((name, size) pairs) over the first
    ``prod(sizes)`` of ``ranks``, with the process group of exactly those
    ranks.  Every rank of the default group calls it at the same point (a
    new group is collective); under NCCL the mesh's ranks meet at a barrier,
    so each communicator is created with all of them present."""
    shape = tuple(s for _, s in axes)
    ranks = tuple(ranks)[:math.prod(shape)]
    group = None
    if ranks != tuple(range(dist.get_world_size())):
        group = dist.new_group(list(ranks))
    mesh = NoCMesh(tuple(a for a, _ in axes), shape, ranks, group)
    if not mesh.stages_cuda and mesh.node >= 0:
        dist.barrier(group=group, device_ids=[torch.cuda.current_device()])
    return mesh


def _bytes(x: torch.Tensor) -> torch.Tensor:
    """The bytes of ``x`` in memory order, as a flat uint8 view."""
    return x.contiguous().reshape(-1).view(torch.uint8)


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


def all_to_all(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """``lax.all_to_all(x, axis, split_axis=0, concat_axis=0)``: ``x[d]`` goes
    to node ``d`` of the axis; returns ``out[s]``, what node ``s`` sent here."""
    if not axis.spans_mesh:
        raise ValueError(f"all_to_all over {axis.names} needs an axis that holds every "
                         f"node of the mesh in node order")
    if x.shape[0] != axis.size:
        raise ValueError(f"all_to_all over {axis.size} nodes got {x.shape[0]} rows")
    mesh = axis.mesh
    t0 = time.perf_counter()
    wire = mesh._to_wire(_bytes(x))
    recv = torch.empty_like(wire)
    dist.all_to_all_single(recv, wire, group=mesh.group)
    out = mesh._from_wire(recv, x.device)
    mesh._count(t0)
    return out.view(x.dtype).reshape(x.shape)
