"""Joining the process group that device-mesh execution runs over, and the
LM's ``("data", "model")`` meshes (the counterpart of ``repro.launch.mesh``).

The reference builds a ``jax.sharding.Mesh`` from the devices one controller
sees.  The port's ranks are processes: ``torchrun --nproc-per-node N`` starts
them with ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT`` in their environment, and each joins the default group here
with a backend named by the caller; `core.partition.mesh_for_topology` then
lays the NoC's nodes over its first ranks, and :func:`make_host_mesh` /
:func:`make_production_mesh` lay the LM's mesh over them, entered with
:func:`set_mesh`.  Making a mesh is collective: every rank calls it at the
same point.  :func:`add_mesh_args` and :func:`mesh_from_args` give the serve
and train CLIs ``--model-parallel`` and ``--dist-backend``.
"""
from __future__ import annotations

import datetime
import math
import os

import torch
import torch.distributed as dist

from .._device import resolve_device
from ..core.collectives import NoCMesh, make_mesh, use_mesh, world_size


def set_mesh(mesh: NoCMesh):
    """Enter ``mesh`` as the ambient mesh: ``with set_mesh(mesh): ...``
    (what the models and `models.moe.moe_apply` read)."""
    return use_mesh(mesh)


def _ranks() -> int:
    n = world_size()
    if n == 0:
        raise RuntimeError("no default process group: call join_process_group first")
    return n


def _lm_mesh(shape: tuple[int, ...], axes: tuple[str, ...]) -> NoCMesh:
    n = _ranks()
    if n < math.prod(shape):
        raise ValueError(f"number of ranks {n} must be >= the product of mesh_shape {shape}")
    return make_mesh(tuple(zip(axes, shape)), range(n), axis_groups=True)


def make_production_mesh(*, multi_pod: bool = False) -> NoCMesh:
    """16×16 = 256 ranks a pod; 2 pods = 512, over the default group's first
    ranks.  Raises when the group holds fewer."""
    if multi_pod:
        return _lm_mesh((2, 16, 16), ("pod", "data", "model"))
    return _lm_mesh((16, 16), ("data", "model"))


def make_host_mesh(model: int = 1) -> NoCMesh:
    """``("data", "model")`` of shape ``(W // model, model)`` over the default
    group's W ranks.  Raises when ``model`` does not divide W."""
    n = _ranks()
    if model < 1 or n % model:
        raise ValueError(f"model={model} does not divide the {n} ranks of the default group")
    return _lm_mesh((n // model, model), ("data", "model"))


def join_process_group(backend: str, device="cuda", timeout_s: float = 120.0) -> torch.device:
    """Join the default process group from torchrun's environment, or read it
    when the caller already initialized it, and return this rank's device.

    ``backend`` is explicit (``"gloo"``, ``"nccl"``): the transport never
    picks one (`core.collectives`).  Under gloo, CUDA tensors are staged
    through the host; NCCL needs one card per rank.  ``device="cuda"`` takes
    card ``LOCAL_RANK % device_count`` (the rank when ``LOCAL_RANK`` is unset)
    and makes it current, so ranks share the cards round-robin; ``"cpu"``
    keeps the rank on the host.  An initialized group with another backend
    raises."""
    if not dist.is_available():
        raise RuntimeError("torch.distributed is not available in this build of torch")
    if dist.is_initialized():
        have = str(dist.get_backend())
        if have != backend:
            raise RuntimeError(f"the default process group runs {have!r}, not {backend!r}")
    else:
        dist.init_process_group(backend, init_method="env://",
                                timeout=datetime.timedelta(seconds=timeout_s))
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count == 0:
            raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
        dev = torch.device("cuda", local % count)
        torch.cuda.set_device(dev)
    return resolve_device(dev)


def mesh_from_args(args, ap):
    """-> (device, mesh or None, whether this call joined the group).  More
    than one rank (torchrun's ``WORLD_SIZE``, or a group the caller joined)
    or ``--model-parallel`` above 1 needs ``--dist-backend`` and gives the
    ``(W // N, N)`` mesh of every rank; else the one device of ``--device``."""
    ready = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if ready else int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1 and args.model_parallel == 1:
        return resolve_device(args.device), None, False
    if world == 1:
        ap.error(f"--model-parallel {args.model_parallel} needs {args.model_parallel} ranks or "
                 "a multiple: start it with torchrun --nproc-per-node")
    if args.dist_backend is None:
        ap.error("more than one rank needs --dist-backend (gloo or nccl)")
    dev = join_process_group(args.dist_backend, args.device)
    return dev, make_host_mesh(model=args.model_parallel), not ready


def add_mesh_args(ap) -> None:
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="ranks on the mesh's model axis (the rest split the batch)")
    ap.add_argument("--dist-backend", choices=["gloo", "nccl"], default=None,
                    help="the process group's backend; required with more than one rank")
