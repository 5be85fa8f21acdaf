"""Joining the process group that device-mesh execution runs over (the
counterpart of ``repro.launch.mesh`` for the NoC's ``mode="spmd"``).

The reference builds a ``jax.sharding.Mesh`` from the devices one controller
sees.  The port's ranks are processes: ``torchrun --nproc-per-node N`` starts
them with ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT`` in their environment, and each joins the default group here
with a backend named by the caller; `core.partition.mesh_for_topology` then
lays the NoC's nodes over its first ranks.
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from .._device import resolve_device


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
