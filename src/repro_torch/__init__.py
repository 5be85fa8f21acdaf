"""PyTorch/CUDA port of ``repro``: the task-graph → NoC mapping framework and
its three case studies (GF(2) BMVM, LDPC min-sum, particle filter), with the
compute kernels written by hand in CUDA C++ for Hopper (``sm_90a``).

The layout mirrors ``repro``: ``repro.X.Y`` maps to ``repro_torch.X.Y``
(``core``, ``apps``, ``analysis``, ``telemetry``, ``kernels``, ``models``,
``configs``, ``launch``).  The
port imports neither ``jax`` nor ``repro``.  Entry points run on the GPU
(``device="cuda"``) unless the caller passes ``device="cpu"``; with no GPU they
raise instead of falling back.
"""
from ._device import resolve_device

__all__ = ["resolve_device"]
