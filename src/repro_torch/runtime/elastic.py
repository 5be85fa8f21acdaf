"""Elastic scaling: rebuild the mesh when the pool of ranks changes and
reshard the state onto it (counterpart of ``repro/runtime/elastic.py``).

A job that loses ranks restarts on the survivors: :func:`factor_mesh` picks
the new ``(pod, data, model)`` factoring from their count (the model axis
kept where it can be: resharding params over a changed model axis is the
expensive case), :func:`make_mesh_from_devices` lays it over their ranks,
:func:`remesh_plan` maps the params' specs onto the new mesh, and
``CheckpointManager.restore(shardings=...)`` cuts each saved leaf to the
rank's block there.
"""
from __future__ import annotations

import math
from typing import Sequence

from ..core.collectives import NoCMesh, make_mesh
from ..core.partition import DEFAULT_RULES, NamedSharding, mesh_shape


def factor_mesh(n_devices: int, prefer_model: int = 0,
                multi_pod: bool = False) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """Choose a mesh shape for the surviving ranks.

    Keeps the model axis at ``prefer_model`` when it divides ``n_devices``
    (params need no cross-axis reshuffle), else the largest power-of-two
    divisor <= floor(sqrt(n)); ``multi_pod`` splits an even remainder into
    two pods."""
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    if prefer_model and n_devices % prefer_model == 0:
        model = prefer_model
    else:
        model = 1
        while model * 2 <= math.isqrt(n_devices) and n_devices % (model * 2) == 0:
            model *= 2
    rest = n_devices // model
    if multi_pod and rest % 2 == 0:
        return (2, rest // 2, model), ("pod", "data", "model")
    return (rest, model), ("data", "model")


def make_mesh_from_devices(ranks: Sequence[int], shape, axes) -> NoCMesh:
    """A mesh of ``axes`` of ``shape`` over the first ``prod(shape)`` of
    ``ranks``, with a process group for each of its rows
    (`collectives.make_mesh(..., axis_groups=True)`).  Collective: every rank
    of the default group calls it."""
    return make_mesh(tuple(zip(axes, shape)), tuple(ranks)[:math.prod(shape)],
                     axis_groups=True)


def remesh_plan(spec_tree, new_mesh, rules=None):
    """The params' `models.layers.ParamSpec` tree -> a `NamedSharding` of
    each leaf on ``new_mesh`` (any object with ``axis_names`` and ``shape``
    gives the specs)."""
    from ..models.layers import param_pspecs

    pspecs = param_pspecs(spec_tree, rules or DEFAULT_RULES, new_mesh.axis_names,
                          mesh_shape(new_mesh))
    return _bind(pspecs, new_mesh)


def _bind(pspecs, mesh):
    if isinstance(pspecs, dict):
        return {k: _bind(v, mesh) for k, v in pspecs.items()}
    return NamedSharding(mesh, pspecs)
