"""Parameter machinery and the basic layers of the whisper serve path
(counterpart of ``repro/models/layers.py``).

Params are plain nested dicts of tensors, shaped exactly as the reference's
pytree, so a converted reference tree and one made here have the same keys and
shapes.  The abstract spec tree (`ParamSpec` leaves) built by each model's
``abstract_params`` is the one source of shapes, dtypes and init rules.
``rope``, ``swiglu``, ``layer_norm`` and ``cross_entropy`` arrive with the
dense family and training.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[Optional[str], ...]      # logical sharding axes, kept for the mesh slice
    dtype: Any = torch.float32
    init: str = "fan_in"        # fan_in | zeros | ones | embed | small
    scale: float = 1.0

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ in rank")


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def spec_tree_map(fn, tree):
    """Apply ``fn`` to every `ParamSpec` of a nested dict."""
    if is_spec(tree):
        return fn(tree)
    return {k: spec_tree_map(fn, v) for k, v in tree.items()}


def spec_leaves(tree) -> list[ParamSpec]:
    """The specs of a nested dict, in sorted-key order (the reference's
    pytree flattening order)."""
    if is_spec(tree):
        return [tree]
    return [s for k in sorted(tree) for s in spec_leaves(tree[k])]


def init_param(gen: torch.Generator, spec: ParamSpec, device) -> torch.Tensor:
    """One leaf, by the reference's init rules (``layers.py:43-57``)."""
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    normal = torch.randn(spec.shape, generator=gen, device=device, dtype=torch.float32)
    if spec.init == "embed":
        return (normal * spec.scale).to(spec.dtype)
    if spec.init == "small":
        return (normal * (0.02 * spec.scale)).to(spec.dtype)
    # fan_in
    fan_in = spec.shape[0] if len(spec.shape) >= 2 else max(spec.shape[0], 1)
    if len(spec.shape) >= 3:  # stacked/layered weights: fan-in is the middle dim
        fan_in = spec.shape[-2]
    std = spec.scale / math.sqrt(max(fan_in, 1))
    return (normal * std).to(spec.dtype)


def init_params(spec_tree, gen: torch.Generator, device=None):
    """Materialize a spec tree, drawing every leaf from ``gen`` in sorted-key
    order; ``device`` defaults to the generator's."""
    device = gen.device if device is None else device
    if is_spec(spec_tree):
        return init_param(gen, spec_tree, device)
    return {k: init_params(spec_tree[k], gen, device) for k in sorted(spec_tree)}


def count_params(spec_tree) -> int:
    return sum(math.prod(s.shape) for s in spec_leaves(spec_tree))


def stack_specs(spec_tree, n: int):
    """Prepend a layers axis to every ParamSpec in the tree."""
    return spec_tree_map(
        lambda s: ParamSpec((n,) + s.shape, ("layers",) + s.axes, s.dtype, s.init, s.scale),
        spec_tree)


# ---------------------------------------------------------------------------
# basic ops
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Normalize in float32, cast back to x's dtype, then scale (the
    reference's cast order)."""
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * gamma


def mlp_specs(d: int, ff: int, dtype, gated: bool = True) -> dict:
    sp = {
        "up": ParamSpec((d, ff), ("embed", "mlp"), dtype),
        "down": ParamSpec((ff, d), ("mlp", "embed"), dtype),
    }
    if gated:
        sp["gate"] = ParamSpec((d, ff), ("embed", "mlp"), dtype)
    return sp


def mlp_apply(params: dict, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """Plain two-layer MLP; GELU is the tanh approximation, as
    ``jax.nn.gelu(approximate=True)``."""
    if "gate" in params:
        raise NotImplementedError("gated MLPs (swiglu) arrive with the dense family")
    h = x @ params["up"].to(x.dtype)
    h = F.silu(h) if act == "silu" else F.gelu(h, approximate="tanh")
    return h @ params["down"].to(x.dtype)
