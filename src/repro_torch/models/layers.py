"""Parameter machinery and the basic layers shared by the ported
architectures (counterpart of ``repro/models/layers.py``).

Params are plain nested dicts of tensors, shaped exactly as the reference's
pytree, so a converted reference tree and one made here have the same keys and
shapes.  The abstract spec tree (`ParamSpec` leaves) built by each model's
``abstract_params`` is the one source of shapes, dtypes and init rules.
Each op keeps the reference's casts: norms, RoPE angles and the
cross-entropy's log-sum-exp are computed in float32.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F

from .._tree import leaves


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
    return sum(math.prod(s.shape) for s in leaves(spec_tree))


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


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, correction=0)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype) * gamma + beta


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0,
         rope_dim: Optional[int] = None) -> torch.Tensor:
    """x: (..., S, H, D) or (..., S, D); positions: (..., S).  The angles are
    float32, and ``x1 * cos`` promotes a bf16 ``x`` to float32 before the
    cast back, as in the reference."""
    d = rope_dim or x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].float() * freqs                       # (..., S, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    while cos.ndim < x.ndim:
        cos, sin = cos[..., None, :], sin[..., None, :]               # add head axis
    x1, x2 = x[..., :half], x[..., half:d]
    rot = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return torch.cat([rot, x[..., d:].to(rot.dtype)], dim=-1).to(x.dtype)


def _act(h: torch.Tensor, act: str) -> torch.Tensor:
    """SiLU, or GELU in its tanh approximation (``jax.nn.gelu(approximate=True)``)."""
    return F.silu(h) if act == "silu" else F.gelu(h, approximate="tanh")


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """Gated MLP: SwiGLU with ``act="silu"``, GeGLU with ``"gelu"``."""
    return (_act(x @ w_gate, act) * (x @ w_up)) @ w_down


def mlp_specs(d: int, ff: int, dtype, gated: bool = True) -> dict:
    sp = {
        "up": ParamSpec((d, ff), ("embed", "mlp"), dtype),
        "down": ParamSpec((ff, d), ("mlp", "embed"), dtype),
    }
    if gated:
        sp["gate"] = ParamSpec((d, ff), ("embed", "mlp"), dtype)
    return sp


def mlp_apply(params: dict, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """The gated MLP when the params have a ``gate``, else the plain
    two-layer one."""
    if "gate" in params:
        return swiglu(x, params["gate"].to(x.dtype), params["up"].to(x.dtype),
                      params["down"].to(x.dtype), act=act)
    return _act(x @ params["up"].to(x.dtype), act) @ params["down"].to(x.dtype)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_id: int = -1) -> torch.Tensor:
    """logits (B, S, V), labels (B, S) → mean NLL over the labels that are
    not ``ignore_id``: the log-sum-exp in float32 and the reference's mean
    (sum over kept positions / max(count, 1))."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.clamp_min(0).long()[..., None])[..., 0]
    mask = (labels != ignore_id).float()
    return ((lse - gold) * mask).sum() / mask.sum().clamp_min(1.0)
