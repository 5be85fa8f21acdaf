"""Parameter machinery and the basic layers shared by the ported
architectures (counterpart of ``repro/models/layers.py``).

Params are plain nested dicts of tensors, shaped exactly as the reference's
pytree, so a converted reference tree and one made here have the same keys and
shapes.  The abstract spec tree (`ParamSpec` leaves) built by each model's
``abstract_params`` is the one source of shapes, dtypes and init rules.
Each op keeps the reference's casts: norms, RoPE angles and the
cross-entropy's log-sum-exp are computed in float32.

On a mesh (`launch.mesh`), each rank holds the block of every leaf that
:func:`param_pspecs` gives it (:func:`shard_params` cuts a whole tree,
:func:`gather_params` puts it back together), :func:`mlp_apply` runs
on the rank's ``mlp`` columns, and :func:`vocab_parallel_cross_entropy`
takes the loss over the rank's ``vocab`` columns of the logits.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F

from .._tree import leaves
from ..core.collectives import copy_to, pmax, psum, reduce_from
from ..core.partition import (DEFAULT_RULES, Parts, block, logical_to_spec, mesh_shape,
                              unblock)


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[Optional[str], ...]      # logical sharding axes, kept for the mesh slice
    dtype: Any = torch.float32
    init: str = "fan_in"        # fan_in | zeros | ones | embed | small
    scale: float = 1.0
    parts: int = 1              # the last dim holds this many tensors side by side (a
                                #   fused projection): a mesh cuts each part alone

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
    normal = torch.randn(spec.shape, generator=gen, device=gen.device,
                         dtype=torch.float32).to(device)
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


def init_params(spec_tree, gen: torch.Generator, device=None, mesh=None):
    """Materialize a spec tree, drawing every leaf from ``gen`` in sorted-key
    order on the generator's device and placing it on ``device`` (default:
    the generator's).  With a ``mesh`` each leaf is drawn whole and only the
    rank's block (:func:`param_pspecs`) is kept and placed, so the same seed
    gives every mesh the same model."""
    device = gen.device if device is None else device
    if is_spec(spec_tree):
        if mesh is None:
            return init_param(gen, spec_tree, device)
        whole = init_param(gen, spec_tree, gen.device)
        return block(whole, leaf_pspec(spec_tree, mesh), mesh).to(device, copy=True)
    return {k: init_params(spec_tree[k], gen, device, mesh) for k in sorted(spec_tree)}


def _pspec(s: ParamSpec, rules, mesh_axes, shape_of_mesh):
    spec = logical_to_spec(s.axes, rules, mesh_axes, dims=s.shape, mesh_shape=shape_of_mesh)
    if s.parts == 1 or spec[-1] is None:
        return spec
    if not isinstance(spec[-1], str):
        raise ValueError(f"a fused leaf {s.shape} is cut over one mesh axis, not {spec[-1]}")
    if shape_of_mesh is not None and (s.shape[-1] // s.parts) % shape_of_mesh[spec[-1]]:
        return spec[:-1] + (None,)      # the parts do not divide: replicated
    return spec[:-1] + (Parts(spec[-1], s.parts),)


def leaf_pspec(s: ParamSpec, mesh, rules=DEFAULT_RULES):
    """The spec of the block of leaf ``s`` that this rank of ``mesh`` holds."""
    return _pspec(s, rules, mesh.axis_names, mesh_shape(mesh))


def param_pspecs(spec_tree, rules=DEFAULT_RULES, mesh_axes=None, mesh_shape=None):
    """The spec (`core.partition.logical_to_spec`) of every leaf: the block a
    rank of a mesh with ``mesh_axes`` of ``mesh_shape`` holds.  A fused leaf
    (``parts`` > 1) has a `core.partition.Parts` entry for its last dim."""
    return spec_tree_map(lambda s: _pspec(s, rules, mesh_axes, mesh_shape), spec_tree)


def param_shapes(spec_tree):
    """Every leaf as a tensor on the ``meta`` device (shape and dtype, no
    storage): the counterpart of ``jax.ShapeDtypeStruct``."""
    return spec_tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta"),
                         spec_tree)


def _zip_map(fn, params, specs):
    if isinstance(params, dict):
        return {k: _zip_map(fn, params[k], specs[k]) for k in params}
    return fn(params, specs)


def shard_params(params, spec_tree, mesh):
    """Each whole leaf of ``params`` cut to this rank's block of ``mesh``
    under the matching spec of ``spec_tree`` (a `param_pspecs` tree), copied
    so the whole leaves can be freed.  The expert leaves' ``experts`` rule
    cuts the rank's block of experts that `models.moe` reads."""
    return _zip_map(lambda t, sp: block(t, sp, mesh).clone(), params, spec_tree)


def gather_params(params, spec_tree, mesh):
    """The inverse of :func:`shard_params`: every leaf whole, on every rank
    (collective: every rank of the mesh calls it)."""
    return _zip_map(lambda t, sp: unblock(t, sp, mesh), params, spec_tree)


def count_params(spec_tree) -> int:
    return sum(math.prod(s.shape) for s in leaves(spec_tree))


def stack_specs(spec_tree, n: int):
    """Prepend a layers axis to every ParamSpec in the tree."""
    return spec_tree_map(
        lambda s: dataclasses.replace(s, shape=(n,) + s.shape, axes=("layers",) + s.axes),
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


def mlp_apply(params: dict, x: torch.Tensor, act: str = "silu", axis=None) -> torch.Tensor:
    """The gated MLP when the params have a ``gate``, else the plain
    two-layer one.  ``axis``: the mesh axis the ``mlp`` dim is split over
    (None: whole): the leaves hold the rank's up/gate columns and down rows,
    x is replicated, and the rank's partial outputs are added over the axis.
    The reference's ``constrain(h, ("batch", "seq", "mlp"))`` needs nothing
    here: h already holds the rank's columns."""
    x = copy_to(x, axis)
    if "gate" in params:
        out = swiglu(x, params["gate"].to(x.dtype), params["up"].to(x.dtype),
                     params["down"].to(x.dtype), act=act)
    else:
        out = _act(x @ params["up"].to(x.dtype), act) @ params["down"].to(x.dtype)
    return reduce_from(out, axis)


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


class _VocabParallelNLL(torch.autograd.Function):
    """The NLL of each position of logits whose vocab is split over a mesh
    axis, from the rank's block alone: the row max ``pmax``'ed (no gradient),
    the float32 sums of ``exp(l - max)`` ``psum``'ed, and the gold logit
    ``psum``'ed from the one rank whose block holds the label.  The backward
    is ``softmax - onehot`` on the rank's block, with no collective."""

    @staticmethod
    def forward(ctx, block, labels, axis):
        n = block.shape[-1]
        z = block.float()
        m = pmax(z.amax(-1), axis)
        lse = psum((z - m[..., None]).exp_().sum(-1), axis).log_().add_(m)
        local = labels.clamp_min(0).long() - axis.coord * n
        mine = (local >= 0) & (local < n)
        local = local.clamp(0, n - 1)
        gold = psum(torch.gather(z, -1, local[..., None])[..., 0] * mine, axis)
        ctx.save_for_backward(block, lse, local, mine)
        return lse - gold

    @staticmethod
    def backward(ctx, g):
        block, lse, local, mine = ctx.saved_tensors
        d = (block.float() - lse[..., None]).exp_()
        d.scatter_add_(-1, local[..., None], -mine[..., None].float())
        return d.mul_(g[..., None]).to(block.dtype), None, None


def vocab_parallel_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, axis,
                                 ignore_id: int = -1) -> torch.Tensor:
    """:func:`cross_entropy` of logits whose vocab is split over ``axis``
    (a `MeshAxis`; ``logits`` (B, S, V / axis.size) the rank's block of
    columns), the same on every rank of the axis, with no rank holding a
    whole row: the reference's ``cross_entropy`` over its vocab-sharded
    logits.  The mask and the mean are :func:`cross_entropy`'s; with no
    axis, or one of one rank, it is :func:`cross_entropy` itself."""
    if axis is None or axis.size == 1:
        return cross_entropy(logits, labels, ignore_id)
    nll = _VocabParallelNLL.apply(logits, labels, axis)
    mask = (labels != ignore_id).float()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)
