"""The training step and the mesh helpers of the trainer and the server
(counterpart of ``repro/launch/steps.py``), in eager PyTorch.

``value_and_grad`` of ``T.loss`` is ``torch.autograd.grad`` over the param
leaves; the update is `optim.adamw_update` under `optim.cosine_schedule`,
with the learning rate read at the optimizer's step *before* the update, as
the reference reads it (so the first update of a warmup has lr 0).

On a mesh (`launch.mesh.make_host_mesh`) every rank runs the same step on
the same global batch with its blocks of the params and of AdamW's ``m`` and
``v`` (:func:`shardings_for_params`): the forward splits the batch over the
data axes (:func:`batch_shardings`'s rule) and the weights over the model
axis, the gradients are averaged over the data axes, and the global grad
norm adds each sharded leaf's squares over the axes it is split on.  The
helpers return specs and ``meta`` tensors where the reference returns
``NamedSharding``\\ s and ``ShapeDtypeStruct``\\ s.  The ``jit_*`` lowering
of the dry run waits for ROADMAP item 8(e) part 5, and ``pod_sync="serdes"``
for part 3.
"""
from __future__ import annotations

import math

import torch

from .._tree import leaves, tree_map, unflatten
from ..configs.base import ModelConfig
from ..core import collectives as coll
from ..core.partition import DEFAULT_RULES, Spec, mesh_shape, spec_leaves
from ..models import transformer as T
from ..models.layers import param_pspecs, param_shapes
from ..optim import AdamWConfig, adamw_update, cosine_schedule


def batch_pspec(mesh) -> Spec:
    """The spec of a batch's leading dim: the mesh's ``pod``/``data`` axes
    (one axis by its name, as ``PartitionSpec`` normalizes it)."""
    axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    return (axes[0] if len(axes) == 1 else (axes or None),)


def shardings_for_params(cfg: ModelConfig, mesh):
    """The spec of every param leaf on ``mesh`` (the block each rank holds):
    the reference's ``NamedSharding`` tree, as specs on the caller's mesh."""
    return param_pspecs(T.abstract_params(cfg), DEFAULT_RULES, mesh.axis_names,
                        mesh_shape(mesh))


def state_shardings(cfg: ModelConfig, mesh) -> dict:
    """The specs of a train state: AdamW's ``m`` and ``v`` follow the
    params' blocks, ``step`` is replicated (the reference's ``state_sh``)."""
    psh = shardings_for_params(cfg, mesh)
    return {"params": psh, "opt": {"m": psh, "v": psh, "step": ()}}


def batch_shardings(batch_specs: dict, mesh, global_batch: int) -> dict:
    """Per batch leaf (a tensor, or a ``meta`` one): its leading dim split
    over the batch axes when it is the global batch and they divide it, else
    replicated.  ``global_batch`` stands for the reference's
    ``ShapeConfig.global_batch``."""
    bp = batch_pspec(mesh)
    names = (bp[0],) if isinstance(bp[0], str) else (bp[0] or ())
    n_batch = math.prod(mesh_shape(mesh)[a] for a in names)

    def of(v):
        if v.dim() >= 2 and v.shape[0] == global_batch and global_batch % max(n_batch, 1) == 0:
            return (bp[0],) + (None,) * (v.dim() - 1)
        return ()

    return {k: of(v) for k, v in batch_specs.items()}


def cache_struct(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """The decode cache's global shapes, as ``meta`` tensors."""
    with coll.use_mesh(None):
        return T.init_cache(cfg, batch, max_len, device="meta")


def serve_param_shapes(cfg: ModelConfig):
    """Every param as a ``meta`` tensor, bf16 when the config serves bf16
    params."""
    shp = param_shapes(T.abstract_params(cfg))
    if cfg.serve_param_dtype == "bfloat16":
        shp = tree_map(lambda t: t.to(torch.bfloat16), shp)
    return shp


def global_norm(grads, specs=None, mesh=None) -> torch.Tensor:
    """The global L2 norm of ``grads``.  On a mesh, the squares of each leaf
    sharded over some axes are added over those axes (one psum per set of
    axes) and a replicated leaf counts once, so every rank gets the norm of
    the whole gradient."""
    if mesh is None:
        return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves(grads)))
    groups: dict[tuple, torch.Tensor] = {}
    for g, spec in zip(leaves(grads), spec_leaves(specs)):
        names = {a for e in spec if e for a in ((e,) if isinstance(e, str) else e)}
        axes = tuple(a for a in mesh.axis_names if a in names)
        sq = torch.sum(torch.square(g.float()))
        groups[axes] = groups[axes] + sq if axes in groups else sq
    total = sum(coll.psum(v, mesh.axis(axes)) if axes else v for axes, v in groups.items())
    return torch.sqrt(total)


def loss_and_grads(params, batch: dict, cfg: ModelConfig):
    """-> (loss, metrics, grads): ``jax.value_and_grad(T.loss, has_aux=True)``.
    A leaf the loss does not reach gets a zero gradient, as in JAX.  Under a
    mesh the grads are the rank's blocks, from the rank's batch rows."""
    flat = leaves(params)
    with torch.enable_grad():
        req = [p.detach().requires_grad_() for p in flat]
        loss, mets = T.loss(unflatten(params, req), batch, cfg)
        grads = torch.autograd.grad(loss, req, allow_unused=True, materialize_grads=True)
    return loss.detach(), {k: v.detach() for k, v in mets.items()}, unflatten(params, grads)


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, *, mesh=None,
                    pod_sync: str = "auto", total_steps: int = 10_000, warmup: int = 200):
    """-> ``train_step(state, batch) -> (state, metrics)`` with ``state =
    {"params", "opt"}`` and ``batch`` a dict of tensors on the params' device
    (``tokens``, ``labels``; ``frames`` for an encdec model).  The metrics are
    ``loss``, ``nll``, ``aux``, ``moe_drops``, ``moe_peak_occupancy`` and
    ``grad_norm``, 0-d tensors.  The state's tensors are updated in place.

    ``mesh``: the step runs on it (every rank of it calls the step on the
    whole batch, with the state's blocks of :func:`state_shardings`); the
    gradients are averaged over the data axes that split the batch, and the
    metrics are the whole batch's on every rank.  None: the ambient mesh at
    each call, or one device."""
    if pod_sync == "serdes":
        raise NotImplementedError("pod_sync='serdes' (the cross-pod gradient exchange over "
                                  "quasi-SERDES links, serdes.send_over_link of ROADMAP "
                                  "item 7) waits for ROADMAP item 8(e) part 3")
    if pod_sync != "auto":
        raise ValueError(f"pod_sync must be 'auto' or 'serdes', got {pod_sync!r}")

    def lr_of(step):
        return cosine_schedule(step, peak_lr=opt_cfg.lr, warmup=warmup, total=total_steps)

    specs = shardings_for_params(cfg, mesh) if mesh is not None else None

    def train_step(state, batch):
        m = mesh if mesh is not None else coll.current_mesh()
        sp = specs if m is mesh or m is None else shardings_for_params(cfg, m)
        params, opt_state = state["params"], state["opt"]
        with coll.use_mesh(m):
            loss, mets, grads = loss_and_grads(params, batch, cfg)
            bax = T.batch_axis(m, batch["tokens"].shape[0])
            if bax is not None:
                grads = unflatten(grads, [coll.pmean(g, bax) for g in leaves(grads)])
            gnorm = global_norm(grads, sp, m)
        new_params, new_opt, om = adamw_update(params, grads, opt_state, opt_cfg,
                                               lr=lr_of(opt_state["step"]), gnorm=gnorm)
        mets = dict(mets, loss=loss, **om)
        return {"params": new_params, "opt": new_opt}, mets

    return train_step
