"""The training step (counterpart of ``repro/launch/steps.py``
``make_train_step``), eager PyTorch on one device.

``value_and_grad`` of ``T.loss`` is ``torch.autograd.grad`` over the param
leaves; the update is `optim.adamw_update` under `optim.cosine_schedule`,
with the learning rate read at the optimizer's step *before* the update, as
the reference reads it (so the first update of a warmup has lr 0).  The
reference's mesh helpers and its ``jit_*`` lowering for the dry run wait for
the mesh slice, and so does ``pod_sync="serdes"``.
"""
from __future__ import annotations

import torch

from .._tree import leaves, unflatten
from ..configs.base import ModelConfig
from ..models import transformer as T
from ..optim import AdamWConfig, adamw_update, cosine_schedule


def loss_and_grads(params, batch: dict, cfg: ModelConfig):
    """-> (loss, metrics, grads): ``jax.value_and_grad(T.loss, has_aux=True)``.
    A leaf the loss does not reach gets a zero gradient, as in JAX."""
    flat = leaves(params)
    with torch.enable_grad():
        req = [p.detach().requires_grad_() for p in flat]
        loss, mets = T.loss(unflatten(params, req), batch, cfg)
        grads = torch.autograd.grad(loss, req, allow_unused=True, materialize_grads=True)
    return loss.detach(), {k: v.detach() for k, v in mets.items()}, unflatten(params, grads)


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, *, pod_sync: str = "auto",
                    total_steps: int = 10_000, warmup: int = 200):
    """-> ``train_step(state, batch) -> (state, metrics)`` with ``state =
    {"params", "opt"}`` and ``batch`` a dict of tensors on the params' device
    (``tokens``, ``labels``; ``frames`` for an encdec model).  The metrics are
    ``loss``, ``nll``, ``aux``, ``moe_drops``, ``moe_peak_occupancy`` and
    ``grad_norm``, 0-d tensors.  The state's tensors are updated in place."""
    if pod_sync == "serdes":
        raise NotImplementedError("pod_sync='serdes' (the cross-pod gradient exchange over "
                                  "quasi-SERDES links, serdes.send_over_link of ROADMAP "
                                  "item 7) waits for the mesh half of the LM stack, "
                                  "ROADMAP item 8(e)")
    if pod_sync != "auto":
        raise ValueError(f"pod_sync must be 'auto' or 'serdes', got {pod_sync!r}")

    def lr_of(step):
        return cosine_schedule(step, peak_lr=opt_cfg.lr, warmup=warmup, total=total_steps)

    def train_step(state, batch):
        params, opt_state = state["params"], state["opt"]
        loss, mets, grads = loss_and_grads(params, batch, cfg)
        new_params, new_opt, om = adamw_update(params, grads, opt_state, opt_cfg,
                                               lr=lr_of(opt_state["step"]))
        mets = dict(mets, loss=loss, **om)
        return {"params": new_params, "opt": new_opt}, mets

    return train_step
