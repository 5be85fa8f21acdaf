"""AdamW (counterpart of ``repro/optim/adamw.py``), in plain PyTorch.

The arithmetic is the reference's, in its order: the gradients are clipped by
their global norm, then ``m``, ``v``, the bias corrections and the decoupled
weight decay are applied as ``p - lr · (m̂ / (√v̂ + eps) + wd · p)`` in
float32.  (``torch.optim.AdamW`` decays the weights in a separate step,
``p · (1 - lr · wd)``, which rounds differently.)  The optimizer state mirrors
the param tree: ``{"m", "v"}`` in float32 and an int32 ``step``.

`adamw_update` updates the params, ``m`` and ``v`` in place and returns them
(the reference returns new arrays): at llama3.2-1b FULL each copy is 4.9 GB.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .._tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def adamw_init(params) -> dict:
    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32)
    device = leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def _global_norm(grads) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves(grads)))


def _clip_scale(gnorm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """-> (grads scaled so their global norm is at most ``max_norm``, the
    norm before clipping)."""
    gnorm = _global_norm(grads)
    scale = _clip_scale(gnorm, max_norm)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gnorm


@torch.no_grad()
def adamw_update(params, grads, state: dict, cfg: AdamWConfig,
                 lr: Optional[torch.Tensor] = None):
    """-> (params, new_state, {"grad_norm"}); params, ``m`` and ``v`` are
    updated in place."""
    gnorm = _global_norm(grads)
    scale = _clip_scale(gnorm, cfg.grad_clip)
    step = state["step"] + 1
    lr_t = cfg.lr if lr is None else lr
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state["m"]),
                          leaves(state["v"])):
        g32 = (g.float() * scale).to(g.dtype).float()
        m.mul_(cfg.b1).add_(g32 * (1 - cfg.b1))
        v.mul_(cfg.b2).add_(g32 * (1 - cfg.b2) * g32)
        delta = (m / b1c).div_((v / b2c).sqrt_().add_(cfg.eps))
        delta.add_(p.float() * cfg.weight_decay)
        p.copy_(p.float() - delta.mul_(lr_t))
    return params, {"m": state["m"], "v": state["v"], "step": step}, {"grad_norm": gnorm}
