"""LR schedules as functions of the step counter (counterpart of
``repro/optim/schedule.py``), computed in float32 on the counter's device."""
from __future__ import annotations

import math

import torch


def cosine_schedule(step, *, peak_lr: float, warmup: int, total: int,
                    floor_frac: float = 0.1) -> torch.Tensor:
    """Linear warmup to ``peak_lr``, then a cosine down to ``floor_frac`` of
    it; a 0-d float32 tensor, in the reference's operation order."""
    s = step.float() if isinstance(step, torch.Tensor) else torch.tensor(float(step))
    warm = peak_lr * torch.clamp(s / max(warmup, 1), max=1.0)
    t = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak_lr * (floor_frac + (1 - floor_frac) * 0.5 * (1 + torch.cos(math.pi * t)))
    return torch.where(s < warmup, warm, cos)
