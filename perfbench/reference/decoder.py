"""A decoder-only model with grouped-query attention, RoPE and a
mixture-of-experts FFN, as the port defines Phi-3.5-MoE
(``configs/phi3.5-moe-16L.json``, its ``departures``): RMSNorm before each
sub-layer, a softmax router whose top ``k`` weights are renormalised, SwiGLU
experts, and the port's capacity rule.

The capacity rule decides which tokens an expert drops, so the reference
runs whole batches, grouped as the served batch was called: the prompts of
all requests in one call (prefill), then one call for each decode position
holding that position of every request.  In a call of T tokens each expert
keeps the first ``max(8, int(T · k · capacity_factor / E))`` packets in
arrival order (packet ``t · k + j`` is token t's j-th choice, t counting the
call's tokens request by request); a dropped packet adds nothing.  Float32,
the whole batch a layer at a time; attention in blocks of requests."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import attend, linear, rms_norm, rope, silu

BLOCK = 4        # requests an attention block


def capacity(T: int, k: int, E: int, factor: float) -> int:
    return max(1, min(max(8, int(T * k * factor / E)), T * k))


def _first(ids: torch.Tensor, E: int, cap: int) -> torch.Tensor:
    """ids (G, P) experts of P packets in arrival order, for G calls ->
    (G, P) True where the packet is among its expert's first ``cap``."""
    oh = F.one_hot(ids, E)
    rank = oh.cumsum(1).gather(2, ids[..., None])[..., 0] - 1
    return rank < cap


def keep_mask(idx: torch.Tensor, S: int, E: int, factor: float) -> torch.Tensor:
    """idx (B, n, k) chosen experts -> (B, n, k) kept packets."""
    B, n, k = idx.shape
    keep = torch.empty_like(idx, dtype=torch.bool)
    keep[:, :S] = _first(idx[:, :S].reshape(1, -1), E,
                         capacity(B * S, k, E, factor)).view(B, S, k)
    if n > S:
        dec = idx[:, S:].permute(1, 0, 2).reshape(n - S, B * k)
        keep[:, S:] = _first(dec, E, capacity(B, k, E, factor)).view(n - S, B, k).permute(1, 0, 2)
    return keep


def moe(p, layer, h, S, k, factor, mode):
    E = p["router"].shape[-1]
    probs = torch.softmax(linear(h, p["router"][layer].float(), mode), -1)
    w, idx = torch.topk(probs, k, dim=-1)
    w = w / w.sum(-1, keepdim=True)
    keep = keep_mask(idx, S, E, factor)
    out = torch.zeros_like(h)
    for e in range(E):
        sel = (idx == e) & keep
        rows = sel.any(-1)
        if not rows.any():
            continue
        x = h[rows]
        y = linear(silu(linear(x, p["gate"][layer, e].float(), mode))
                   * linear(x, p["up"][layer, e].float(), mode), p["down"][layer, e].float(), mode)
        out[rows] += (w * sel)[rows].sum(-1, keepdim=True) * y
    return out


def _attn(p, layer, h, theta, mode):
    def proj(name):
        W = p[name][layer].float()
        return linear(h, W.reshape(W.shape[0], -1), mode).unflatten(-1, W.shape[1:])
    q, kk, v = rope(proj("wq"), theta), rope(proj("wk"), theta), proj("wv")
    o = torch.cat([attend(q[i:i + BLOCK], kk[i:i + BLOCK], v[i:i + BLOCK], True, mode)
                   for i in range(0, h.shape[0], BLOCK)])
    Wo = p["wo"][layer].float()
    return linear(o.flatten(-2), Wo.reshape(-1, Wo.shape[-1]), mode)


@torch.no_grad()
def logits(params, cfg, prompts, frames, served, mode="f32"):
    eps, theta = cfg["norm_eps"], cfg["rope_theta"]
    k, factor = cfg["num_experts_per_tok"], cfg["capacity_factor"]
    S = prompts.shape[1]
    tokens = torch.cat([prompts, served[:, :-1]], 1)
    x = params["embed"].float()[tokens]
    blk = params["blocks"]["0"]
    for layer in range(blk["norm1"].shape[0]):
        h = rms_norm(x, blk["norm1"][layer].float(), eps)
        x = x + _attn(blk["attn"], layer, h, theta, mode)
        h = rms_norm(x, blk["norm2"][layer].float(), eps)
        x = x + moe(blk["moe"], layer, h, S, k, factor, mode)
    x = rms_norm(x, params["final_norm"].float(), eps)[:, S - 1:]
    return linear(x, params["lm_head"].float(), mode)
