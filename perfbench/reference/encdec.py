"""Whisper as the port defines it (``configs/whisper-large-v3.json``, its
``departures``): a stub frontend projection with sinusoidal positions, a
bidirectional encoder, and a decoder with causal self-attention,
cross-attention over the encoder output and a plain GELU MLP, RMSNorm before
each sub-layer, and the head tied to the embedding.  Float32, in blocks of
requests."""
from __future__ import annotations

import torch

from .common import attend, gelu_tanh, linear, rms_norm, sinusoidal

BLOCK = 8        # requests a block


def _mlp(p, layer, x, mode):
    return linear(gelu_tanh(linear(x, p["up"][layer].float(), mode)),
                  p["down"][layer].float(), mode)


def _proj(w, layer, x, mode):
    """x (b, n, d) through (d, H, D) -> (b, n, H, D)."""
    W = w[layer].float()
    return linear(x, W.reshape(W.shape[0], -1), mode).unflatten(-1, W.shape[1:])


def _out(w, layer, o, mode):
    W = w[layer].float()
    return linear(o.flatten(-2), W.reshape(-1, W.shape[-1]), mode)


def _attn(p, layer, xq, xkv, causal, mode):
    q, k, v = (_proj(p[w], layer, x, mode) for w, x in (("wq", xq), ("wk", xkv), ("wv", xkv)))
    return _out(p["wo"], layer, attend(q, k, v, causal, mode), mode)


def encode(params, frames, eps, mode):
    x = linear(frames.float(), params["frontend"].float(), mode)
    x = x + sinusoidal(x.shape[1], x.shape[2], x.device)
    blk = params["enc_blocks"]["0"]
    for layer in range(blk["norm1"].shape[0]):
        h = rms_norm(x, blk["norm1"][layer].float(), eps)
        x = x + _attn(blk["attn"], layer, h, h, False, mode)
        h = rms_norm(x, blk["norm2"][layer].float(), eps)
        x = x + _mlp(blk["mlp"], layer, h, mode)
    return rms_norm(x, params["enc_norm"].float(), eps)


def decode(params, enc, tokens, S, eps, mode):
    emb = params["embed"].float()
    x = emb[tokens] + sinusoidal(tokens.shape[1], emb.shape[1], emb.device)
    blk = params["blocks"]["0"]
    for layer in range(blk["norm1"].shape[0]):
        h = rms_norm(x, blk["norm1"][layer].float(), eps)
        x = x + _attn(blk["attn"], layer, h, h, True, mode)
        h = rms_norm(x, blk["norm_x"][layer].float(), eps)
        x = x + _attn(blk["cross"], layer, h, enc, False, mode)
        h = rms_norm(x, blk["norm2"][layer].float(), eps)
        x = x + _mlp(blk["mlp"], layer, h, mode)
    x = rms_norm(x, params["final_norm"].float(), eps)[:, S - 1:]
    return linear(x, emb.T, mode)


@torch.no_grad()
def logits(params, cfg, prompts, frames, served, mode="f32"):
    eps = cfg["norm_eps"]
    S = prompts.shape[1]
    tokens = torch.cat([prompts, served[:, :-1]], 1)
    out = []
    for lo in range(0, tokens.shape[0], BLOCK):
        enc = encode(params, frames[lo:lo + BLOCK], eps, mode)
        out.append(decode(params, enc, tokens[lo:lo + BLOCK], S, eps, mode))
    return torch.cat(out)
