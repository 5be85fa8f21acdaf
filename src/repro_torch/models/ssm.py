"""Mamba-1 selective SSM block, Jamba's attention-free mixer (counterpart of
``repro/models/ssm.py``).

The chunked scan of the reference: within a chunk of Q positions the linear
recurrence h_t = a_t·h_{t-1} + b_t runs as a log-step (Hillis–Steele)
doubling scan over the chunk axis with the reference's ``combine``
(``⌈log2 Q⌉`` steps, where the reference calls ``lax.associative_scan``);
across chunks a Python loop carries the (B, d_inner, N) float32 state, as the
reference's ``lax.scan`` does.  The association order differs from XLA's, so
the two agree to float32 rounding, not bit for bit.  Decode (S == 1) is the
O(1) recurrent update on (conv state, ssm state).

On a mesh (`launch.mesh`) each rank computes its block of the inner
channels (the ``ssm_inner`` rule): ``in_proj`` holds the rank's columns of
each of its two halves ``[x | z]`` (a `core.partition.Parts` cut, so no data
moves at the split), ``conv_w``, ``conv_b``, ``dt_w``, ``dt_b``, ``a_log``,
``d_skip`` its channels, ``x_proj`` and ``out_proj`` its rows.  ``x_proj``'s
output (dt's low rank, B and C) is a partial sum over the rank's channels:
it is added over the model axis and then read by every channel, so its
backward adds too.  The rank's outputs are added after ``out_proj``, and the
conv and ssm states hold the rank's channels.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from ..core.collectives import copy_to, reduce_from
from .layers import ParamSpec


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_model: int
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0     # 0 -> ceil(d/16)
    chunk: int = 256

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def rank(self) -> int:
        return self.dt_rank or -(-self.d_model // 16)


def mamba_specs(c: MambaConfig, dtype=torch.float32) -> dict:
    d, di, N, R = c.d_model, c.d_inner, c.d_state, c.rank
    return {
        "in_proj": ParamSpec((d, 2 * di), ("embed", "ssm_inner"), dtype, parts=2),
        "conv_w": ParamSpec((c.d_conv, di), (None, "ssm_inner"), dtype, init="small"),
        "conv_b": ParamSpec((di,), ("ssm_inner",), dtype, init="zeros"),
        "x_proj": ParamSpec((di, R + 2 * N), ("ssm_inner", None), dtype),
        "dt_w": ParamSpec((R, di), (None, "ssm_inner"), dtype),
        # softplus^-1(~0.01)
        "dt_b": ParamSpec((di,), ("ssm_inner",), dtype, init="ones", scale=-4.6),
        "a_log": ParamSpec((di, N), ("ssm_inner", "ssm_state"), dtype, init="ones"),
        "d_skip": ParamSpec((di,), ("ssm_inner",), dtype, init="ones"),
        "out_proj": ParamSpec((di, d), ("ssm_inner", "embed"), dtype),
    }


# leaves the mixer reads in float32 whatever the activations' dtype, as the
# reference casts them: the decay rates and the skip
FLOAT32_LEAVES = frozenset({"a_log", "d_skip"})


def init_mamba_cache(c: MambaConfig, batch: int, dtype=torch.float32, device=None,
                     split: int = 1) -> dict:
    """The conv and ssm states of ``batch`` rows; ``split``: the ranks the
    inner channels are split over (a rank's cache holds its block)."""
    di = c.d_inner // split
    return {
        "conv": torch.zeros((batch, c.d_conv - 1, di), dtype=dtype, device=device),
        "ssm": torch.zeros((batch, di, c.d_state), dtype=dtype, device=device),
    }


def _conv_causal(x, w, b, state: Optional[torch.Tensor]):
    """x (B,S,di), w (K,di) depthwise.  state: (B,K-1,di) prior context, cast
    to x's dtype on use.  -> (out (B,S,di), new state in x's dtype)."""
    K = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, K - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    out = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(K)) + b
    new_state = xp[:, -(K - 1):, :] if K > 1 else None
    return out, new_state


def _ssm_params(params, xc, c: MambaConfig, axis=None):
    """xc (B,S,di) post-conv -> dt (B,S,di), B_in (B,S,N), C_out (B,S,N), A.
    With the channels split over ``axis`` the projection's partial sums are
    added over it (forward and backward: reduce_from, then copy_to)."""
    R, N = c.rank, c.d_state
    proj = copy_to(reduce_from(xc @ params["x_proj"].to(xc.dtype), axis), axis)
    dt_r, b_in, c_out = proj[..., :R], proj[..., R:R + N], proj[..., R + N:]
    # bias initialized to softplus^-1(~0.01) ≈ -4.6 (dt_b spec: ones × -4.6)
    dt = F.softplus(dt_r @ params["dt_w"].to(xc.dtype) - 4.6 * params["dt_b"].to(xc.dtype))
    a = -torch.exp(params["a_log"].float())
    return dt, b_in, c_out, a


def _chunk_recurrence(h0, decay, inc):
    """h_t = decay_t * h_{t-1} + inc_t over axis 1 (the chunk), a doubling
    scan of combine(left, right) = (dl·dr, ir + dr·il).
    decay/inc: (B, Q, di, N); h0: (B, di, N) -> all prefix states (B, Q, di, N)."""
    dec, acc = decay, inc
    Q, s = decay.shape[1], 1
    while s < Q:
        # position t >= s takes combine(element t - s, element t)
        dl, il = dec[:, :-s], acc[:, :-s]
        dr, ir = dec[:, s:], acc[:, s:]
        dec = torch.cat([dec[:, :s], dl * dr], dim=1)
        acc = torch.cat([acc[:, :s], ir + dr * il], dim=1)
        s *= 2
    return acc + dec * h0[:, None]


def mamba_apply(params: dict, x: torch.Tensor, c: MambaConfig,
                cache: Optional[dict] = None,
                axis=None) -> tuple[torch.Tensor, Optional[dict]]:
    """x (B,S,d) -> (out (B,S,d), cache').  The new cache is a new dict: the
    conv state in the given cache's dtype, the ssm state in float32.
    ``axis``: the mesh axis the inner channels are split over (None: whole);
    x is replicated over it."""
    B, S, d = x.shape
    di, N = c.d_inner // (axis.size if axis is not None else 1), c.d_state
    # the rank's columns of x and of z: the reference's constrain(xs,
    # ("batch", "seq", "ssm_inner")) moves nothing here
    xz = copy_to(x, axis) @ params["in_proj"].to(x.dtype)
    xs, z = xz[..., :di], xz[..., di:]

    conv_state = cache["conv"] if cache is not None else None
    xc, new_conv = _conv_causal(xs, params["conv_w"].to(x.dtype),
                                params["conv_b"].to(x.dtype), conv_state)
    xc = F.silu(xc)
    dt, b_in, c_out, a = _ssm_params(params, xc, c, axis)

    dt32 = dt.float()
    xc32 = xc.float()
    h_prev = (cache["ssm"].float() if cache is not None
              else torch.zeros((B, di, N), dtype=torch.float32, device=x.device))

    if S == 1:  # decode: single recurrent update
        decay = torch.exp(dt32[:, 0, :, None] * a[None])                  # (B,di,N)
        inc = (dt32[:, 0, :, None] * xc32[:, 0, :, None]) * b_in[:, 0, None, :].float()
        h = decay * h_prev + inc
        y = torch.einsum("bdn,bn->bd", h, c_out[:, 0].float())[:, None, :]
        new_h = h
    else:
        Q = min(c.chunk, S)
        pad = (-S) % Q
        dtp, xcp, bp, cp = (F.pad(t, (0, 0, 0, pad)) if pad else t
                            for t in (dt32, xc32, b_in.float(), c_out.float()))
        new_h, ys = h_prev, []
        for lo in range(0, S + pad, Q):
            dtq, xq = dtp[:, lo:lo + Q], xcp[:, lo:lo + Q]
            bq, cq = bp[:, lo:lo + Q], cp[:, lo:lo + Q]
            decay = torch.exp(dtq[..., None] * a[None, None])             # (B,Q,di,N)
            inc = (dtq * xq)[..., None] * bq[:, :, None, :]
            hs = _chunk_recurrence(new_h, decay, inc)
            ys.append(torch.einsum("bqdn,bqn->bqd", hs, cq))
            new_h = hs[:, -1]
        y = torch.cat(ys, dim=1)[:, :S]

    y = y + xc32[:, :S] * params["d_skip"].float()
    y = y.to(x.dtype) * F.silu(z)
    out = reduce_from(y @ params["out_proj"].to(x.dtype), axis)
    new_cache = None
    if cache is not None:
        new_cache = {"conv": new_conv.to(cache["conv"].dtype), "ssm": new_h}
    return out, new_cache


def mamba_scan_ref(params: dict, x: torch.Tensor, c: MambaConfig) -> torch.Tensor:
    """Sequential-scan oracle (step-by-step decode semantics) for tests."""
    B = x.shape[0]
    cache = init_mamba_cache(c, B, device=x.device)
    outs = []
    for t in range(x.shape[1]):
        o, cache = mamba_apply(params, x[:, t:t + 1], c, cache)
        outs.append(o)
    return torch.cat(outs, dim=1)
