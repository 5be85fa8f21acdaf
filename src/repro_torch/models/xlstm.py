"""xLSTM blocks: mLSTM (matrix memory, chunkwise-parallel) and sLSTM (scalar
memory, sequential), per arXiv:2405.04517 (counterpart of
``repro/models/xlstm.py``).

* mLSTM: the recurrence C_t = f_t C_{t-1} + i_t k_t v_tᵀ is linear, so
  training and prefill run the reference's chunkwise form: intra-chunk
  attention-style matmuls with a log-gate decay matrix, inter-chunk a
  (B, H, dk, dv) float32 carry with running stabilizers, carried across
  chunks by a Python loop where the reference scans.  The sequential step is
  the decode path and the oracle.
* projections and gates are head-local (block-diagonal), as in the reference.
* sLSTM's h_{t-1} → gates feedback is sequential: a Python loop over the
  sequence where the reference runs ``lax.scan``.

Every recurrent state (C, n, m; c, n, m, h) is float32 whatever the
activations' dtype; the initial stabilizers ``m`` are -1e30.

On a mesh (`launch.mesh`) both mixers split their heads over the model
axis.  mLSTM reshapes its inner channels into heads, so it runs split only
where the ``heads`` and ``ssm_inner`` rules cut the same axis
(:func:`mlstm_axis`): each rank then holds its heads' block of ``up``'s two
halves (a `core.partition.Parts` cut), ``conv``, ``norm`` and ``down``'s
rows, and its heads of ``wq``…``bf``; the per-head norm is local and the
outputs are added after ``down``.  Where the rules disagree (an axis that
divides the inner channels but not the heads) the leaves cut over either
axis are all-gathered and the mixer runs replicated, never on part of a
head.  sLSTM's recurrence is block-diagonal per head, so its token loop
needs no collective; ``h`` is all-gathered over the heads before the norm
over the whole ``d``, and the FFN is a Megatron pair over the ``mlp`` rule
where it divides ``slstm_ff``, else replicated.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from ..core.collectives import copy_to, gather_from, reduce_from
from .layers import ParamSpec, rms_norm
from .ssm import _conv_causal


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    d_model: int
    n_heads: int
    proj_factor: float = 2.0          # mLSTM up-projection
    d_conv: int = 4
    chunk: int = 128
    slstm_ff_factor: float = 4.0 / 3.0

    @property
    def d_inner(self) -> int:
        return int(self.proj_factor * self.d_model)

    @property
    def dh(self) -> int:  # mLSTM head dim (of d_inner)
        return self.d_inner // self.n_heads

    @property
    def dh_model(self) -> int:  # sLSTM head dim (of d_model)
        return self.d_model // self.n_heads

    @property
    def slstm_ff(self) -> int:
        return int(self.slstm_ff_factor * self.d_model)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_specs(c: XLSTMConfig, dtype=torch.float32) -> dict:
    d, di, H, dh = c.d_model, c.d_inner, c.n_heads, c.dh
    return {
        "up": ParamSpec((d, 2 * di), ("embed", "ssm_inner"), dtype, parts=2),
        "conv_w": ParamSpec((c.d_conv, di), (None, "ssm_inner"), dtype, init="small"),
        "conv_b": ParamSpec((di,), ("ssm_inner",), dtype, init="zeros"),
        "wq": ParamSpec((H, dh, dh), ("heads", None, None), dtype),
        "wk": ParamSpec((H, dh, dh), ("heads", None, None), dtype),
        "wv": ParamSpec((H, dh, dh), ("heads", None, None), dtype),
        "wi": ParamSpec((H, dh), ("heads", None), dtype, init="small"),
        "bi": ParamSpec((H,), ("heads",), dtype, init="zeros"),
        "wf": ParamSpec((H, dh), ("heads", None), dtype, init="small"),
        "bf": ParamSpec((H,), ("heads",), dtype, init="ones", scale=3.0),
        "norm": ParamSpec((di,), ("ssm_inner",), dtype, init="ones"),
        "down": ParamSpec((di, d), ("ssm_inner", "embed"), dtype),
    }


def init_mlstm_cache(c: XLSTMConfig, batch: int, dtype=torch.float32, device=None,
                     split: int = 1) -> dict:
    """The conv state in ``dtype``; C, n and m in float32.  ``split``: the
    ranks the heads are split over (a rank's cache holds its heads)."""
    H, dh = c.n_heads // split, c.dh
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "conv": torch.zeros((batch, c.d_conv - 1, H * dh), dtype=dtype, device=device),
        "C": torch.zeros((batch, H, dh, dh), **f32),
        "n": torch.zeros((batch, H, dh), **f32),
        "m": torch.full((batch, H), -1e30, **f32),
    }


def mlstm_axis(heads_axis, inner_axis):
    """The mesh axis mLSTM runs split over: the heads' axis when the inner
    channels are cut over the same one (a rank's channels are then its whole
    heads), else None."""
    if heads_axis is None or inner_axis is None or heads_axis.names != inner_axis.names:
        return None
    return heads_axis


def _whole_leaf(w, axis, dim, parts=1):
    """A leaf cut over ``axis`` along ``dim`` (each of its ``parts`` alone)
    all-gathered; its gradient is the rank's block of the cotangent."""
    if axis is None:
        return w
    if parts == 1:
        return gather_from(w, axis, dim)
    return gather_from(w.unflatten(dim, (parts, -1)), axis, dim).flatten(dim - 1, dim)


def _mlstm_whole(params, heads_axis, inner_axis):
    """mLSTM's leaves whole, from the rank's blocks over the two axes (the
    replicated run where the rules disagree)."""
    out = dict(params)
    out["up"] = _whole_leaf(params["up"], inner_axis, -1, parts=2)
    for k in ("conv_w", "conv_b", "norm"):
        out[k] = _whole_leaf(params[k], inner_axis, -1)
    out["down"] = _whole_leaf(params["down"], inner_axis, 0)
    for k in ("wq", "wk", "wv", "wi", "wf", "bi", "bf"):
        out[k] = _whole_leaf(params[k], heads_axis, 0)
    return out


def _mlstm_qkv_gates(params, x, c: XLSTMConfig, conv_state, H: int):
    """The projections and gates of the ``H`` heads the params hold."""
    B, S, _ = x.shape
    dh = c.dh
    di = H * dh
    up = x @ params["up"].to(x.dtype)
    xi, z = up[..., :di], up[..., di:]
    xc, new_conv = _conv_causal(xi, params["conv_w"].to(x.dtype),
                                params["conv_b"].to(x.dtype), conv_state)
    xc = F.silu(xc)
    xh = xc.reshape(B, S, H, dh)
    q = torch.einsum("bshd,hde->bshe", xh, params["wq"].to(x.dtype)) * (dh ** -0.5)
    k = torch.einsum("bshd,hde->bshe", xh, params["wk"].to(x.dtype))
    # v from the pre-conv branch, as in the reference
    v = torch.einsum("bshd,hde->bshe", xi.reshape(B, S, H, dh), params["wv"].to(x.dtype))
    li = (torch.einsum("bshd,hd->bsh", xh, params["wi"].to(x.dtype))
          + params["bi"].to(x.dtype)).float()
    lf_raw = (torch.einsum("bshd,hd->bsh", xh, params["wf"].to(x.dtype))
              + 3.0 * params["bf"].to(x.dtype)).float()
    lf = F.logsigmoid(lf_raw)
    return q, k, v, z, li, lf, new_conv


def _mlstm_decode_step(q, k, v, li, lf, state):
    """Single-step stabilized recurrence.  q/k/v: (B,H,dh); li/lf: (B,H)."""
    C, n, m = state["C"], state["n"], state["m"]
    m_new = torch.maximum(lf + m, li)
    fp = torch.exp(lf + m - m_new)[..., None, None]
    ip = torch.exp(li - m_new)[..., None, None]
    k32, v32, q32 = k.float(), v.float(), q.float()
    C_new = fp * C + ip * (k32[..., :, None] * v32[..., None, :])
    n_new = fp[..., 0] * n + ip[..., 0] * k32
    num = torch.einsum("bhkv,bhk->bhv", C_new, q32)
    den = torch.einsum("bhk,bhk->bh", n_new, q32).abs()
    h = num / torch.maximum(den, torch.exp(-m_new))[..., None]
    return h, {"C": C_new, "n": n_new, "m": m_new}


def _mlstm_chunk(carry, qb, kb, vb, lib, lfb):
    """One chunk of the chunkwise form.  carry = (Ch, nh, mc), the stabilized
    state (true C = Ch·exp(mc)); qb/kb/vb (B,H,Q,dh), lib/lfb (B,H,Q).
    -> (new carry, h (B,H,Q,dh))."""
    Ch, nh, mc = carry
    Q = qb.shape[2]
    A = torch.cumsum(lfb, dim=-1)          # inclusive decay prefix (B,H,Q)
    # intra-chunk log decay matrix: logD[t,s] = A_t - A_s + li_s, s<=t
    logD = A[..., :, None] - A[..., None, :] + lib[..., None, :]
    tri = torch.ones((Q, Q), dtype=torch.bool, device=qb.device).tril()
    logD = torch.where(tri, logD, -torch.inf)
    inter_log = A + mc[..., None]          # carry contribution (B,H,Q)
    m_t = torch.maximum(logD.amax(dim=-1), inter_log)
    m_t = m_t.clamp_min(-1e30)
    Dm = torch.exp(logD - m_t[..., None])                      # (B,H,Q,Q)
    w_inter = torch.exp(inter_log - m_t)                       # (B,H,Q)
    scores = torch.einsum("bhtd,bhsd->bhts", qb, kb) * Dm
    num = (torch.einsum("bhts,bhsv->bhtv", scores, vb)
           + w_inter[..., None] * torch.einsum("bhkv,bhtk->bhtv", Ch, qb))
    den = scores.sum(dim=-1) + w_inter * torch.einsum("bhk,bhtk->bht", nh, qb)
    h = num / torch.maximum(den.abs(), torch.exp(-m_t))[..., None]
    # carry update
    A_Q = A[..., -1]                                           # (B,H)
    s_log = A_Q[..., None] - A + lib                           # decay of s to chunk end
    mc_new = torch.maximum(A_Q + mc, s_log.amax(dim=-1))
    wk_s = torch.exp(s_log - mc_new[..., None])                # (B,H,Q)
    keep = torch.exp(A_Q + mc - mc_new)
    Ch_new = (keep[..., None, None] * Ch
              + torch.einsum("bhs,bhsk,bhsv->bhkv", wk_s, kb, vb))
    nh_new = keep[..., None] * nh + torch.einsum("bhs,bhsk->bhk", wk_s, kb)
    return (Ch_new, nh_new, mc_new), h


def _mlstm_chunked(q, k, v, li, lf, state, chunk: int):
    """Chunkwise-parallel mLSTM.  q/k/v (B,S,H,dh); li/lf (B,S,H).  A padded
    last chunk takes li = -1e30 on its pad rows (no input); their outputs are
    dropped."""
    B, S, H, dh = q.shape
    Q = min(chunk, S)
    pad = (-S) % Q
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        li = F.pad(li, (0, 0, 0, pad), value=-1e30)
        lf = F.pad(lf, (0, 0, 0, pad))
    # (B, S+, H, ...) -> (B, H, S+, ...)
    qh, kh, vh = (t.transpose(1, 2).float() for t in (q, k, v))
    lih, lfh = li.transpose(1, 2), lf.transpose(1, 2)
    carry, hs = (state["C"], state["n"], state["m"]), []
    for lo in range(0, S + pad, Q):
        sl = slice(lo, lo + Q)
        carry, h = _mlstm_chunk(carry, qh[:, :, sl], kh[:, :, sl], vh[:, :, sl],
                                lih[:, :, sl], lfh[:, :, sl])
        hs.append(h)
    h = torch.cat(hs, dim=2).transpose(1, 2)[:, :S]
    Cf, nf, mf = carry
    return h, {"C": Cf, "n": nf, "m": mf}


def mlstm_apply(params: dict, x: torch.Tensor, c: XLSTMConfig,
                cache: Optional[dict] = None, heads_axis=None,
                inner_axis=None) -> tuple[torch.Tensor, Optional[dict]]:
    """x (B,S,d) -> (out (B,S,d), cache'); the new cache is a new dict.
    ``heads_axis`` / ``inner_axis``: the mesh axes the heads and the inner
    channels are split over (None: whole); x is replicated over them."""
    B, S, d = x.shape
    axis = mlstm_axis(heads_axis, inner_axis)
    if axis is None:
        params = _mlstm_whole(params, heads_axis, inner_axis)
    H, dh = c.n_heads // (axis.size if axis is not None else 1), c.dh   # the rank's heads
    di = H * dh
    conv_state = cache["conv"] if cache is not None else None
    q, k, v, z, li, lf, new_conv = _mlstm_qkv_gates(params, copy_to(x, axis), c, conv_state, H)
    state = ({k2: cache[k2] for k2 in ("C", "n", "m")} if cache is not None
             else {k2: t for k2, t in init_mlstm_cache(
                 c, B, device=x.device, split=c.n_heads // H).items() if k2 != "conv"})
    if S == 1:
        h, new_state = _mlstm_decode_step(q[:, 0], k[:, 0], v[:, 0], li[:, 0], lf[:, 0],
                                          state)
        h = h[:, None]
    else:
        h, new_state = _mlstm_chunked(q, k, v, li, lf, state, c.chunk)
    h = h.reshape(B, S, di).to(x.dtype)
    ones = torch.ones((dh,), dtype=x.dtype, device=x.device)
    h = rms_norm(h.reshape(B, S, H, dh), ones).reshape(B, S, di)
    h = h * params["norm"].to(x.dtype)
    h = h * F.silu(z)
    out = reduce_from(h @ params["down"].to(x.dtype), axis)
    new_cache = None
    if cache is not None:
        new_cache = {"conv": new_conv.to(cache["conv"].dtype), **new_state}
    return out, new_cache


def mlstm_seq_ref(params: dict, x: torch.Tensor, c: XLSTMConfig) -> torch.Tensor:
    """Step-by-step oracle for the chunked path."""
    cache = init_mlstm_cache(c, x.shape[0], x.dtype, x.device)
    outs = []
    for t in range(x.shape[1]):
        o, cache = mlstm_apply(params, x[:, t:t + 1], c, cache)
        outs.append(o)
    return torch.cat(outs, dim=1)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

SLSTM_GATES = ("z", "i", "f", "o")
# leaves slstm_apply reads in float32 whatever the activations' dtype, as the
# reference casts them: the recurrent weights
SLSTM_FLOAT32_LEAVES = frozenset(f"r{g}" for g in SLSTM_GATES)


def slstm_specs(c: XLSTMConfig, dtype=torch.float32) -> dict:
    d, H, dh = c.d_model, c.n_heads, c.dh_model
    sp = {}
    for g in SLSTM_GATES:
        sp[f"w{g}"] = ParamSpec((d, H, dh), ("embed", "heads", None), dtype)
        sp[f"r{g}"] = ParamSpec((H, dh, dh), ("heads", None, None), dtype, init="small")
        sp[f"b{g}"] = ParamSpec((H, dh), ("heads", None), dtype,
                                init="ones" if g == "f" else "zeros")
    sp["norm"] = ParamSpec((d,), ("embed",), dtype, init="ones")
    sp["ff_up"] = ParamSpec((d, c.slstm_ff), ("embed", "mlp"), dtype)
    sp["ff_down"] = ParamSpec((c.slstm_ff, d), ("mlp", "embed"), dtype)
    return sp


def init_slstm_cache(c: XLSTMConfig, batch: int, device=None, split: int = 1) -> dict:
    """c, n, m and h of ``batch`` rows in float32; ``split``: the ranks the
    heads are split over (a rank's cache holds its heads)."""
    shape = (batch, c.n_heads // split, c.dh_model)
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros(shape, **f32), "n": torch.zeros(shape, **f32),
            "m": torch.full(shape, -1e30, **f32), "h": torch.zeros(shape, **f32)}


def slstm_apply(params: dict, x: torch.Tensor, c: XLSTMConfig,
                cache: Optional[dict] = None, heads_axis=None,
                ff_axis=None) -> tuple[torch.Tensor, Optional[dict]]:
    """x (B,S,d) -> (out (B,S,d), cache').  The recurrent weights r* are read
    in float32, as in the reference.  ``heads_axis`` / ``ff_axis``: the mesh
    axes the heads and the FFN's ``mlp`` dim are split over (None: whole);
    x is replicated over them."""
    B, S, d = x.shape
    split = heads_axis.size if heads_axis is not None else 1
    xh = copy_to(x, heads_axis)
    pre = torch.stack([(torch.einsum("bsd,dhe->bshe", xh, params[f"w{g}"].to(x.dtype))
                        + (3.0 if g == "f" else 1.0) * params[f"b{g}"].to(x.dtype)).float()
                       for g in SLSTM_GATES])                        # (4, B, S, H, dh)
    # the four recurrent products of a step as one: (4, H, dh, dh)
    r = torch.stack([params[f"r{g}"].float() for g in SLSTM_GATES])
    st = cache if cache is not None else init_slstm_cache(c, B, x.device, split)
    hs = []
    for t in range(S):
        zt, it, ft, ot = pre[:, :, t] + torch.einsum("bhe,ghef->gbhf", st["h"], r)
        z = torch.tanh(zt)
        lf = F.logsigmoid(ft)
        o = torch.sigmoid(ot)
        m_new = torch.maximum(lf + st["m"], it)
        fp = torch.exp(lf + st["m"] - m_new)
        ip = torch.exp(it - m_new)
        c_new = fp * st["c"] + ip * z
        n_new = fp * st["n"] + ip
        h = o * c_new / n_new.clamp_min(1e-6)
        st = {"c": c_new, "n": n_new, "m": m_new, "h": h}
        hs.append(h)
    # the rank's heads, then every head: the norm is over the whole d
    h = gather_from(torch.stack(hs, dim=1).to(x.dtype), heads_axis, 2).reshape(B, S, d)
    h = rms_norm(h, params["norm"].to(x.dtype))
    hf = copy_to(h, ff_axis)
    h = h + reduce_from(F.gelu(hf @ params["ff_up"].to(x.dtype),
                               approximate="tanh") @ params["ff_down"].to(x.dtype), ff_axis)
    return h, (st if cache is not None else None)
