"""Config-driven model assembly (counterpart of ``repro/models/transformer.py``):
a model is a (pattern × n_periods) stack of sub-layers.

The reference scans over periods; the port runs a Python loop over them and
splits each stacked weight into its periods, so params keep the reference's
stacked layout (leading layers axis on ``blocks`` and ``enc_blocks``).  With
``cfg.remat`` and grad enabled each period runs under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` around its
period), so the backward recomputes the period's forward.  The port has all
the reference's mixers (``attn``, ``mla``, ``mamba``, ``mlstm``, ``slstm``),
the plain and gated ``mlp`` ffn, the ``moe`` ffn, cross-attention, the audio
encoder and the vlm patch prefix: the dense, encdec, moe, hybrid, xlstm and
vlm families, served and trained.

Caches: an attention or MLA sub-layer writes its K/V in place and returns its
new write index; a recurrent sub-layer (``mamba``, ``mlstm``, ``slstm``)
returns its new float32 state, which the stack copies into its period's slice.

MoE dispatch stats follow the reference's scan carry: ``aux`` and
``moe_drops`` sum over the stack, ``moe_peak_occupancy`` is the max.

API:
  abstract_params(cfg)                  -> ParamSpec tree
  forward(params, batch, cfg, cache)    -> (logits, aux, new_cache, moe_stats)
  loss(params, batch, cfg)              -> (scalar, metrics incl. moe_drops)
  init_cache(cfg, batch, max_len)       -> decode cache
  prefill / decode_step                 -> serving entry points
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.utils.checkpoint

from .._tree import flatten, unflatten
from ..configs.base import ModelConfig
from ..core.noc import NoCConfig
from . import mla as mla_mod
from . import moe as moe_mod
from . import ssm as ssm_mod
from . import xlstm as xlstm_mod
from .attention import AttnConfig, attention, attn_specs
from .attention import init_cache as attn_init_cache
from .layers import ParamSpec, cross_entropy, mlp_apply, mlp_specs, rms_norm, stack_specs

MASK_LOGIT = -1e30   # padded vocab classes (pad_vocab)

# (sub-layer, leaf) pairs the forward reads in float32 whatever cfg.cdtype
# is: each mixer module names its own
FLOAT32_LEAVES = frozenset({("mamba", leaf) for leaf in ssm_mod.FLOAT32_LEAVES}
                           | {("slstm", leaf) for leaf in xlstm_mod.SLSTM_FLOAT32_LEAVES})


def _unknown(mixer: str):
    return ValueError(f"unknown mixer {mixer!r}")


def _attn_cfg(cfg: ModelConfig) -> AttnConfig:
    return AttnConfig(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                      qk_norm=cfg.qk_norm, rope_theta=cfg.rope_theta,
                      use_rope=cfg.use_rope and cfg.pos_embed == "rope",
                      impl=cfg.attn_impl, bkv=cfg.bkv,
                      logit_softcap=cfg.logit_softcap, seq_shard=cfg.seq_shard_kv,
                      unroll=cfg.analysis_unroll,
                      compute_dtype=cfg.attn_compute_dtype)


def _mla_cfg(cfg: ModelConfig) -> mla_mod.MLAConfig:
    return mla_mod.MLAConfig(cfg.d_model, cfg.n_heads, rope_theta=cfg.rope_theta,
                             impl=cfg.attn_impl, bkv=cfg.bkv,
                             unroll=cfg.analysis_unroll, absorb=cfg.mla_absorb,
                             compute_dtype=cfg.attn_compute_dtype)


def _mamba_cfg(cfg: ModelConfig) -> ssm_mod.MambaConfig:
    return ssm_mod.MambaConfig(cfg.d_model, cfg.mamba_d_state, cfg.mamba_d_conv,
                               cfg.mamba_expand, chunk=cfg.mamba_chunk)


def _xlstm_cfg(cfg: ModelConfig) -> xlstm_mod.XLSTMConfig:
    return xlstm_mod.XLSTMConfig(cfg.d_model, cfg.n_heads,
                                 proj_factor=cfg.xlstm_proj_factor,
                                 chunk=cfg.xlstm_chunk)


def _moe_cfg(cfg: ModelConfig) -> moe_mod.MoEConfig:
    # moe_flit_buffer_depth > 0 attaches a NoCConfig: the CONNECT buffer depth
    # becomes the capacity knob and capacity_factor is derived from it
    noc = (NoCConfig(flit_buffer_depth=cfg.moe_flit_buffer_depth)
           if cfg.moe_flit_buffer_depth else None)
    return moe_mod.MoEConfig(cfg.d_model, cfg.n_experts, cfg.top_k, cfg.d_ff_expert,
                             capacity_factor=cfg.capacity_factor, impl=cfg.moe_impl,
                             noc_topology=cfg.moe_topology, act=cfg.act, noc=noc)


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------

def _sublayer_specs(cfg: ModelConfig, mixer: str, ffn: str, cross: bool, dtype) -> dict:
    d = cfg.d_model
    sp: dict = {"norm1": ParamSpec((d,), ("embed",), dtype, init="ones")}
    if mixer == "attn":
        sp["attn"] = attn_specs(_attn_cfg(cfg), dtype)
    elif mixer == "mla":
        sp["mla"] = mla_mod.mla_specs(_mla_cfg(cfg), dtype)
    elif mixer == "mamba":
        sp["mamba"] = ssm_mod.mamba_specs(_mamba_cfg(cfg), dtype)
    elif mixer == "mlstm":
        sp["mlstm"] = xlstm_mod.mlstm_specs(_xlstm_cfg(cfg), dtype)
    elif mixer == "slstm":
        sp["slstm"] = xlstm_mod.slstm_specs(_xlstm_cfg(cfg), dtype)
    else:
        raise _unknown(mixer)
    if cross:
        sp["norm_x"] = ParamSpec((d,), ("embed",), dtype, init="ones")
        sp["cross"] = attn_specs(_attn_cfg(cfg), dtype)
    if ffn == "mlp":
        sp["norm2"] = ParamSpec((d,), ("embed",), dtype, init="ones")
        sp["mlp"] = mlp_specs(d, cfg.d_ff, dtype, cfg.gated_mlp)
    elif ffn == "moe":
        sp["norm2"] = ParamSpec((d,), ("embed",), dtype, init="ones")
        sp["moe"] = moe_mod.moe_specs(_moe_cfg(cfg), dtype)
    return sp


def _period_specs(cfg: ModelConfig, cross: bool, dtype) -> dict:
    return {str(i): _sublayer_specs(cfg, m, f, cross and m == "attn", dtype)
            for i, (m, f) in enumerate(cfg.pattern)}


def abstract_params(cfg: ModelConfig) -> dict:
    dtype = torch.float32  # master weights; compute casts per cfg.cdtype
    d, V = cfg.d_model, cfg.vocab_padded
    sp: dict = {
        "embed": ParamSpec((V, d), ("vocab", "embed"), dtype, init="embed", scale=0.02),
        "blocks": stack_specs(_period_specs(cfg, cfg.family == "encdec", dtype),
                              cfg.n_periods),
        "final_norm": ParamSpec((d,), ("embed",), dtype, init="ones"),
    }
    if not cfg.tie_embeddings:
        sp["lm_head"] = ParamSpec((d, V), ("embed", "vocab"), dtype, init="small")
    if cfg.family == "encdec":
        enc_pattern_cfg = cfg.replace(pattern=(("attn", "mlp"),), n_layers=cfg.n_enc_layers)
        sp["enc_blocks"] = stack_specs(_period_specs(enc_pattern_cfg, False, dtype),
                                       cfg.n_enc_layers)
        sp["enc_norm"] = ParamSpec((d,), ("embed",), dtype, init="ones")
        sp["frontend"] = ParamSpec((cfg.d_frontend, d), (None, "embed"), dtype)
    if cfg.family == "vlm":
        sp["frontend"] = ParamSpec((cfg.d_frontend, d), (None, "embed"), dtype)
    return sp


def serving_dtype(path: tuple, dtype: torch.dtype) -> torch.dtype:
    """The dtype a param at ``path`` (its keys from the root) is served in:
    ``dtype``, or float32 for the `FLOAT32_LEAVES`."""
    return torch.float32 if tuple(path[-2:]) in FLOAT32_LEAVES else dtype


def cast_params(params, dtype: torch.dtype):
    """The param tree in ``dtype`` but the `FLOAT32_LEAVES`, kept in float32.
    Every other weight on the forward path is cast to ``cfg.cdtype`` at use,
    and those are read in float32, so serving from this copy made once gives
    the same values and skips the per-step casts."""
    return unflatten(params, [t.to(serving_dtype(p, dtype)) for p, t in flatten(params)])


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None) -> dict:
    """Per sub-layer of the pattern: its cache tensors stacked over periods.
    Attention K/V (P, B, Hkv, max_len, D) and the MLA latent (P, B, max_len,
    kv_lora) and RoPE key (P, B, max_len, rope) are in ``cfg.cdtype``, with
    the shared write index; the recurrent states (Mamba conv and ssm; mLSTM
    conv, C, n, m; sLSTM c, n, m, h) are float32 whatever ``cfg.cdtype`` is,
    as in the reference, with no index."""
    P = cfg.n_periods
    f32 = torch.float32
    blocks = {}
    for i, (mixer, _) in enumerate(cfg.pattern):
        # one allocation for all periods: P·batch rows, viewed as (P, batch)
        if mixer == "attn":
            c = attn_init_cache(_attn_cfg(cfg), P * batch, max_len, cfg.cdtype, device)
        elif mixer == "mla":
            c = mla_mod.init_mla_cache(_mla_cfg(cfg), P * batch, max_len, cfg.cdtype, device)
        elif mixer == "mamba":
            c = ssm_mod.init_mamba_cache(_mamba_cfg(cfg), P * batch, f32, device)
        elif mixer == "mlstm":
            c = xlstm_mod.init_mlstm_cache(_xlstm_cfg(cfg), P * batch, f32, device)
        elif mixer == "slstm":
            c = xlstm_mod.init_slstm_cache(_xlstm_cfg(cfg), P * batch, device)
        else:
            raise _unknown(mixer)
        blocks[str(i)] = {k: (v if k == "idx" else v.unflatten(0, (P, batch)))
                          for k, v in c.items()}
    return {"blocks": blocks, "pos": 0}


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _norm(x, gamma, cfg: ModelConfig):
    return rms_norm(x, gamma.to(x.dtype), cfg.norm_eps)


def _apply_sublayer(p, x, cfg: ModelConfig, mixer: str, ffn: str, *,
                    positions, cache, enc_out, causal):
    """-> (x, new cache, aux, (drops, peak)); the last two are None without
    a MoE ffn."""
    aux = moe = None
    h = _norm(x, p["norm1"], cfg)
    if mixer == "attn":
        o, new_cache = attention(p["attn"], h, _attn_cfg(cfg), positions=positions,
                                 cache=cache, causal=causal)
    elif mixer == "mla":
        o, new_cache = mla_mod.mla_apply(p["mla"], h, _mla_cfg(cfg), positions=positions,
                                         cache=cache)
    elif mixer == "mamba":
        o, new_cache = ssm_mod.mamba_apply(p["mamba"], h, _mamba_cfg(cfg), cache)
    elif mixer == "mlstm":
        o, new_cache = xlstm_mod.mlstm_apply(p["mlstm"], h, _xlstm_cfg(cfg), cache)
    elif mixer == "slstm":
        o, new_cache = xlstm_mod.slstm_apply(p["slstm"], h, _xlstm_cfg(cfg), cache)
    else:
        raise _unknown(mixer)
    x = x + o
    if enc_out is not None and "cross" in p:
        hx = _norm(x, p["norm_x"], cfg)
        kv_k = torch.einsum("btd,dhk->bhtk", enc_out, p["cross"]["wk"].to(x.dtype))
        kv_v = torch.einsum("btd,dhk->bhtk", enc_out, p["cross"]["wv"].to(x.dtype))
        o, _ = attention(p["cross"], hx, _attn_cfg(cfg), positions=positions,
                         kv_override=(kv_k, kv_v), causal=False)
        x = x + o
    if ffn == "mlp":
        h = _norm(x, p["norm2"], cfg)
        x = x + mlp_apply(p["mlp"], h, act="silu" if cfg.act == "silu" else "gelu")
    elif ffn == "moe":
        h = _norm(x, p["norm2"], cfg)
        o, aux, st = moe_mod.moe_apply(p["moe"], h, _moe_cfg(cfg))
        moe = tuple(torch.as_tensor(v, dtype=torch.int32, device=x.device)
                    for v in (st.drops, st.peak_occupancy))
        x = x + o
    return x, new_cache, aux, moe


def _unstack(tree, n: int) -> list:
    """The ``n`` period slices of a stacked param tree (views, no copies).
    ``unbind`` rather than indexing: its backward stacks the periods'
    gradients once, where ``tree[i]`` would scatter each into a zero tensor
    of the whole stack."""
    if isinstance(tree, torch.Tensor):
        return tree.unbind(0)
    parts = {k: _unstack(v, n) for k, v in tree.items()}
    return [{k: parts[k][i] for k in parts} for i in range(n)]


def _run_stack(blocks, x, cfg: ModelConfig, *, pattern, positions, cache_blocks,
               enc_out, causal):
    """Loop over periods; each sub-layer's cache is its period's slice of the
    stacked cache tensors, written in place (by attention and MLA themselves,
    here for the recurrent mixers' new states).  Returns (x, aux, new cache
    blocks or None, moe_stats): ``aux`` and ``moe_drops`` summed over the MoE
    sub-layers, ``moe_peak_occupancy`` their max (the hottest dispatch buffer
    anywhere in the stack), zeros without one.  Without a cache, under
    ``cfg.remat`` and with grad enabled, each period is checkpointed (its
    activations are recomputed in the backward, its stats discarded there)."""
    periods = _unstack(blocks, blocks["0"]["norm1"].shape[0])
    new_idx = {}
    stats = []      # (aux, drops, peak) of each MoE sub-layer

    def period_fn(x, period):
        pp = periods[period]
        moe_stats = []
        for i, (mixer, ffn) in enumerate(pattern):
            sub_cache = None
            if cache_blocks is not None:
                sub_cache = {k: (v if k == "idx" else v[period])
                             for k, v in cache_blocks[str(i)].items()}
            x, nc, aux, moe = _apply_sublayer(pp[str(i)], x, cfg, mixer, ffn,
                                              positions=positions, cache=sub_cache,
                                              enc_out=enc_out, causal=causal)
            if nc is not None and "idx" in nc:
                new_idx[str(i)] = nc["idx"]
            elif nc is not None:
                for k, v in nc.items():
                    sub_cache[k].copy_(v)
            if moe is not None:
                moe_stats.append((aux, *moe))
        return x, moe_stats

    remat = cfg.remat and cache_blocks is None and torch.is_grad_enabled()
    for period in range(len(periods)):
        if remat:
            # the forward draws no random numbers: no RNG state to replay
            x, st = torch.utils.checkpoint.checkpoint(period_fn, x, period, use_reentrant=False,
                                                      preserve_rng_state=False)
        else:
            x, st = period_fn(x, period)
        stats += st
    if stats:
        aux, drops, peak = (torch.stack(s) for s in zip(*stats))
        aux, drops, peak = aux.sum(), drops.sum(dtype=torch.int32), peak.amax()
    else:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        drops = peak = torch.zeros((), dtype=torch.int32, device=x.device)
    moe_stats = {"moe_drops": drops, "moe_peak_occupancy": peak}
    if cache_blocks is None:
        return x, aux, None, moe_stats
    new_blocks = {i: dict(cb, idx=new_idx[i]) if i in new_idx else cb
                  for i, cb in cache_blocks.items()}
    return x, aux, new_blocks, moe_stats


def _embed_tokens(params, tokens, cfg: ModelConfig):
    e = params["embed"].to(cfg.cdtype)[tokens]
    return e * torch.tensor(cfg.embed_scale, dtype=cfg.cdtype, device=e.device)


def _sinusoidal(positions, d, dtype):
    half = d // 2
    freqs = 10000.0 ** (-torch.arange(half, dtype=torch.float32, device=positions.device)
                        / half)
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1).to(dtype)


def encode(params, frames, cfg: ModelConfig):
    """Audio encoder: precomputed frame embeddings (stubbed conv frontend)
    -> frontend proj -> sinusoidal pos -> bidirectional stack."""
    x = frames.to(cfg.cdtype) @ params["frontend"].to(cfg.cdtype)
    pos = torch.arange(x.shape[1], device=x.device)[None, :]
    x = x + _sinusoidal(pos, cfg.d_model, x.dtype)
    x, *_ = _run_stack(params["enc_blocks"], x, cfg, pattern=(("attn", "mlp"),),
                       positions=pos.expand(x.shape[:2]), cache_blocks=None,
                       enc_out=None, causal=False)
    return _norm(x, params["enc_norm"], cfg)


def forward(params: dict, batch: dict, cfg: ModelConfig,
            cache: Optional[dict] = None):
    """-> (logits (B, S, V), aux_loss, new_cache, moe_stats).

    ``moe_stats``: {"moe_drops", "moe_peak_occupancy"}, 0-d int32 tensors:
    capacity-dropped packets summed over the MoE sub-layers and the hottest
    dispatch buffer (zeros without one).  A vlm batch's ``patches`` (B,
    n_patches, d_frontend) are projected by ``frontend`` and run before the
    tokens; the logits cover the tokens only."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    pos0 = cache["pos"] if cache is not None else 0
    positions = pos0 + torch.arange(S, device=tokens.device)[None, :].expand(B, S)

    x = _embed_tokens(params, tokens, cfg)
    if cfg.pos_embed == "sinusoidal":
        x = x + _sinusoidal(positions, cfg.d_model, x.dtype)

    enc_out = None
    if cfg.family == "encdec":
        enc_out = cache.get("enc_out") if cache is not None else None
        if enc_out is None:
            enc_out = encode(params, batch["frames"], cfg)
    prefix = cfg.family == "vlm" and "patches" in batch
    if prefix:
        pre = batch["patches"].to(cfg.cdtype) @ params["frontend"].to(cfg.cdtype)
        x = torch.cat([pre, x], dim=1)
        positions = pos0 + torch.arange(x.shape[1], device=x.device)[None, :].expand(
            B, x.shape[1])
    S_all = x.shape[1]

    cache_blocks = cache["blocks"] if cache is not None else None
    x, aux, new_blocks, moe_stats = _run_stack(
        params["blocks"], x, cfg, pattern=cfg.pattern, positions=positions,
        cache_blocks=cache_blocks, enc_out=enc_out, causal=True)
    x = _norm(x, params["final_norm"], cfg)
    if prefix:
        x = x[:, -S:]       # logits only for the text positions
    head = (params["embed"].to(x.dtype).T if cfg.tie_embeddings
            else params["lm_head"].to(x.dtype))
    logits = x @ head
    if cfg.vocab_padded != cfg.vocab:
        logits[..., cfg.vocab:] = MASK_LOGIT
    new_cache = None
    if cache is not None:
        new_cache = {"blocks": new_blocks, "pos": pos0 + S_all}
        if cfg.family == "encdec":
            new_cache["enc_out"] = enc_out
    return logits, aux, new_cache, moe_stats


def loss(params: dict, batch: dict, cfg: ModelConfig):
    """-> (nll + aux_weight · aux, {"nll", "aux", "moe_drops",
    "moe_peak_occupancy"}), the MoE counters in float32 as in the reference."""
    logits, aux, _, moe_stats = forward(params, batch, cfg)
    nll = cross_entropy(logits, batch["labels"])
    total = nll + cfg.aux_weight * aux
    mets = {k: v.float() for k, v in moe_stats.items()}
    return total, {"nll": nll, "aux": aux, **mets}


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def prefill(params: dict, batch: dict, cfg: ModelConfig, cache: dict):
    logits, _, cache, _ = forward(params, batch, cfg, cache)
    return logits[:, -1:], cache


def decode_step(params: dict, batch: dict, cfg: ModelConfig, cache: dict):
    """batch["tokens"]: (B, 1) — one new token against the cache."""
    logits, _, cache, _ = forward(params, batch, cfg, cache)
    return logits[:, -1], cache
