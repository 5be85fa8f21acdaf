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

On a mesh (the ambient one, `launch.mesh.set_mesh`) every rank of it calls
the same function on the same batch, with the params cut to the rank's
blocks (`models.layers.shard_params`).  The :class:`Layout` of the call says
where tensors live: the batch is split over the data axes when they divide
it (``launch.steps.batch_shardings``'s rule), else replicated; the model
axis splits ``heads``, ``kv_heads``, ``mlp``, ``vocab`` and ``experts`` where
it divides them (`core.partition.split_axis`), and the recurrent mixers'
heads and inner channels (``ssm_inner``): MLA its heads, Mamba its inner
channels, mLSTM and sLSTM their heads (each mixer module says how).
Activations between sub-layers are replicated over the model axis.  The
embedding looks up the rank's rows and adds over the model axis; the head
gives each rank its vocab block of the logits, which stays sharded where no
caller needs whole rows: ``loss`` takes a vocab-parallel cross-entropy over
the block (`layers.vocab_parallel_cross_entropy`) and reduces over the data
axes, and ``prefill`` gathers the last position alone.  ``forward`` and
``decode_step`` all-gather the vocab and batch blocks, so every rank
returns the whole result.

API:
  abstract_params(cfg)                  -> ParamSpec tree
  forward(params, batch, cfg, cache)    -> (logits, aux, new_cache, moe_stats)
  loss(params, batch, cfg)              -> (scalar, metrics incl. moe_drops)
  init_cache(cfg, batch, max_len)       -> decode cache
  prefill / decode_step                 -> serving entry points
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.utils.checkpoint

from .._tree import flatten, unflatten
from ..configs.base import ModelConfig
from ..core import collectives as coll
from ..core.noc import NoCConfig
from ..core.partition import DEFAULT_RULES, logical_to_spec, split_axis
from . import mla as mla_mod
from . import moe as moe_mod
from . import ssm as ssm_mod
from . import xlstm as xlstm_mod
from .attention import AttnConfig, attention, attn_specs
from .attention import init_cache as attn_init_cache
from .layers import (ParamSpec, mlp_apply, mlp_specs, rms_norm, stack_specs,
                     vocab_parallel_cross_entropy)

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
                      compute_dtype=cfg.attn_compute_dtype)


def _mla_cfg(cfg: ModelConfig) -> mla_mod.MLAConfig:
    return mla_mod.MLAConfig(cfg.d_model, cfg.n_heads, rope_theta=cfg.rope_theta,
                             impl=cfg.attn_impl, bkv=cfg.bkv, absorb=cfg.mla_absorb,
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
# where a call's tensors live on the ambient mesh
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Layout:
    """The mesh axes one call splits over (each a `MeshAxis`, None: the
    dim is whole on every rank): ``batch`` the data axes over the batch;
    ``heads``, ``kv_heads``, ``mlp``, ``vocab`` the model axis over those
    dims of the weights (``heads`` for attention, MLA, mLSTM and sLSTM);
    ``ssm_inner`` over Mamba's inner channels, ``mlstm_inner`` over
    mLSTM's, ``slstm_ff`` over the ``mlp`` dim of sLSTM's FFN.  With no mesh
    every field is None."""

    mesh: Optional[coll.NoCMesh] = None
    batch: Optional[coll.MeshAxis] = None
    heads: Optional[coll.MeshAxis] = None
    kv_heads: Optional[coll.MeshAxis] = None
    mlp: Optional[coll.MeshAxis] = None
    vocab: Optional[coll.MeshAxis] = None
    ssm_inner: Optional[coll.MeshAxis] = None
    mlstm_inner: Optional[coll.MeshAxis] = None
    slstm_ff: Optional[coll.MeshAxis] = None

    def local_batch(self, B: int) -> int:
        return B // self.batch.size if self.batch is not None else B

    def take_batch(self, t):
        """This rank's rows of a whole-batch tensor (None passes)."""
        if t is None or self.batch is None:
            return t
        n = t.shape[0] // self.batch.size
        return t[self.batch.coord * n:(self.batch.coord + 1) * n]


def batch_axis(mesh, B: int):
    """The data axes the batch of ``B`` rows is split over on ``mesh``, or
    None: the rule's axes (``batch``) that the mesh has, all of them or none,
    as ``launch.steps.batch_shardings`` splits a batch."""
    if mesh is None:
        return None
    (entry,) = logical_to_spec(("batch",), DEFAULT_RULES, mesh.axis_names)
    if entry is None:
        return None
    ax = mesh.axis(entry)
    return ax if ax.size > 1 and B % ax.size == 0 else None


def layout(cfg: ModelConfig, B: int, mesh=None) -> Layout:
    """The :class:`Layout` of a call on a batch of ``B`` rows under ``mesh``
    (default: the ambient mesh)."""
    mesh = coll.current_mesh() if mesh is None else mesh
    if mesh is None:
        return Layout()
    mixers = {m for m, _ in cfg.pattern}
    xc = _xlstm_cfg(cfg)
    return Layout(mesh=mesh, batch=batch_axis(mesh, B),
                  heads=split_axis(mesh, "heads", cfg.n_heads),
                  kv_heads=split_axis(mesh, "kv_heads", cfg.n_kv_heads),
                  mlp=split_axis(mesh, "mlp", cfg.d_ff) if cfg.d_ff else None,
                  vocab=split_axis(mesh, "vocab", cfg.vocab_padded),
                  ssm_inner=(split_axis(mesh, "ssm_inner", _mamba_cfg(cfg).d_inner)
                             if "mamba" in mixers else None),
                  mlstm_inner=(split_axis(mesh, "ssm_inner", xc.d_inner)
                               if "mlstm" in mixers else None),
                  slstm_ff=split_axis(mesh, "mlp", xc.slstm_ff) if "slstm" in mixers else None)


def _split(axis) -> int:
    return axis.size if axis is not None else 1


def _cut_leaves(cfg: ModelConfig, lay: Layout, mixer: str) -> list:
    """(leaf, dim, whole size, axis) of the mixer's leaves the layout cuts
    (stacked leaves: ``dim`` counts from the end)."""
    if mixer == "attn":
        return [("wq", -2, cfg.n_heads, lay.heads)]
    if mixer == "mla":
        return [("q_b", -2, cfg.n_heads, lay.heads)]
    if mixer == "mamba":
        return [("conv_b", -1, _mamba_cfg(cfg).d_inner, lay.ssm_inner)]
    if mixer == "mlstm":
        return [("wq", -3, cfg.n_heads, lay.heads),
                ("conv_b", -1, _xlstm_cfg(cfg).d_inner, lay.mlstm_inner)]
    if mixer == "slstm":
        return [("rz", -3, cfg.n_heads, lay.heads)]
    raise _unknown(mixer)


def _check_blocks(params, cfg: ModelConfig, lay: Layout) -> None:
    """The params hold the rank's blocks of the layout (a whole tree on a
    mesh would compute wrong sums): the embedding's rows, and the first
    leaf the model axis cuts of each mixer of the pattern."""
    if lay.mesh is None:
        return
    checks = [("embedding rows", params["embed"].shape[0], cfg.vocab_padded, lay.vocab)]
    seen = set()
    for i, (mixer, _) in enumerate(cfg.pattern):
        if mixer in seen:
            continue
        seen.add(mixer)
        p = params["blocks"][str(i)][mixer]
        checks += [(f"{mixer} {leaf}", p[leaf].shape[dim], n, ax)
                   for leaf, dim, n, ax in _cut_leaves(cfg, lay, mixer)]
    bad = [f"{what} {got} (the rank's block: {n // _split(ax)})"
           for what, got, n, ax in checks if got != n // _split(ax)]
    if bad:
        raise ValueError(f"the params hold {'; '.join(bad)}: cut them with "
                         "models.layers.shard_params(params, param_pspecs(...), mesh)")


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
    as in the reference, with no index.  Under a mesh a rank's cache holds
    its block of the batch, of the kv heads and of the recurrent states'
    heads or inner channels (the call's `Layout`); the MLA latent has no
    head axis and is whole on every rank of the model axis."""
    P = cfg.n_periods
    f32 = torch.float32
    lay = layout(cfg, batch)
    batch = lay.local_batch(batch)
    ac = _attn_cfg(cfg)
    if lay.kv_heads is not None:
        ac = dataclasses.replace(ac, n_kv_heads=cfg.n_kv_heads // lay.kv_heads.size)
    blocks = {}
    for i, (mixer, _) in enumerate(cfg.pattern):
        # one allocation for all periods: P·batch rows, viewed as (P, batch)
        if mixer == "attn":
            c = attn_init_cache(ac, P * batch, max_len, cfg.cdtype, device)
        elif mixer == "mla":
            c = mla_mod.init_mla_cache(_mla_cfg(cfg), P * batch, max_len, cfg.cdtype, device)
        elif mixer == "mamba":
            c = ssm_mod.init_mamba_cache(_mamba_cfg(cfg), P * batch, f32, device,
                                         _split(lay.ssm_inner))
        elif mixer == "mlstm":
            ax = xlstm_mod.mlstm_axis(lay.heads, lay.mlstm_inner)
            c = xlstm_mod.init_mlstm_cache(_xlstm_cfg(cfg), P * batch, f32, device, _split(ax))
        elif mixer == "slstm":
            c = xlstm_mod.init_slstm_cache(_xlstm_cfg(cfg), P * batch, device, _split(lay.heads))
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
                    positions, cache, enc_out, causal, lay: Layout):
    """-> (x, new cache, aux, (drops, peak)); the last two are None without
    a MoE ffn."""
    aux = moe = None
    h = _norm(x, p["norm1"], cfg)
    if mixer == "attn":
        o, new_cache = attention(p["attn"], h, _attn_cfg(cfg), positions=positions,
                                 cache=cache, causal=causal, heads_axis=lay.heads,
                                 kv_axis=lay.kv_heads)
    elif mixer == "mla":
        o, new_cache = mla_mod.mla_apply(p["mla"], h, _mla_cfg(cfg), positions=positions,
                                         cache=cache, heads_axis=lay.heads)
    elif mixer == "mamba":
        o, new_cache = ssm_mod.mamba_apply(p["mamba"], h, _mamba_cfg(cfg), cache,
                                           axis=lay.ssm_inner)
    elif mixer == "mlstm":
        o, new_cache = xlstm_mod.mlstm_apply(p["mlstm"], h, _xlstm_cfg(cfg), cache,
                                             heads_axis=lay.heads, inner_axis=lay.mlstm_inner)
    elif mixer == "slstm":
        o, new_cache = xlstm_mod.slstm_apply(p["slstm"], h, _xlstm_cfg(cfg), cache,
                                             heads_axis=lay.heads, ff_axis=lay.slstm_ff)
    else:
        raise _unknown(mixer)
    x = x + o
    if enc_out is not None and "cross" in p:
        hx = _norm(x, p["norm_x"], cfg)
        # the rank's cross kv heads when they are split, else all of them
        e = coll.copy_to(enc_out, lay.kv_heads)
        kv_k = torch.einsum("btd,dhk->bhtk", e, p["cross"]["wk"].to(x.dtype))
        kv_v = torch.einsum("btd,dhk->bhtk", e, p["cross"]["wv"].to(x.dtype))
        o, _ = attention(p["cross"], hx, _attn_cfg(cfg), positions=positions,
                         kv_override=(kv_k, kv_v), causal=False, heads_axis=lay.heads,
                         kv_axis=lay.kv_heads)
        x = x + o
    if ffn == "mlp":
        h = _norm(x, p["norm2"], cfg)
        x = x + mlp_apply(p["mlp"], h, act="silu" if cfg.act == "silu" else "gelu",
                          axis=lay.mlp)
    elif ffn == "moe":
        h = _norm(x, p["norm2"], cfg)
        o, aux, st = moe_mod.moe_apply(p["moe"], h, _moe_cfg(cfg),
                                       batch_local=lay.batch is not None)
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
               enc_out, causal, lay: Layout):
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
                                              enc_out=enc_out, causal=causal, lay=lay)
            if nc is not None and "idx" in nc:
                new_idx[str(i)] = nc["idx"]
            elif nc is not None:
                for k, v in nc.items():
                    sub_cache[k].copy_(v)
            if moe is not None:
                moe_stats.append((aux, *moe))
        # the reference's constrain(x, ("batch", "seq", "embed")): x is the
        # rank's batch rows, replicated over the model axis; nothing moves
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


def _embed_tokens(params, tokens, cfg: ModelConfig, vocab_axis=None):
    """The embedding rows of ``tokens``.  With the vocab split over
    ``vocab_axis`` each rank looks up the tokens in its rows (zeros for the
    others) and the ranks' rows are added: one rank holds each token."""
    emb = params["embed"].to(cfg.cdtype)
    if vocab_axis is None:
        e = emb[tokens]
    else:
        rows = emb.shape[0]
        local = tokens - vocab_axis.coord * rows
        mine = (local >= 0) & (local < rows)
        e = emb[local.clamp(0, rows - 1)] * mine[..., None].to(emb.dtype)
        e = coll.reduce_from(e, vocab_axis)
    return e * torch.tensor(cfg.embed_scale, dtype=cfg.cdtype, device=e.device)


def _sinusoidal(positions, d, dtype):
    half = d // 2
    freqs = 10000.0 ** (-torch.arange(half, dtype=torch.float32, device=positions.device)
                        / half)
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1).to(dtype)


def encode(params, frames, cfg: ModelConfig, lay: Optional[Layout] = None):
    """Audio encoder: precomputed frame embeddings (stubbed conv frontend)
    -> frontend proj -> sinusoidal pos -> bidirectional stack.  Under a
    mesh ``frames`` are the rank's batch rows (``lay``: the call's)."""
    lay = layout(cfg, frames.shape[0]) if lay is None else lay
    x = frames.to(cfg.cdtype) @ params["frontend"].to(cfg.cdtype)
    pos = torch.arange(x.shape[1], device=x.device)[None, :]
    x = x + _sinusoidal(pos, cfg.d_model, x.dtype)
    x, *_ = _run_stack(params["enc_blocks"], x, cfg, pattern=(("attn", "mlp"),),
                       positions=pos.expand(x.shape[:2]), cache_blocks=None,
                       enc_out=None, causal=False, lay=lay)
    return _norm(x, params["enc_norm"], cfg)


def forward(params: dict, batch: dict, cfg: ModelConfig,
            cache: Optional[dict] = None):
    """-> (logits (B, S, V), aux_loss, new_cache, moe_stats).

    ``moe_stats``: {"moe_drops", "moe_peak_occupancy"}, 0-d int32 tensors:
    capacity-dropped packets summed over the MoE sub-layers and the hottest
    dispatch buffer (zeros without one).  A vlm batch's ``patches`` (B,
    n_patches, d_frontend) are projected by ``frontend`` and run before the
    tokens; the logits cover the tokens only.  Under a mesh the batch is the
    whole one on every rank, the cache the rank's (`init_cache` under the
    same mesh), and every rank returns the whole logits: its vocab and batch
    blocks all-gathered, (B, S, V) on every rank (`loss` and `prefill` keep
    them sharded instead)."""
    lay = layout(cfg, batch["tokens"].shape[0])
    logits, aux, new_cache, moe_stats = _forward(params, batch, cfg, cache, lay)
    logits = coll.gather_from(coll.gather_from(logits, lay.vocab, -1), lay.batch, 0)
    return logits, aux, new_cache, moe_stats


def _forward(params: dict, batch: dict, cfg: ModelConfig, cache: Optional[dict],
             lay: Layout):
    """`forward` on the rank's batch rows, ungathered: its logits are the
    rank's rows and its block of the vocab (``lay.vocab``'s; every column
    when the vocab is not split), which `loss` and `prefill` read without
    gathering the (rows, S, V) tensor."""
    _check_blocks(params, cfg, lay)
    tokens = lay.take_batch(batch["tokens"])
    B, S = tokens.shape
    pos0 = cache["pos"] if cache is not None else 0
    positions = pos0 + torch.arange(S, device=tokens.device)[None, :].expand(B, S)

    x = _embed_tokens(params, tokens, cfg, lay.vocab)
    if cfg.pos_embed == "sinusoidal":
        x = x + _sinusoidal(positions, cfg.d_model, x.dtype)

    enc_out = None
    if cfg.family == "encdec":
        enc_out = cache.get("enc_out") if cache is not None else None
        if enc_out is None:
            enc_out = encode(params, lay.take_batch(batch["frames"]), cfg, lay)
    prefix = cfg.family == "vlm" and "patches" in batch
    if prefix:
        pre = (lay.take_batch(batch["patches"]).to(cfg.cdtype)
               @ params["frontend"].to(cfg.cdtype))
        x = torch.cat([pre, x], dim=1)
        positions = pos0 + torch.arange(x.shape[1], device=x.device)[None, :].expand(
            B, x.shape[1])
    S_all = x.shape[1]
    # the reference's constrain(x, ("batch", "seq", "embed")): x holds the
    # rank's batch rows, replicated over the model axis; nothing moves

    cache_blocks = cache["blocks"] if cache is not None else None
    x, aux, new_blocks, moe_stats = _run_stack(
        params["blocks"], x, cfg, pattern=cfg.pattern, positions=positions,
        cache_blocks=cache_blocks, enc_out=enc_out, causal=True, lay=lay)
    x = _norm(x, params["final_norm"], cfg)
    if prefix:
        x = x[:, -S:]       # logits only for the text positions
    head = (params["embed"].to(x.dtype).T if cfg.tie_embeddings
            else params["lm_head"].to(x.dtype))
    # the reference's constrain(logits, ("batch", "seq", "vocab")): each rank
    # computes its vocab block
    logits = coll.copy_to(x, lay.vocab) @ head
    # the padded vocab classes (pad_vocab: global columns cfg.vocab on)
    lo = lay.vocab.coord * logits.shape[-1] if lay.vocab is not None else 0
    if lo + logits.shape[-1] > cfg.vocab:
        logits[..., max(cfg.vocab - lo, 0):] = MASK_LOGIT
    new_cache = None
    if cache is not None:
        new_cache = {"blocks": new_blocks, "pos": pos0 + S_all}
        if cfg.family == "encdec":
            new_cache["enc_out"] = enc_out
    return logits, aux, new_cache, moe_stats


def loss(params: dict, batch: dict, cfg: ModelConfig):
    """-> (nll + aux_weight · aux, {"nll", "aux", "moe_drops",
    "moe_peak_occupancy"}), the MoE counters in float32 as in the reference.

    Under a mesh that splits the vocab, the logits stay the rank's (rows, S,
    V / m) block, never gathered: the nll is the vocab-parallel
    cross-entropy over the blocks (`layers.vocab_parallel_cross_entropy`),
    whose backward leaves each rank the gradient of its own block.  Under a
    mesh that splits the batch, each rank computes the loss of its rows and
    the loss and nll are averaged over the data axes (the reference's global
    step); their backward is the identity, since the train step averages the
    ranks' gradients over those axes.  The MoE counters are the whole
    batch's already (summed, and maxed, in `moe.moe_apply`), and aux is
    replicated."""
    lay = layout(cfg, batch["tokens"].shape[0])
    logits, aux, _, moe_stats = _forward(params, batch, cfg, None, lay)
    nll = vocab_parallel_cross_entropy(logits, lay.take_batch(batch["labels"]), lay.vocab)
    total = nll + cfg.aux_weight * aux
    if lay.batch is not None:
        total, nll = coll.mean_from(torch.stack([total, nll]), lay.batch, 1.0).unbind(0)
    mets = {k: v.float() for k, v in moe_stats.items()}
    return total, {"nll": nll, "aux": aux, **mets}


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def prefill(params: dict, batch: dict, cfg: ModelConfig, cache: dict):
    """-> (the last position's logits (B, 1, V), the cache).  The head runs
    over every position, as in `forward` (the same products, so the same
    values); the last position is cut from the rank's vocab block before any
    gather, so a mesh moves (rows, 1, V / m) blocks, and the result owns its
    storage rather than keeping a (B, S, V) tensor alive."""
    lay = layout(cfg, batch["tokens"].shape[0])
    logits, _, cache, _ = _forward(params, batch, cfg, cache, lay)
    last = logits[:, -1:].clone()
    return coll.gather_from(coll.gather_from(last, lay.vocab, -1), lay.batch, 0), cache


def decode_step(params: dict, batch: dict, cfg: ModelConfig, cache: dict):
    """batch["tokens"]: (B, 1) — one new token against the cache."""
    logits, _, cache, _ = forward(params, batch, cfg, cache)
    return logits[:, -1], cache
