"""Operations and bytes that the work needs, counted from the configuration's
sizes and the traffic's shapes, never from what an implementation does: no
recompute, no padding, no capacity slack.

``request_flops`` counts what one request needs end to end (`mfu`):

* an encoder-decoder model (Whisper): the frontend projection and the encoder
  once a clip; the cross-attention K/V once a request; each decoder position
  (the prompt's S, then gen - 1 fed-back tokens) through every decoder layer;
  the head once for each sampled token;
* a decoder (dense or MoE): each position through every layer (an MoE layer
  counts its router and its ``top_k`` experts); the head once for each
  sampled token.

Attention's core counts 4 · D operations for each (query, visible key) pair
and query head: Q·Kᵀ and P·V, two operations a multiply-add.  A causal
query at absolute position p sees p + 1 keys.

``attention_core`` counts one call of an attention kernel (the roofline of
`readers.prefill_attention_roofline`): its operations, and its bytes as q,
k, v and o each read or written once in their dtype.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Sizes:
    """The widths one family's counts need, from a configuration file."""
    d: int
    layers: int
    heads: int
    kv_heads: int
    head_dim: int
    vocab: int
    ff: int = 0                  # dense MLP width (gated: three matrices)
    gated: bool = False
    experts: int = 0
    top_k: int = 0
    expert_ff: int = 0
    enc_layers: int = 0
    enc_seq: int = 0
    d_frontend: int = 0


def sizes_of(cfg: dict) -> Sizes:
    """`Sizes` from a configuration file (its published key names)."""
    if cfg["reference"] == "encdec":
        d, h = cfg["d_model"], cfg["decoder_attention_heads"]
        return Sizes(d=d, layers=cfg["decoder_layers"], heads=h, kv_heads=h, head_dim=d // h,
                     vocab=cfg["vocab_size"], ff=cfg["decoder_ffn_dim"], gated=False,
                     enc_layers=cfg["encoder_layers"], enc_seq=cfg["max_source_positions"],
                     d_frontend=cfg["num_mel_bins"])
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    return Sizes(d=d, layers=cfg["num_hidden_layers"], heads=h,
                 kv_heads=cfg["num_key_value_heads"], head_dim=cfg.get("head_dim", d // h),
                 vocab=cfg["vocab_size"], ff=cfg.get("mlp_intermediate_size", 0), gated=True,
                 experts=cfg.get("num_local_experts", 0), top_k=cfg.get("num_experts_per_tok", 0),
                 expert_ff=cfg["intermediate_size"] if cfg.get("num_local_experts") else 0)


def visible_pairs(S: int, T: int, causal: bool, q_offset: int | None = None) -> int:
    """(query, key) pairs a call computes: S queries over T keys, or, causal,
    query i (absolute position q_offset + i, default T - S) over keys up to
    its own position and below T."""
    if not causal:
        return S * T
    o = T - S if q_offset is None else q_offset
    n1 = max(0, min(S, T - o))               # rows whose last visible key is o + i
    return n1 * (o + 1) + n1 * (n1 - 1) // 2 + (S - n1) * T


def attention_core(B: int, Hq: int, Hkv: int, S: int, T: int, D: int, causal: bool,
                   q_offset: int | None, itemsize: int) -> tuple[int, int]:
    """(operations, bytes) of one attention call."""
    flops = 4 * B * Hq * D * visible_pairs(S, T, causal, q_offset)
    nbytes = itemsize * (2 * B * Hq * S * D + 2 * B * Hkv * T * D)
    return flops, nbytes


def _self_attn_proj(z: Sizes) -> int:
    """q, k, v and o of one position."""
    return 2 * z.d * (2 * z.heads * z.head_dim + 2 * z.kv_heads * z.head_dim)


def _ffn(z: Sizes) -> int:
    if z.experts:
        return 2 * z.d * z.experts + z.top_k * 3 * 2 * z.d * z.expert_ff
    return (3 if z.gated else 2) * 2 * z.d * z.ff


def _causal_core(z: Sizes, n: int) -> int:
    """Self-attention cores of positions 0..n-1 in one layer."""
    return 4 * z.heads * z.head_dim * (n * (n + 1) // 2)


def request_flops(z: Sizes, prompt_len: int, gen: int) -> int:
    """Operations one request needs: its prompt and ``gen`` sampled tokens."""
    n = prompt_len + gen - 1                   # positions through the decoder
    hd = z.heads * z.head_dim
    dec = z.layers * (n * (_self_attn_proj(z) + _ffn(z)) + _causal_core(z, n))
    head = gen * 2 * z.d * z.vocab
    if not z.enc_layers:
        return dec + head
    T = z.enc_seq
    enc = 2 * T * z.d_frontend * z.d + z.enc_layers * (
        T * (_self_attn_proj(z) + _ffn(z)) + 4 * hd * T * T)
    cross_kv = z.layers * T * 2 * 2 * z.d * z.kv_heads * z.head_dim
    cross = z.layers * n * (2 * 2 * z.d * hd + 4 * hd * T)
    return enc + cross_kv + dec + cross + head
