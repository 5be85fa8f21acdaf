"""Qwen3-MoE-235B-A22B  [moe]  94L d_model=4096 64H (GQA kv=4) head_dim=128
vocab=151936, MoE 128 experts top-8, d_ff_expert=1536 (the per-expert FFN
width), QK-norm, rope_theta=1e6.  [hf:Qwen/Qwen3-235B-A22B]
"""
from .base import ModelConfig, register

FULL = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=0,
    vocab=151936,
    pattern=(("attn", "moe"),),
    qk_norm=True,
    rope_theta=1_000_000.0,
    n_experts=128,
    top_k=8,
    d_ff_expert=1536,
    moe_impl="gather",
    moe_topology="torus2d",  # the NoC mapping of moe_impl="noc": 128 expert PEs
    tie_embeddings=False,
)

SMOKE = FULL.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, vocab=256,
    n_experts=8, top_k=2, d_ff_expert=32, dtype="float32", remat=False,
    attn_impl="naive", moe_impl="dense",
)

register(FULL, SMOKE)
