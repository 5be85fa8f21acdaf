"""Phi-3.5-MoE-42B-A6.6B  [moe]  32L d_model=4096 32H (GQA kv=8) head_dim=128
vocab=32064, MoE 16 experts top-2, d_ff_expert=6400.
[hf:microsoft/Phi-3.5-MoE-instruct]
"""
from .base import ModelConfig, register

FULL = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=0,
    vocab=32064,
    pattern=(("attn", "moe"),),
    rope_theta=10_000.0,
    n_experts=16,
    top_k=2,
    d_ff_expert=6400,
    moe_impl="gather",
    moe_topology="mesh2d",   # the NoC mapping of moe_impl="noc"
)

SMOKE = FULL.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, vocab=256,
    n_experts=4, top_k=2, d_ff_expert=48, dtype="float32", remat=False,
    attn_impl="naive", moe_impl="dense",
)

register(FULL, SMOKE)
