"""Llama-3.2-1B  [dense]  16L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=128256, head_dim=64, rope_theta=500000, tied embeddings.
[hf:meta-llama/Llama-3.2-1B]
"""
from .base import ModelConfig, register

FULL = ModelConfig(
    name="llama3.2-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab=128256,
    rope_theta=500_000.0,
    tie_embeddings=True,
)

SMOKE = FULL.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
    vocab=256, dtype="float32", remat=False, attn_impl="naive",
)

register(FULL, SMOKE)
