"""Command-R-35B  [dense]  40L d_model=8192 64H (GQA kv=8) d_ff=22528
vocab=256000 — GQA, no biases, tied embeddings, rope_theta=8e6.
[hf:CohereForAI/c4ai-command-r-v01]
"""
from .base import ModelConfig, register

FULL = ModelConfig(
    name="command-r-35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22528,
    vocab=256000,
    rope_theta=8_000_000.0,
    tie_embeddings=True,
)

SMOKE = FULL.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
    vocab=256, dtype="float32", remat=False, attn_impl="naive",
)

register(FULL, SMOKE)
