"""Gemma-7B  [dense]  28L d_model=3072 16H (MHA kv=16) d_ff=24576
vocab=256000 — GeGLU, head_dim=256, embeddings scaled by sqrt(d), tied.
(MQA is on the 2B sibling; 7B is MHA.)  [arXiv:2403.08295; hf]
"""
import math

from .base import ModelConfig, register

FULL = ModelConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab=256000,
    act="gelu",                      # gated GeLU = GeGLU
    tie_embeddings=True,
    embed_scale=math.sqrt(3072.0),
)

SMOKE = FULL.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
    vocab=256, dtype="float32", remat=False, attn_impl="naive",
    embed_scale=8.0,
)

register(FULL, SMOKE)
