"""InternVL2-1B  [vlm]  the LM backbone (Qwen2-0.5B): 24L d_model=896 14H
(GQA kv=2) head_dim=64 d_ff=4864 vocab=151655, tied.  The InternViT encoder is
stubbed: the model takes precomputed (B, 256, 1024) patch embeddings, and its
``frontend`` weight projects them to d_model.  [arXiv:2404.16821;
hf:OpenGVLab/InternVL2-1B]
"""
from .base import ModelConfig, register

FULL = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab=151655,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    n_patches=256,
    d_frontend=1024,
)

SMOKE = FULL.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
    vocab=256, n_patches=8, d_frontend=16, dtype="float32", remat=False,
    attn_impl="naive",
)

register(FULL, SMOKE)
