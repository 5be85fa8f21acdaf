"""MiniCPM3-4B  [dense]  62L d_model=2560 40H d_ff=6400 vocab=73448, tied, with
MLA (multi-head latent attention: q_lora 768, kv_lora 256, nope 64, rope 32,
v 64; `models.mla.MLAConfig`'s defaults).  [hf:openbmb/MiniCPM3-4B]
"""
from .base import ModelConfig, register

FULL = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    head_dim=64,
    d_ff=6400,
    vocab=73448,
    pattern=(("mla", "mlp"),),
    tie_embeddings=True,
)

SMOKE = FULL.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
    vocab=256, dtype="float32", remat=False, attn_impl="naive",
)

register(FULL, SMOKE)
