"""Whisper-large-v3  [audio]  enc-dec, 32+32L d_model=1280 20H (kv=20)
d_ff=5120 vocab=51866.  Conv frontend STUBBED as in the reference: the inputs
are precomputed (B, 1500, 128) mel-frame embeddings; the in-model frontend is
the projection to d_model + sinusoidal positions.  Plain (ungated) GeLU MLPs,
absolute positions (no rope).  [arXiv:2212.04356]
"""
from .base import ModelConfig, register

FULL = ModelConfig(
    name="whisper-large-v3",
    family="encdec",
    n_layers=32,
    n_enc_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab=51866,
    act="gelu",
    gated_mlp=False,
    use_rope=False,
    pos_embed="sinusoidal",
    enc_seq=1500,
    d_frontend=128,
    tie_embeddings=True,
)

SMOKE = FULL.replace(
    n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    head_dim=16, d_ff=128, vocab=256, enc_seq=24, d_frontend=8,
    dtype="float32", remat=False, attn_impl="naive",
)

register(FULL, SMOKE)
