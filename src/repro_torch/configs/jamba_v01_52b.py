"""Jamba-v0.1-52B  [hybrid]  32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16 experts top-2.  Mamba+attention 1:7 interleave
(attn_layer_period=8 offset 4), MoE every 2nd layer (offset 1).
No positional embeddings (the SSM layers carry position).  [arXiv:2403.19887; hf]
"""
from .base import ModelConfig, register

# one period = 8 layers: attn at index 4, MoE at odd indices
_PATTERN = tuple(
    ("attn" if i == 4 else "mamba", "moe" if i % 2 == 1 else "mlp")
    for i in range(8)
)

FULL = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=65536,
    pattern=_PATTERN,
    use_rope=False,
    n_experts=16,
    top_k=2,
    d_ff_expert=14336,
    moe_impl="gather",
    mamba_d_state=16,
    mamba_d_conv=4,
    mamba_expand=2,
)

SMOKE = FULL.replace(
    n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
    vocab=256, n_experts=4, top_k=2, d_ff_expert=96, dtype="float32",
    remat=False, attn_impl="naive", moe_impl="dense", mamba_chunk=16,
)

register(FULL, SMOKE)
