"""xLSTM-350M  [ssm]  24L d_model=1024 4H vocab=50304, sLSTM + mLSTM blocks
(d_ff=0: the blocks carry their own projections; sLSTM block keeps the 4/3
GeLU FFN per the paper's block design).  Pattern: one sLSTM per 6 layers.
[arXiv:2405.04517; unverified]
"""
from .base import ModelConfig, register

_PATTERN = tuple(
    ("slstm" if i == 5 else "mlstm", "none") for i in range(6)
)

FULL = ModelConfig(
    name="xlstm-350m",
    family="xlstm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    pattern=_PATTERN,
    use_rope=False,
    tie_embeddings=True,
    xlstm_proj_factor=2.0,
    xlstm_chunk=128,
)

SMOKE = FULL.replace(
    n_layers=6, d_model=64, n_heads=4, vocab=256, dtype="float32",
    remat=False, xlstm_chunk=16,
)

register(FULL, SMOKE)
