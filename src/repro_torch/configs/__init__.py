"""Architecture configs of the port.

Importing this package registers each arch in ``base.REGISTRY`` (full
config) and ``base.SMOKE_REGISTRY`` (reduced config of the same family): the
reference's ten, whisper-large-v3 (encdec), the dense family (llama3.2-1b,
gemma-7b, command-r-35b), the MoE family (phi3.5-moe, qwen3-moe),
minicpm3-4b (MLA), internvl2-1b (vlm), jamba-v0.1-52b (hybrid: attention,
Mamba and MoE) and xlstm-350m (mLSTM and sLSTM).
"""
from .base import REGISTRY, SMOKE_REGISTRY, ModelConfig, get_config, register

from . import (command_r_35b, gemma_7b, internvl2_1b, jamba_v01_52b, llama32_1b,
               minicpm3_4b, phi35_moe_42b, qwen3_moe_235b_a22b, whisper_large_v3,
               xlstm_350m)

ALL_ARCHS = tuple(sorted(REGISTRY))
