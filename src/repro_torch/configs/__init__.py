"""Architecture configs of the port.

Importing this package registers each ported arch in ``base.REGISTRY`` (full
config) and ``base.SMOKE_REGISTRY`` (reduced config of the same family).  The
port registers eight of the reference's ten archs: whisper-large-v3, the dense
family (llama3.2-1b, gemma-7b, command-r-35b), the MoE family (phi3.5-moe,
qwen3-moe), minicpm3-4b (MLA) and internvl2-1b (vlm).  jamba (hybrid) and
xlstm arrive with their mixers.
"""
from .base import REGISTRY, SMOKE_REGISTRY, ModelConfig, get_config, register

from . import (command_r_35b, gemma_7b, internvl2_1b, llama32_1b, minicpm3_4b,
               phi35_moe_42b, qwen3_moe_235b_a22b, whisper_large_v3)

ALL_ARCHS = tuple(sorted(REGISTRY))
