"""Architecture configs of the port.

Importing this package registers each ported arch in ``base.REGISTRY`` (full
config) and ``base.SMOKE_REGISTRY`` (reduced config of the same family).  The
port registers whisper-large-v3 and the dense family (llama3.2-1b, gemma-7b,
command-r-35b); the reference's other six archs arrive with their families.
"""
from .base import REGISTRY, SMOKE_REGISTRY, ModelConfig, get_config, register

from . import command_r_35b, gemma_7b, llama32_1b, whisper_large_v3

ALL_ARCHS = tuple(sorted(REGISTRY))
