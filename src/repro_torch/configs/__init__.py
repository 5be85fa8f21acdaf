"""Architecture configs of the port.

Importing this package registers each ported arch in ``base.REGISTRY`` (full
config) and ``base.SMOKE_REGISTRY`` (reduced config of the same family).  The
port registers whisper-large-v3 only; the reference's other nine archs arrive
with their families.
"""
from .base import REGISTRY, SMOKE_REGISTRY, ModelConfig, get_config, register

from . import whisper_large_v3

ALL_ARCHS = tuple(sorted(REGISTRY))
