"""Model zoo of the port: config-driven architectures assembled in
transformer.py (the dense and encdec families, served and trained)."""
from . import attention, layers, transformer
from .transformer import abstract_params, decode_step, forward, init_cache, loss, prefill
