"""Model zoo of the port: config-driven architectures assembled in
transformer.py (the whisper serve path so far)."""
from . import attention, layers, transformer
from .transformer import abstract_params, decode_step, forward, init_cache, prefill
