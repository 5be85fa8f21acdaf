"""Model zoo of the port: config-driven architectures assembled in
transformer.py (the dense, encdec, moe and vlm families and the MLA mixer,
served and trained)."""
from . import attention, layers, mla, moe, transformer
from .moe import MoEConfig, MoEDispatchStats, dispatch_capacity
from .transformer import abstract_params, decode_step, forward, init_cache, loss, prefill
