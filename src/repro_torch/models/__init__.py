"""Model zoo of the port: config-driven architectures assembled in
transformer.py (every family of the reference: dense, encdec, moe, hybrid,
xlstm and vlm, with the MLA, Mamba, mLSTM and sLSTM mixers; served and
trained)."""
from . import attention, layers, mla, moe, ssm, transformer, xlstm
from .moe import MoEConfig, MoEDispatchStats, dispatch_capacity
from .transformer import abstract_params, decode_step, forward, init_cache, loss, prefill
