"""Model configuration of the port: `ModelConfig` with the reference's fields
(``repro/configs/base.py``) and the per-arch registry.

``cdtype`` is a torch dtype.  `ShapeConfig` and `SHAPES` are the dry run's
input-shape cells; `input_specs` gives ``meta`` tensors (or fake ones, under
a ``FakeTensorMode``) where the reference gives ``ShapeDtypeStruct``\\ s.
"""
from __future__ import annotations

import dataclasses

import torch

# (mixer, ffn) kinds per sub-layer; a model is pattern × n_periods
MIXERS = ("attn", "mla", "mamba", "mlstm", "slstm")
FFNS = ("mlp", "moe", "none")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid | xlstm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    pattern: tuple[tuple[str, str], ...] = (("attn", "mlp"),)
    head_dim: int = 0                # 0 -> d_model // n_heads
    # attention
    qk_norm: bool = False
    rope_theta: float = 10000.0
    use_rope: bool = True
    attn_impl: str = "blocked"       # naive | blocked | flash
    attn_compute_dtype: str = "f32"  # f32 (baseline) | bf16 (opt: f32 accum)
    mla_absorb: bool = False         # MLA absorbed formulation (opt)
    pad_vocab: bool = False          # pad V to /256 so embed/head shard (opt)
    bkv: int = 512
    logit_softcap: float = 0.0
    # mlp
    act: str = "silu"                # silu | gelu (gelu => GeGLU when gated)
    gated_mlp: bool = True           # False: plain 2-layer MLP (whisper)
    # embeddings
    tie_embeddings: bool = False
    embed_scale: float = 1.0
    pos_embed: str = "rope"          # rope | sinusoidal
    norm_eps: float = 1e-6
    # moe
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    moe_impl: str = "gather"         # gather | noc | dense
    moe_topology: str = "fattree"    # fattree | ring | mesh2d | torus2d
    capacity_factor: float = 1.25
    moe_flit_buffer_depth: int = 0
    aux_weight: float = 0.01
    # mamba
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    mamba_chunk: int = 256
    # xlstm
    xlstm_proj_factor: float = 2.0
    xlstm_chunk: int = 128
    # encoder (enc-dec) / frontend (audio, vlm)
    n_enc_layers: int = 0
    enc_seq: int = 0                 # whisper: 1500 frames
    d_frontend: int = 0              # mel bins / ViT width
    n_patches: int = 0               # vlm prefix length
    # compute
    dtype: str = "bfloat16"
    serve_param_dtype: str = "float32"   # bfloat16 => serving reads bf16 params
    remat: bool = True
    analysis_unroll: bool = False    # unread (eager loops run every trip); kept so
                                     #   asdict equals the reference's
    seq_shard_kv: bool = False       # long-context: shard KV/state seq over 'data'

    @property
    def vocab_padded(self) -> int:
        return -(-self.vocab // 256) * 256 if self.pad_vocab else self.vocab

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_periods(self) -> int:
        if self.n_layers % len(self.pattern):
            raise ValueError(f"{self.name}: n_layers {self.n_layers} is not a multiple "
                             f"of the pattern length {len(self.pattern)}")
        return self.n_layers // len(self.pattern)

    @property
    def cdtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[self.dtype]

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        from ..models.layers import count_params
        from ..models.transformer import abstract_params
        return count_params(abstract_params(self))

    def active_param_count(self) -> int:
        """MoE: the params one token touches (for MODEL_FLOPS = 6·N_active·D):
        an expert-stacked weight counts top_k of its n_experts slices."""
        if not self.n_experts:
            return self.param_count()
        from .._tree import leaves
        from ..models.transformer import abstract_params
        total = 0
        for spec in leaves(abstract_params(self)):
            n = 1
            for s in spec.shape:
                n *= s
            if self.n_experts in spec.shape and "experts" in spec.axes:
                n = n // self.n_experts * self.top_k
            total += n
        return total


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def long_context_ok(cfg: ModelConfig) -> bool:
    """long_500k runs for SSM/hybrid archs; skipped for pure full-attention."""
    mixers = {m for m, _ in cfg.pattern}
    return bool(mixers & {"mamba", "mlstm", "slstm"})


def cell_supported(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    if shape.name == "long_500k" and not long_context_ok(cfg):
        return False, "pure full-attention arch: 500k dense-KV decode out of regime (per spec)"
    return True, ""


def input_specs(cfg: ModelConfig, shape: ShapeConfig, device="meta") -> dict:
    """Every model input of this cell as an uninitialized tensor on
    ``device`` (``meta``: shapes and dtypes, no storage): int32 tokens
    (and labels for train), decode's one new token ``(B, 1)``, whisper's
    ``frames`` and a vlm's ``patches`` (outside decode) in ``cdtype``."""
    B, S = shape.global_batch, shape.seq_len

    def tok(s):
        return torch.empty(s, dtype=torch.int32, device=device)
    if shape.kind == "train":
        specs = {"tokens": tok((B, S)), "labels": tok((B, S))}
    elif shape.kind == "prefill":
        specs = {"tokens": tok((B, S))}
    else:  # decode: one new token against a seq_len cache
        specs = {"tokens": tok((B, 1))}
    if cfg.family == "encdec":
        specs["frames"] = torch.empty((B, cfg.enc_seq, cfg.d_frontend), dtype=cfg.cdtype,
                                      device=device)
    if cfg.family == "vlm" and shape.kind != "decode":
        specs["patches"] = torch.empty((B, cfg.n_patches, cfg.d_frontend), dtype=cfg.cdtype,
                                       device=device)
    return specs


# registry filled by the per-arch modules
REGISTRY: dict[str, ModelConfig] = {}
SMOKE_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig, smoke: ModelConfig) -> ModelConfig:
    REGISTRY[cfg.name] = cfg
    SMOKE_REGISTRY[cfg.name] = smoke
    return cfg


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    from . import ALL_ARCHS  # noqa: F401  (import side effect: fill registry)
    reg = SMOKE_REGISTRY if smoke else REGISTRY
    if name not in reg:
        raise KeyError(f"unknown arch {name!r}; the port has {sorted(reg)}")
    return reg[name]
