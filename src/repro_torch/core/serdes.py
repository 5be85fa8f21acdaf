"""Quasi-SERDES link endpoints (paper §III, Fig. 6).

An NoC link cut by the chip partition is replaced by a pair of endpoints
that frame each message into fixed-width wire words (``wire_bits`` of 8, 16
or 32), split into ``lanes`` serialized beats, optionally narrowed by a bf16
cast or int8 block quantization with an error-feedback residual.

The framing plan and wire accounting (``plan``, ``link_wire_beats``,
``link_bytes_on_wire``), the endpoints ``encode``/``decode`` on torch
tensors, and ``send_over_link`` across a cut of a device mesh, as
``repro.core.serdes`` has them.  Framing works on byte views: a message's
bytes are zero-padded to whole words and ``.view``-ed as the wire's unsigned
type, which is only ever viewed, never computed on (torch has no shifts,
``%`` or indexing on ``uint32``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch

from .collectives import MeshAxis, ppermute
from .graph import torch_dtype


@dataclasses.dataclass(frozen=True)
class QuasiSerdesConfig:
    """wire_bits: width of the physical flit word put on the link per beat.
    lanes: number of serialized beats a message is split into (1 = one shot).
    compress: 'none' | 'bf16' | 'int8'.
    block: quantization block size for int8 (per-block scale)."""

    wire_bits: int = 16
    lanes: int = 8
    compress: str = "none"
    block: int = 256

    def __post_init__(self):
        if self.wire_bits not in (8, 16, 32):
            raise ValueError(f"wire_bits must be 8, 16 or 32, got {self.wire_bits}")
        if self.compress not in ("none", "bf16", "int8"):
            raise ValueError(f"compress must be 'none', 'bf16' or 'int8', got {self.compress!r}")
        if self.lanes < 1:
            raise ValueError(f"lanes must be >= 1, got {self.lanes}")

    @property
    def beat_bytes(self) -> int:
        """Storage bytes of ONE wire word (a single-lane beat) — the same
        ceiling-division framing rule as ``NoCConfig.flit_wire_bytes``."""
        return -(-self.wire_bits // 8)

    def trace_args(self) -> dict:
        """Link description stamped on telemetry ``bridge_cfg`` events, so a
        trace is self-describing about the wire format it was recorded on."""
        return {"wire_bits": self.wire_bits, "lanes": self.lanes,
                "beat_bytes": self.beat_bytes, "compress": self.compress}


@dataclasses.dataclass
class LinkMeta:
    """Static metadata both endpoints agree on a priori."""

    shape: tuple[int, ...]
    dtype: Any
    n_words: int  # payload words of wire_bits each, incl. padding
    n_scale_words: int = 0


def _itemsize(dtype) -> int:
    return dtype.itemsize if isinstance(dtype, torch.dtype) else np.dtype(dtype).itemsize


def plan(shape: tuple[int, ...], dtype, cfg: QuasiSerdesConfig) -> LinkMeta:
    """Compute the static framing plan for a message contract (``dtype`` a
    numpy contract dtype or a torch dtype)."""
    n = int(math.prod(shape)) if shape else 1
    wire_bytes = cfg.beat_bytes
    if cfg.compress == "none":
        payload = n * _itemsize(dtype)
        scale_words = 0
    elif cfg.compress == "bf16":
        payload = n * 2
        scale_words = 0
    else:  # int8
        payload = n
        n_blocks = -(-n // cfg.block)
        scale_words = -(-n_blocks * 4 // wire_bytes)  # f32 scale per block
    n_words = -(-payload // wire_bytes)
    # pad words so they split evenly into lanes
    n_words = -(-n_words // cfg.lanes) * cfg.lanes
    scale_words = -(-scale_words // cfg.lanes) * cfg.lanes if scale_words else 0
    dtype = dtype if isinstance(dtype, torch.dtype) else np.dtype(dtype)
    return LinkMeta(tuple(shape), dtype, n_words, scale_words)


_WIRE_DTYPES = {8: torch.uint8, 16: torch.uint16, 32: torch.uint32}


def _bytes(x: torch.Tensor) -> torch.Tensor:
    """The bytes of ``x`` in memory order, as a flat uint8 view."""
    return x.contiguous().reshape(-1).view(torch.uint8)


def _frame(data: torch.Tensor, n_words: int, bits: int) -> torch.Tensor:
    """``data`` bytes framed into exactly ``n_words`` wire words: zero-padded
    to whole words (or cut at ``n_words``), viewed as the wire's type."""
    out = torch.zeros(n_words * (bits // 8), dtype=torch.uint8, device=data.device)
    k = min(data.numel(), out.numel())
    out[:k] = data[:k]
    return out.view(_WIRE_DTYPES[bits])


def encode(x: torch.Tensor, cfg: QuasiSerdesConfig, meta: LinkMeta,
           residual: Optional[torch.Tensor] = None):
    """→ (words (lanes, n_words // lanes), scale_words, new_residual), the
    words in the wire's unsigned type.

    residual: error-feedback accumulator (int8 mode); pass the previous step's
    value, keep the returned one."""
    bits = cfg.wire_bits
    scale_words = torch.zeros((cfg.lanes, meta.n_scale_words // cfg.lanes),
                              dtype=_WIRE_DTYPES[bits], device=x.device)
    new_residual = residual
    if cfg.compress == "none":
        payload = _bytes(x)
    elif cfg.compress == "bf16":
        payload = _bytes(x.to(torch.bfloat16))
    else:  # int8 block quantization + error feedback
        flat = x.to(torch.float32).reshape(-1)
        if residual is not None:
            flat = flat + residual
        padded = torch.nn.functional.pad(flat, (0, -flat.numel() % cfg.block))
        padded = padded.reshape(-1, cfg.block)
        scale = padded.abs().amax(1, keepdim=True) / 127.0
        safe = torch.where(scale > 0, scale, 1.0)
        q = torch.clamp(torch.round(padded / safe), -127, 127).to(torch.int8)
        deq = (q.to(torch.float32) * scale).reshape(-1)[:flat.numel()]
        new_residual = flat - deq
        payload = _bytes(q)
        scale_words = _frame(_bytes(scale), meta.n_scale_words, bits).reshape(cfg.lanes, -1)
    return _frame(payload, meta.n_words, bits).reshape(cfg.lanes, -1), scale_words, new_residual


def decode(words: torch.Tensor, scale_words: torch.Tensor, cfg: QuasiSerdesConfig,
           meta: LinkMeta) -> torch.Tensor:
    """Inverse of :func:`encode`: wire words → the message (``meta.shape`` in
    ``meta.dtype``)."""
    n = int(math.prod(meta.shape)) if meta.shape else 1
    dtype = meta.dtype if isinstance(meta.dtype, torch.dtype) else torch_dtype(meta.dtype)
    raw = _bytes(words)
    if cfg.compress == "none":
        return raw[:n * dtype.itemsize].view(dtype).reshape(meta.shape)
    if cfg.compress == "bf16":
        return raw[:n * 2].view(torch.bfloat16).reshape(meta.shape).to(dtype)
    # int8: the first n bytes are the quantized payload; re-pad to whole blocks
    n_blocks = -(-n // cfg.block)
    q = torch.nn.functional.pad(raw[:n].view(torch.int8), (0, n_blocks * cfg.block - n))
    scale = _bytes(scale_words)[:n_blocks * 4].view(torch.float32).reshape(-1, 1)
    deq = (q.reshape(-1, cfg.block).to(torch.float32) * scale).reshape(-1)[:n]
    return deq.reshape(meta.shape).to(dtype)


# ---------------------------------------------------------------------------
# link transfer (device-mesh execution, across the cut axis)
# ---------------------------------------------------------------------------

def send_over_link(x: torch.Tensor, axis: MeshAxis, perm, cfg: QuasiSerdesConfig,
                   meta: Optional[LinkMeta] = None, residual: Optional[torch.Tensor] = None,
                   serialized: bool = True):
    """Move ``x`` across the cut (e.g. pod to pod) through quasi-SERDES
    endpoints: encode, transfer over ``axis`` along ``perm`` (a
    `collectives.ppermute`, so a rank that no pair reaches decodes zeros),
    decode.

    serialized=True sends the ``lanes`` beats as separate transfers — the
    paper-faithful "8 bits at a time" behaviour; False sends the whole frame
    at once.  The scale words follow when the framing has any (int8).
    Returns (received, new_residual)."""
    meta = meta or plan(tuple(x.shape), x.dtype, cfg)
    words, scales, new_res = encode(x, cfg, meta, residual)
    if serialized:
        beats = [ppermute(words[i], axis, perm).view(torch.uint8) for i in range(cfg.lanes)]
        rwords = torch.stack(beats).view(words.dtype)
    else:
        rwords = ppermute(words, axis, perm)
    rscales = ppermute(scales, axis, perm) if meta.n_scale_words else scales
    return decode(rwords, rscales, cfg, meta), new_res


def link_wire_beats(shape, dtype, cfg: QuasiSerdesConfig) -> int:
    """Serialized wire beats (padded words incl. scale words) one message of
    this contract occupies on a cut link — ``lanes`` × per-lane words."""
    meta = plan(tuple(shape), dtype, cfg)
    return meta.n_words + meta.n_scale_words


def link_bytes_on_wire(shape, dtype, cfg: QuasiSerdesConfig) -> int:
    """Bytes that actually cross the narrow link."""
    return link_wire_beats(shape, dtype, cfg) * cfg.beat_bytes


def compression_ratio(shape, dtype, cfg: QuasiSerdesConfig) -> float:
    raw = int(math.prod(shape)) * np.dtype(dtype).itemsize
    return raw / max(1, link_bytes_on_wire(shape, dtype, cfg))
