"""Quasi-SERDES link endpoints (paper §III, Fig. 6) — the analytic half.

The framing plan and wire accounting of ``repro.core.serdes`` (lines 33-103 and
201-218 there), which `NoCConfig.serdes` and the cross-pod counters need.  The
endpoints themselves (``encode``/``decode``/``send_over_link``) belong to the
partitioned-execution slice (ROADMAP Queue 1 item 7).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np


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


@dataclasses.dataclass
class LinkMeta:
    """Static metadata both endpoints agree on a priori."""

    shape: tuple[int, ...]
    dtype: Any
    n_words: int  # payload words of wire_bits each, incl. padding
    n_scale_words: int = 0


def plan(shape: tuple[int, ...], dtype, cfg: QuasiSerdesConfig) -> LinkMeta:
    """Compute the static framing plan for a message contract."""
    n = int(math.prod(shape)) if shape else 1
    wire_bytes = cfg.beat_bytes
    if cfg.compress == "none":
        payload = n * np.dtype(dtype).itemsize
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
    return LinkMeta(tuple(shape), np.dtype(dtype), n_words, scale_words)


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
