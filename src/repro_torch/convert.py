"""Carry the reference's state across to the port, from numpy alone.

The state is the BMVM LUT, the LDPC edge index, the particle filter's
reference histogram, `NoCStats`, the LM stack's parameter tree and the AdamW
state.  Each
``*_to_torch`` has a ``*_to_numpy`` inverse, and the pair round-trips exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from ._device import resolve_device
from ._tree import tree_map
from .apps.ldpc import EdgeIndex
from .core.noc import NoCStats


def lut_to_torch(lut: np.ndarray, device="cuda") -> torch.Tensor:
    """Reference LUT (C, 2^k, R) uint32 → the port's int32 word tensor (the
    words are k-bit, k ≤ 16, so the bit patterns are unchanged)."""
    lut = np.asarray(lut)
    if lut.dtype != np.uint32 or lut.ndim != 3:
        raise TypeError(f"expected a (C, 2^k, R) uint32 LUT, got {lut.shape}/{lut.dtype}")
    if lut.size and int(lut.max()) >= 1 << 16:
        raise ValueError("LUT words wider than 16 bits")
    return torch.as_tensor(lut.astype(np.int32), device=resolve_device(device))


def lut_to_numpy(lut: torch.Tensor) -> np.ndarray:
    return lut.cpu().numpy().astype(np.uint32)


_EDGE_FIELDS = ("H", "check_edges", "bit_edges", "edge_bit", "n_edges")


def edge_index_to_torch(fields: Mapping) -> EdgeIndex:
    """The reference ``EdgeIndex`` fields (as a mapping of numpy arrays, e.g.
    ``dataclasses.asdict`` of it) → the port's `EdgeIndex`."""
    missing = set(_EDGE_FIELDS) - set(fields)
    if missing:
        raise KeyError(f"EdgeIndex fields missing: {sorted(missing)}")
    return EdgeIndex(np.array(fields["H"]), np.array(fields["check_edges"]),
                     np.array(fields["bit_edges"]), np.array(fields["edge_bit"]),
                     int(fields["n_edges"]))


def edge_index_to_numpy(idx: EdgeIndex) -> dict:
    return {f: getattr(idx, f) for f in _EDGE_FIELDS}


def ref_hist_to_torch(hist: np.ndarray, device="cuda") -> torch.Tensor:
    """Particle-filter reference histogram (n_bins,) → float32 tensor."""
    return torch.as_tensor(np.array(hist, np.float32), device=resolve_device(device))


def ref_hist_to_numpy(hist: torch.Tensor) -> np.ndarray:
    return hist.cpu().numpy()


def stats_to_torch(d: Mapping[str, int]) -> NoCStats:
    """A reference ``NoCStats.as_dict()`` → `NoCStats`; the field sets must agree."""
    names = {f.name for f in dataclasses.fields(NoCStats)}
    if set(d) != names:
        raise KeyError(f"NoCStats fields differ: missing {sorted(names - set(d))}, "
                       f"unknown {sorted(set(d) - names)}")
    return NoCStats(**{k: int(v) for k, v in d.items()})


def stats_to_numpy(stats: NoCStats) -> dict:
    return stats.as_dict()


def model_params_to_torch(tree: Mapping, device="cuda") -> dict:
    """The reference's model params (a nested dict of arrays, e.g.
    ``jax.tree.map(np.asarray, params)``) → the port's dict of float tensors,
    key for key and shape for shape (``blocks``/``enc_blocks`` keep their
    leading stacked-layers axis)."""
    dev = resolve_device(device)

    def leaf(path, x):
        if isinstance(x, Mapping):
            return {k: leaf(f"{path}/{k}", v) for k, v in x.items()}
        arr = np.asarray(x)
        if arr.dtype.kind != "f":
            raise TypeError(f"param {path} must be floating point, got {arr.dtype}")
        return torch.as_tensor(np.array(arr), device=dev)
    return leaf("", tree)


def model_params_to_numpy(tree: Mapping) -> dict:
    """Inverse of `model_params_to_torch`."""
    return tree_map(lambda t: t.cpu().numpy(), tree)


def opt_state_to_torch(state: Mapping, device="cuda") -> dict:
    """The reference's AdamW state ``{"m", "v", "step"}`` (numpy, e.g.
    ``jax.tree.map(np.asarray, opt)``) → the port's: ``m``/``v`` trees of
    float32 tensors and a 0-d int32 ``step``."""
    if set(state) != {"m", "v", "step"}:
        raise KeyError(f"AdamW state keys must be m, v, step; got {sorted(state)}")
    return {"m": model_params_to_torch(state["m"], device),
            "v": model_params_to_torch(state["v"], device),
            "step": torch.as_tensor(np.array(state["step"], np.int32),
                                    device=resolve_device(device))}


def opt_state_to_numpy(state: Mapping) -> dict:
    """Inverse of `opt_state_to_torch`."""
    return {"m": model_params_to_numpy(state["m"]), "v": model_params_to_numpy(state["v"]),
            "step": state["step"].cpu().numpy()}
