"""Roofline terms from one rank's counted program (counterpart of
``repro/launch/roofline.py``).

Three terms per (arch × shape × mesh), in seconds, for one rank:

  compute    = FLOPs_per_rank / PEAK_FLOPS
  memory     = bytes_per_rank / HBM_BW
  collective = Σ collective_bytes_per_rank / (LINKS · LINK_BW)

The constants are the card's the port runs on, an NVIDIA H100 80GB HBM3 (SXM,
700 W): 989 TFLOP/s dense bf16 on the tensor cores, 3.35 TB/s of HBM3, and 18
NVLink 4 links of 25 GB/s each way.  The collective term keeps the
reference's shape, every link of the rank busy at once; an axis whose rows
span two 8-GPU nodes crosses the nodes' network instead, which runs slower
than this, so there the term is a lower bound.

The reference reads its terms from XLA (``cost_analysis()`` and the post-SPMD
HLO text).  The port counts what one rank's eager program dispatches:
:class:`CostCounter`, a ``TorchDispatchMode``, sees every aten op and every
custom op of the rank (its backward too), under real tensors or fake ones
alike, and counts

* ``flops``: ``torch.utils.flop_counter``'s registered formulas (matmuls,
  ``bmm``, ``addmm``, ``baddbmm``, convolutions, SDPA) and the formulas the
  port registers for its kernels (``kernels/flash_attention.py``: the flash
  forward counts 4·B·Hq·S·T·D).  As in ``FlopCounterMode``, elementwise ops count nothing
  (XLA counts them: the port's count is the lower one), and an op with no
  formula is decomposed where it can be and its parts counted.
* ``bytes``: the reference's fusion-aware convention (``fusion_aware_bytes``)
  carried over to aten ops: 2× the output bytes of every anchor op (matmuls
  and attention, reductions, gather, index and scatter ops, slice writes and
  copies, ``cat``/``stack``, ``sort``/``topk``, ``cumsum``, the port's
  kernels), plus the bytes of the program's arguments (state, batch, cache),
  counted once (:meth:`CostCounter.add_arguments`).  Elementwise chains are
  taken to fuse into their anchor, as on the reference's chip.
* ``bytes_raw``: the inputs and outputs of every op but views (the
  counterpart of XLA's "bytes accessed").
* collectives, by their meaning (`core.collectives.count_collectives`): each
  at its output bytes under the HLO name of the reference's parser
  (``all-reduce``, ``all-gather``, ``reduce-scatter``, ``all-to-all``,
  ``collective-permute``), with ``n_ops``.  A psum counts at its output bytes
  although the transport runs it as an all-gather and an add.

Eager dispatch runs every trip of every loop, so the count of a program at
full depth is exact and needs no trip-count correction; :func:`extrapolate`
keeps the reference's depth-1/depth-2 arithmetic, and the dry run fills its
fields (``roofline_corrected``) from the one full-depth count.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import weakref
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from .._tree import leaves
from ..core import collectives as coll

PEAK_FLOPS = 989e12          # bf16 dense, tensor cores, per H100 SXM
HBM_BW = 3.35e12             # bytes/s of HBM3 per H100 SXM
LINK_BW = 25e9               # bytes/s per NVLink 4 link, each way
LINKS = 18                   # NVLink 4 links per H100 SXM

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

_aten = torch.ops.aten
# ops whose output is taken to be materialized in memory (a fusion's anchor)
_ANCHOR_NAMES = (
    # matmuls, convolutions, attention
    "mm", "addmm", "bmm", "baddbmm", "_scaled_mm", "convolution", "_convolution",
    "convolution_backward", "_scaled_dot_product_efficient_attention",
    "_scaled_dot_product_flash_attention", "_scaled_dot_product_cudnn_attention",
    "_scaled_dot_product_efficient_attention_backward",
    "_scaled_dot_product_flash_attention_backward",
    "_scaled_dot_product_cudnn_attention_backward",
    # reductions
    "sum", "mean", "amax", "amin", "max", "min", "prod", "var", "std", "var_mean",
    "argmax", "argmin", "any", "all", "norm", "linalg_vector_norm", "logsumexp",
    "_softmax", "_log_softmax", "_softmax_backward_data", "_log_softmax_backward_data",
    # gather, index, scatter
    "index", "index_select", "gather", "scatter", "scatter_add", "scatter_reduce",
    "index_add", "index_put", "index_copy", "embedding", "embedding_dense_backward",
    "_unsafe_index", "_unsafe_index_put", "index_put_", "scatter_", "scatter_add_",
    "index_add_", "_index_put_impl_", "masked_scatter",
    # slice writes and copies
    "slice_scatter", "select_scatter", "as_strided_scatter", "copy_", "copy",
    # concatenation, sorting, scans
    "cat", "stack", "sort", "topk", "argsort", "cumsum", "cumprod",
)
_ANCHORS = frozenset(getattr(_aten, n) for n in _ANCHOR_NAMES if hasattr(_aten, n))
# the port's kernels, as custom ops (``kernels/flash_attention.py``): anchors too
KERNEL_OPS = frozenset({"repro_torch.flash_attention"})

# metadata queries: nothing computed, nothing moved (``FlopCounterMode``'s list)
_METADATA = frozenset({
    _aten.sym_is_contiguous.default, _aten.is_contiguous.default,
    _aten.is_contiguous.memory_format, _aten.is_strides_like_format.default,
    _aten.is_non_overlapping_and_dense.default, _aten.size.default,
    _aten.sym_size.default, _aten.stride.default, _aten.sym_stride.default,
    _aten.storage_offset.default, _aten.sym_storage_offset.default,
    _aten.numel.default, _aten.sym_numel.default, _aten.dim.default,
    torch.ops.prim.layout.default, torch.ops.prim.device.default})


def tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


class CostCounter(TorchDispatchMode):
    """Count one rank's program: ``with CostCounter() as c: step(...)``, then
    :meth:`totals`.  Enter it inside a ``FakeTensorMode`` to count a program
    on fake tensors: the counter sees each op before the fake mode does.

    It also keeps the high-water mark of the live storages the program
    allocates (``temp_peak_bytes``), each storage counted once from the op
    that first returns it until its last tensor is freed; storages of the
    arguments given to :meth:`add_arguments` are not temporaries."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0.0
        self.bytes_raw = 0.0
        self.argument_bytes = 0
        self.coll = {k: 0 for k in _COLLECTIVES}
        self.coll["n_ops"] = 0
        self.ops: collections.Counter = collections.Counter()
        self.live_bytes = 0
        self.temp_peak_bytes = 0
        self._live: dict[int, int] = {}
        self._args: set[int] = set()
        self._suspended = 0
        self._depth = 0
        self._coll_ctx = None

    # -- entering (re-entered inside __torch_dispatch__ to decompose an op) --
    def __enter__(self):
        if self._depth == 0:
            self._coll_ctx = coll.count_collectives(self)
            self._coll_ctx.__enter__()
        self._depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._depth -= 1
            if self._depth == 0:
                self._coll_ctx.__exit__(*exc)
                self._coll_ctx = None

    @contextlib.contextmanager
    def suspended(self):
        """Count nothing inside the block (a collective's transport)."""
        self._suspended += 1
        try:
            yield
        finally:
            self._suspended -= 1

    # -- what is counted --------------------------------------------------
    def add_arguments(self, tree) -> None:
        """The program's arguments: their bytes are read once (``bytes``),
        and their storages are not temporaries."""
        for t in leaves(tree):
            if isinstance(t, torch.Tensor):
                key = t.untyped_storage()._cdata
                if key not in self._args:
                    self._args.add(key)
                    self.argument_bytes += t.untyped_storage().nbytes()
                self.bytes += tensor_bytes(t)

    def collective(self, kind: str, out: torch.Tensor) -> None:
        self.coll[kind] += tensor_bytes(out)
        self.coll["n_ops"] += 1
        self._track(out)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live or key in self._args:
            return
        n = st.nbytes()
        self._live[key] = n
        self.live_bytes += n
        self.temp_peak_bytes = max(self.temp_peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._suspended or func in _METADATA:
            return func(*args, **kwargs)
        packet = func._overloadpacket
        if packet not in flop_registry:
            # an op with no formula whose parts may have one (FlopCounterMode's rule)
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs, out_val=out))
        outs = _tensors(out)
        out_bytes = sum(tensor_bytes(t) for t in outs)
        if not func.is_view:
            self.bytes_raw += sum(tensor_bytes(t) for t in _tensors((args, kwargs))) + out_bytes
        name = str(packet)
        if packet in _ANCHORS or name in KERNEL_OPS:
            self.bytes += 2.0 * out_bytes
        self.ops[name] += 1
        for t in outs:
            self._track(t)
        return out

    # -- results ----------------------------------------------------------
    @property
    def coll_bytes(self) -> int:
        return sum(self.coll[k] for k in _COLLECTIVES)

    def totals(self) -> dict:
        """The reference's ``_cost_of`` record: flops, fusion-aware bytes,
        raw bytes, collective bytes and collective ops."""
        return {"flops": float(self.flops), "bytes": float(self.bytes),
                "bytes_raw": float(self.bytes_raw), "coll_bytes": float(self.coll_bytes),
                "coll_ops": int(self.coll["n_ops"])}


@dataclasses.dataclass
class Roofline:
    flops_per_chip: float
    bytes_per_chip: float
    collective_bytes_per_chip: float
    collective_ops: int
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops_global: float
    useful_flops_frac: float
    peak_fraction: float          # useful model FLOPs/chip/peak vs dominant term

    def as_dict(self):
        return dataclasses.asdict(self)


def analyze(cost: dict, *, n_chips: int, model_flops_global: float,
            mem_bytes_override: Optional[float] = None) -> Roofline:
    """The reference's ``analyze`` over a :meth:`CostCounter.totals` record
    (in place of a compiled artifact and its HLO): the memory term reads the
    raw bytes, as the reference reads "bytes accessed", unless overridden."""
    flops = float(cost["flops"])
    byts = float(mem_bytes_override if mem_bytes_override is not None else cost["bytes_raw"])
    cbytes = float(cost["coll_bytes"])
    compute_s = flops / PEAK_FLOPS
    memory_s = byts / HBM_BW
    collective_s = cbytes / (LINKS * LINK_BW)
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    dominant = max(terms, key=terms.get)
    useful = model_flops_global / n_chips / max(flops, 1.0)
    step_time = max(compute_s, memory_s, collective_s)
    ideal = (model_flops_global / n_chips) / PEAK_FLOPS
    return Roofline(flops, byts, cbytes, int(cost["coll_ops"]), compute_s, memory_s,
                    collective_s, dominant, model_flops_global,
                    min(useful, 1.0), (ideal / step_time) if step_time > 0 else 0.0)


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N_active·D for train, 2·N_active·D forward-only."""
    n_active = cfg.active_param_count()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n_active * tokens


def extrapolate(c1: dict, c2: dict, n_periods: int, *, n_chips: int,
                model_flops_global: float) -> dict:
    """Affine depth correction: cost(P) = c0 + P·Δ from the depth-1 and
    depth-2 counts (the reference's arithmetic)."""
    out = {}
    full = {}
    for k in ("flops", "bytes", "coll_bytes"):
        delta = max(c2[k] - c1[k], 0.0)
        full[k] = c1[k] + (n_periods - 1) * delta
    compute_s = full["flops"] / PEAK_FLOPS
    memory_s = full["bytes"] / HBM_BW
    collective_s = full["coll_bytes"] / (LINKS * LINK_BW)
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    dominant = max(terms, key=terms.get)
    step_time = max(terms.values())
    ideal = (model_flops_global / n_chips) / PEAK_FLOPS
    out.update(flops_per_chip=full["flops"], bytes_per_chip=full["bytes"],
               collective_bytes_per_chip=full["coll_bytes"],
               compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
               dominant=dominant,
               model_flops_global=model_flops_global,
               useful_flops_frac=min((model_flops_global / n_chips) / max(full["flops"], 1.0), 1.0),
               peak_fraction=(ideal / step_time) if step_time > 0 else 0.0)
    return out
