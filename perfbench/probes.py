"""What the harness records around the program's calls, from its own files.

`Recorder` is the ``reg`` that ``serve_batch`` observes its synchronised
prefill and decode samples into (``reg.histogram(name).observe(x)``); it keeps
every raw sample, so a percentile is taken from the samples and not from a
histogram's buckets.

`Capture` wraps ``transformer.prefill`` and ``transformer.decode_step`` in
every run and holds the logits each returns for the batch being served, so
the check can judge what the timed path produced (`check.Sample` keeps a
few batches' worth); it launches nothing on the device.

`Probes` wraps, for a traced run only, the module attributes through which the
serve path calls each layer, and restores them on exit:

* ``transformer.prefill`` and ``transformer.decode_step`` (``serve_batch``
  looks them up on the module): the host time from call to return of each
  decode step (`host_issue_ms.decode`), and, while the profiler runs, ranges
  ``perfbench.prefill`` and ``perfbench.decode_step``;
* the attention cores, ``kernels.ops.flash_attention``, ``attention._naive``
  and ``attention._blocked``: a range ``perfbench.attn.<phase>`` and the call's
  shape (`attn_roofline.prefill`); a core called inside another is counted
  once, by the outer one;
* ``moe.moe_apply`` (``transformer`` calls ``moe_mod.moe_apply``): a range
  ``perfbench.moe.<phase>`` (`moe_device_ms.decode`).
"""
from __future__ import annotations

import dataclasses
import time
from contextlib import nullcontext

PREFIX = "perfbench."
# where kv_len and q_offset sit among the arguments after ``causal``:
# attention._naive(q, k, v, causal, kv_len, softcap, q_offset, ...) and
# attention._blocked(q, k, v, causal, kv_len, bkv, softcap, q_offset, ...)
_ARG_POS = {"naive": (0, 2), "blocked": (0, 3)}


class _Samples:
    def __init__(self):
        self.values: list[float] = []

    def observe(self, x: float) -> None:
        self.values.append(float(x))


class Recorder:
    """A metrics registry that keeps every sample: ``serve.prefill.seconds``
    and ``serve.decode.seconds`` from ``serve_batch``."""

    def __init__(self):
        self._h: dict[str, _Samples] = {}

    def histogram(self, name: str) -> _Samples:
        return self._h.setdefault(name, _Samples())

    def samples(self, name: str) -> list[float]:
        return list(self._h[name].values) if name in self._h else []


class _Patches:
    """Module attributes replaced while installed, restored on exit (last first)."""

    def __init__(self):
        self._saved: list[tuple[object, str, object]] = []

    def _patch(self, mod, attr: str, make):
        orig = getattr(mod, attr)
        self._saved.append((mod, attr, orig))
        setattr(mod, attr, make(orig))

    def __exit__(self, *exc):
        for mod, attr, orig in reversed(self._saved):
            setattr(mod, attr, orig)
        self._saved.clear()
        return False


class Capture(_Patches):
    """Install with ``with Capture() as cap:``; ``cap.take()`` hands over the
    logits of the batch served since the last take: prefill's last position,
    then each decode step's, (B, V) each, the tensors ``serve_batch`` picks
    its tokens from."""

    def __init__(self):
        super().__init__()
        self._logits: list = []

    def take(self) -> list:
        out, self._logits = self._logits, []
        return out

    def __enter__(self):
        from repro_torch.models import transformer as T

        def make(orig):
            def wrapped(*a, **k):
                out = orig(*a, **k)
                lg = out[0]
                self._logits.append(lg[:, -1] if lg.dim() == 3 else lg)
                return out
            return wrapped

        self._patch(T, "prefill", make)
        self._patch(T, "decode_step", make)
        return self


@dataclasses.dataclass(frozen=True)
class AttnCall:
    phase: str
    B: int
    Hq: int
    Hkv: int
    S: int
    T: int
    D: int
    causal: bool
    q_offset: int | None
    itemsize: int


class Probes(_Patches):
    """Install with ``with Probes(ranges=...) as p:``.  The host timing of
    decode steps is on while installed; ``ranges`` (under the profiler) adds
    the ``record_function`` ranges and the attention and MoE wrappers."""

    def __init__(self, ranges: bool = False):
        super().__init__()
        self.ranges = ranges
        self.decode_host_s: list[float] = []
        self.attn_calls: list[AttnCall] = []
        self.decode_steps = 0
        self.phase = "other"
        self._inside_core = False

    def _range(self, name: str):
        if not self.ranges:
            return nullcontext()
        import torch

        return torch.profiler.record_function(PREFIX + name)

    def __enter__(self):
        from repro_torch.kernels import ops as kops
        from repro_torch.models import attention, moe
        from repro_torch.models import transformer as T

        def phase_fn(name, timed):
            def make(orig):
                def wrapped(*a, **k):
                    self.phase = name
                    with self._range(name):
                        t0 = time.perf_counter()
                        out = orig(*a, **k)
                        if timed:
                            self.decode_host_s.append(time.perf_counter() - t0)
                            self.decode_steps += 1
                    self.phase = "other"
                    return out
                return wrapped
            return make

        def core(kind):
            def make(orig):
                def wrapped(q, k, v, causal, *rest, **kw):
                    if self._inside_core:
                        return orig(q, k, v, causal, *rest, **kw)
                    kv_len = q_off = None
                    if kind in _ARG_POS:         # (q, k, v, causal, kv_len, ..., q_offset)
                        i_len, i_off = _ARG_POS[kind]
                        kv_len = rest[i_len] if len(rest) > i_len else kw.get("kv_len")
                        q_off = rest[i_off] if len(rest) > i_off else kw.get("q_offset")
                    B, Hq, S, D = q.shape
                    T = k.shape[2] if kv_len is None else int(kv_len)
                    self.attn_calls.append(AttnCall(self.phase, B, Hq, k.shape[1], S, T, D,
                                                    bool(causal), q_off, q.element_size()))
                    self._inside_core = True
                    try:
                        with self._range(f"attn.{self.phase}"):
                            return orig(q, k, v, causal, *rest, **kw)
                    finally:
                        self._inside_core = False
                return wrapped
            return make

        def moe_fn(orig):
            def wrapped(*a, **k):
                with self._range(f"moe.{self.phase}"):
                    return orig(*a, **k)
            return wrapped

        self._patch(T, "prefill", phase_fn("prefill", False))
        self._patch(T, "decode_step", phase_fn("decode_step", True))
        if self.ranges:
            self._patch(kops, "flash_attention", core("flash"))
            self._patch(attention, "_naive", core("naive"))
            self._patch(attention, "_blocked", core("blocked"))
            self._patch(moe, "moe_apply", moe_fn)
        return self
