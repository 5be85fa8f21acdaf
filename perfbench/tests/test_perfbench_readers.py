"""The per-layer readers and the trace arithmetic on small traces written by hand."""
from types import SimpleNamespace

import pytest

from perfbench.harness import Readings
from perfbench.peaks import H100_SXM
from perfbench.probes import AttnCall
from perfbench.spec import Spec
from perfbench.trace import Activity, Span, Trace, from_profiler

# a 10 s window: one prefill range holding one attention range, two decode steps
HOST = [Span("perfbench.window", 0.0, 10.0),
        Span("perfbench.prefill", 0.5, 3.0),
        Span("perfbench.attn.prefill", 1.0, 2.0),
        Span("aten::einsum", 1.1, 1.2),
        Span("perfbench.decode_step", 4.0, 6.0),
        Span("perfbench.moe.decode_step", 4.5, 5.0),
        Span("aten::bmm", 4.6, 4.7),
        Span("perfbench.decode_step", 7.0, 9.0),
        Span("perfbench.moe.decode_step", 7.5, 8.0),
        Span("aten::sort", 8.5, 8.9)]
DEVICE = [Activity("gemm", 0.6, 1.0, 0.55),          # prefill, outside attention
          Activity("flash", 1.2, 1.6, 1.1),          # launched inside the attention range
          Activity("flash", 1.5, 1.8, 2.0),          # overlaps the one before; anchor at the end
          Activity("bmm", 4.7, 5.2, 4.6),            # inside the first MoE range
          Activity("bmm", 7.6, 7.9, 7.7),            # inside the second
          Activity("copy", 8.6, 8.8, 8.6),           # decode, outside MoE
          Activity("orphan", 9.5, 9.6, None)]        # no host anchor
TRACE = Trace(window=10.0, device=DEVICE, host=HOST)


def readings(**kw):
    base = dict(window_s=20.0, requests=10, model_flops=989e12 * 2.0, peaks=H100_SXM,
                decode_host_s=[0.01, 0.03], prefill_s=[0.5, 1.5], prefill_flops=989e12 * 0.1,
                trace=TRACE,
                attn_calls=[AttnCall("prefill", 2, 4, 2, 8, 8, 16, True, None, 2),
                            AttnCall("decode_step", 2, 4, 2, 1, 9, 16, True, 8, 2)],
                traced_decode_steps=2)
    base.update(kw)
    return Readings(**base)


def test_busy_union_and_device_time_under_ranges():
    assert TRACE.busy_intervals() == [(0.6, 1.0), (1.2, 1.8), (4.7, 5.2), (7.6, 7.9),
                                      (8.6, 8.8), (9.5, 9.6)]
    assert TRACE.busy_s() == pytest.approx(0.4 + 0.6 + 0.5 + 0.3 + 0.2 + 0.1)
    assert TRACE.device_time_under("perfbench.attn.prefill") == pytest.approx(0.4 + 0.3)
    assert TRACE.device_time_under("perfbench.moe.decode_step") == pytest.approx(0.5 + 0.3)
    assert TRACE.device_time_under("perfbench.prefill") == pytest.approx(0.4 + 0.4 + 0.3)
    assert TRACE.device_time_under("perfbench.nothing") == 0.0


def test_top_ops_and_idle_gaps_by_host_activity():
    top = dict((k, v) for k, v in TRACE.top_device_ops())
    assert top["flash"] == pytest.approx(0.7) and top["bmm"] == pytest.approx(0.8)
    gaps = dict((k, v) for k, v in TRACE.idle_gaps())
    assert sum(gaps.values()) == pytest.approx(10.0 - TRACE.busy_s())
    # each gap goes to the innermost range and host event open when it began
    assert gaps["perfbench.window | -"] == pytest.approx(0.6 + 0.4)
    assert gaps["perfbench.attn.prefill | -"] == pytest.approx(0.2 + 2.9)
    assert gaps["perfbench.decode_step | -"] == pytest.approx(2.4)
    assert gaps["perfbench.moe.decode_step | -"] == pytest.approx(0.7)
    assert gaps["perfbench.decode_step | aten::sort"] == pytest.approx(0.7)


@pytest.fixture(scope="module")
def read(tiny_root):
    spec = Spec(tiny_root)
    return lambda name, r: spec.reader(name)(r)


def test_readers_by_hand(read):
    r = readings()
    assert read("host_issue_ms.decode", r) == pytest.approx(20.0)
    assert read("mfu", r) == pytest.approx(10.0)
    assert read("device_idle_share", r) == pytest.approx(100 * (1 - 2.1 / 10.0))
    assert read("moe_device_ms.decode", r) == pytest.approx(1e3 * 0.8 / 2)
    ops = 4 * 2 * 4 * 16 * (8 * 9 // 2)
    nbytes = 2 * (2 * 2 * 4 * 8 * 16 + 2 * 2 * 2 * 8 * 16)
    bound = max(ops / 989e12, nbytes / 3.35e12)
    assert read("attn_roofline.prefill", r) == pytest.approx(100 * bound / 0.7)
    assert read("attn_roofline.prefill.audio", r) == read("attn_roofline.prefill", r)
    assert read("mfu.prefill", r) == pytest.approx(100 * 0.1 * 2 / 2.0)
    assert read("mfu.prefill.audio", r) == read("mfu.prefill", r)


def test_readers_find_nothing_to_read(read):
    empty = readings(decode_host_s=[], trace=None, attn_calls=[], traced_decode_steps=0,
                     peaks={}, prefill_s=[])
    for name in ("host_issue_ms.decode", "mfu", "device_idle_share", "moe_device_ms.decode",
                 "attn_roofline.prefill", "attn_roofline.prefill.audio", "mfu.prefill",
                 "mfu.prefill.audio"):
        assert read(name, empty) is None
    # kernels, but none launched inside an MoE or attention range
    outside = readings(trace=Trace(10.0, [Activity("gemm", 1, 2, 0.2)], HOST[:3]))
    assert read("moe_device_ms.decode", outside) is None
    assert read("attn_roofline.prefill", outside) is None


class _Event:
    def __init__(self, name, dev, start, end, corr=0, linked=0, thread=1, ann=False):
        self._v = (name, dev, start, end, corr, linked, thread, ann)

    def name(self): return self._v[0]
    def device_type(self): return self._v[1]
    def start_ns(self): return self._v[2]
    def end_ns(self): return self._v[3]
    def correlation_id(self): return self._v[4]
    def linked_correlation_id(self): return self._v[5]
    def start_thread_id(self): return self._v[6]
    def is_user_annotation(self): return self._v[7]


def test_from_profiler_links_kernels_to_their_host_events():
    from torch.autograd import DeviceType

    cpu, gpu = DeviceType.CPU, DeviceType.CUDA
    t0 = 10_000
    events = [_Event("perfbench.window", cpu, t0, t0 + 10_000, corr=1, ann=True),
              _Event("perfbench.attn.prefill", cpu, t0 + 1000, t0 + 2000, corr=2, ann=True),
              _Event("aten::mm", cpu, t0 + 1100, t0 + 1200, corr=3),
              _Event("cudaLaunchKernel", cpu, t0 + 1110, t0 + 1150, corr=90, linked=3),
              _Event("gemm", gpu, t0 + 1300, t0 + 1500, corr=90, linked=3),
              _Event("flash", gpu, t0 + 1600, t0 + 1900, corr=91, linked=2),
              _Event("perfbench.attn.prefill", gpu, t0 + 1300, t0 + 1900, ann=True),
              _Event("other_thread_op", cpu, t0 + 3000, t0 + 3100, corr=4, thread=2),
              _Event("late", gpu, t0 + 3200, t0 + 3300, corr=92, linked=4),
              _Event("before", gpu, t0 - 500, t0 - 100, corr=93, linked=0)]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    tr = from_profiler(prof)
    assert tr.window == pytest.approx(1e-5)
    assert [a.name for a in tr.device] == ["gemm", "flash", "late"]
    assert tr.device_time_under("perfbench.attn.prefill") == pytest.approx(5e-7)
    assert tr.device[2].anchor is None
    assert {s.name for s in tr.host} == {"perfbench.window", "perfbench.attn.prefill",
                                          "aten::mm", "cudaLaunchKernel"}
    assert from_profiler(SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events[2:])))) is None
