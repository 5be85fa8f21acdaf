"""One run of one cell: set-up, the measured window, the traced section, the
correctness check, and the result's line.

The window drives ``repro_torch.launch.serve.serve_batch`` batch after batch,
closed loop (one batch in flight), until ``seconds`` have passed; it ends on a
whole batch.  Its metrics are all the work over all the time from the first
batch's start to the last batch's end:

* ``tokens_per_s``: generated tokens over the window's seconds;
* ``ttft_ms``: the mean of the prefill samples (every request of a batch
  shares its batch's), each from ``serve_batch``'s synchronised clock;
* ``itl_p95_ms``: the 95th percentile of all decode-step samples;
* ``setup_s``: from the start of the process to the first timed batch.

An end-to-end metric named ``<quantity>.<suffix>`` (``ttft_ms.audio``)
reports ``<quantity>`` in the cells it lists, under a bound of its own.

A traced run (``trace``) measures the same window with the host timing of
decode steps on (`probes.Probes`), then profiles whole batches for at least
``TRACE_SECONDS`` with the layer ranges on, and reports the per-layer
metrics, whose readers (``metrics/<name>.py``) take a `Readings`.
"""
from __future__ import annotations

import dataclasses
import sys
import time
from contextlib import nullcontext

import numpy as np

from . import check, flops
from .probes import Capture, Probes, Recorder
from .spec import Spec
from .trace import WINDOW, Trace
from .traffic import WARM, Mix, Traffic

TRACE_SECONDS = 2.0
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

# the port's ModelConfig field for each size the configuration file states
_FIELDS = {"d": "d_model", "layers": "n_layers", "heads": "n_heads", "kv_heads": "n_kv_heads",
           "head_dim": "hd", "vocab": "vocab", "experts": "n_experts", "top_k": "top_k",
           "expert_ff": "d_ff_expert", "enc_layers": "n_enc_layers", "enc_seq": "enc_seq",
           "d_frontend": "d_frontend"}


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is the JAX package's or JAX's own."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


@dataclasses.dataclass
class Readings:
    """What the per-layer readers take."""
    window_s: float                 # the measured window, host clock
    requests: int                   # requests finished in it
    model_flops: float              # operations they need (`flops.request_flops`)
    peaks: dict                     # the chip's table (`peaks.H100_SXM`)
    decode_host_s: list             # host time of each decode_step call of the window
    prefill_s: list                 # the window's prefill samples (one a batch)
    prefill_flops: float            # operations one batch's prefill needs
    trace: Trace | None             # the profiled section
    attn_calls: list                # attention cores of the profiled section (`AttnCall`)
    traced_decode_steps: int


def port_config(cfg_file: dict):
    """The port's `ModelConfig` of a configuration file, checked against the
    sizes the file states."""
    from repro_torch.configs import get_config

    cfg = get_config(cfg_file["arch"], smoke=cfg_file.get("smoke", False))
    cfg = cfg.replace(**cfg_file.get("overrides", {}))
    z = flops.sizes_of(cfg_file)
    wrong = [f"{k}: file {getattr(z, k)}, port {getattr(cfg, f)}" for k, f in _FIELDS.items()
             if getattr(z, k) and getattr(z, k) != getattr(cfg, f)]
    if z.ff and not z.experts and z.ff != cfg.d_ff:
        wrong.append(f"ff: file {z.ff}, port {cfg.d_ff}")
    for key, field in (("norm_eps", "norm_eps"), ("dtype", "dtype"),
                       ("capacity_factor", "capacity_factor"), ("rope_theta", "rope_theta")):
        if key in cfg_file and cfg_file[key] != getattr(cfg, field):
            wrong.append(f"{key}: file {cfg_file[key]}, port {getattr(cfg, field)}")
    if wrong:
        raise ValueError(f"{cfg_file['name']}: the port's config differs: {'; '.join(wrong)}")
    return cfg


def _traffic(spec: Spec, cell, cfg, seed: int, dev) -> Traffic:
    mix = Mix.from_dict(spec.traffic(cell.traffic))
    return Traffic(mix, seed, vocab=cfg.vocab, d_frontend=cfg.d_frontend,
                   n_frames=cfg.enc_seq if cfg.family == "encdec" else 0, device=dev,
                   dtype=cfg.cdtype)


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_cell(root, workload: str, seed: int, seconds: float, trace: bool, *,
             device="cuda", t_start: float | None = None) -> dict:
    """Run one cell and return the result's line as a dict (``compared`` last);
    the numbers compared also go to standard error."""
    import torch

    from repro_torch.launch import serve
    from repro_torch.models import transformer as T

    from . import weights
    from .peaks import peaks_for

    t_start = time.perf_counter() if t_start is None else t_start
    spec = Spec(root)
    cell = spec.cell(workload)
    cfg_file = spec.config(cell.config)
    wl = spec.workload(workload)
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    cfg = port_config(cfg_file)
    traffic = _traffic(spec, cell, cfg, seed, dev)
    mix = traffic.mix
    params = weights.make_params(T.abstract_params(cfg), cfg.cdtype, seed, dev)

    def serve_one(i, reg):
        b = traffic.batch(i)
        return serve.serve_batch(params, cfg, b.prompts, mix.gen, frames=b.frames, device=dev,
                                 reg=reg)

    outs, rec = [], Recorder()
    sample = check.Sample(int(wl["check"]["batches"]), seed)
    with Capture() as cap, (Probes() if trace else nullcontext()) as probe:
        serve_one(WARM, Recorder())         # builds the kernels and warms every shape
        cap.take()
        _sync(dev)
        t0 = time.perf_counter()
        setup_s = t0 - t_start
        while True:
            outs.append(serve_one(len(outs), rec))
            sample.offer(len(outs) - 1, cap.take())
            if time.perf_counter() - t0 >= seconds:
                break
        window_s = time.perf_counter() - t0
    peak_mem = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    n_req = len(outs) * mix.batch

    tr, traced = None, None
    if trace:
        tr, traced = _traced_section(serve_one, len(outs), dev)

    # the check: program state freed, then the reference on a sample of the window
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    idx = sorted(sample.kept)
    prog, _ = check.compare(params, cfg_file, [traffic.batch(i) for i in idx],
                            [outs[i] for i in idx], [sample.kept[i] for i in idx], dev)
    stats = check.summarize(prog)
    correct, compared = check.judge(stats, wl["limits"])

    dev_name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu", "kind": dev_name,
                   "count": cell.chips, "memory_peak_bytes": int(peak_mem)}
    result = {"correct": bool(correct), "attempted": n_req, "failed": 0}
    if not trace:
        pre = rec.samples("serve.prefill.seconds")
        dec = rec.samples("serve.decode.seconds")
        values = {"tokens_per_s": n_req * mix.gen / window_s,
                  "ttft_ms": 1e3 * float(np.mean(pre)),
                  "itl_p95_ms": 1e3 * float(np.percentile(dec, 95)) if dec else None,
                  "setup_s": setup_s}
        # a metric named <quantity>.<suffix> reports <quantity> under a bound of its own
        result["metrics"] = {m["name"]: {"value": values[m["name"].split(".")[0]],
                                         "unit": m["unit"]}
                             for m in spec.metrics("end_to_end", workload)
                             if values[m["name"].split(".")[0]] is not None}
    else:
        z = flops.sizes_of(cfg_file)
        readings = Readings(
            window_s=window_s, requests=n_req,
            model_flops=float(n_req * flops.request_flops(z, mix.prompt_len, mix.gen)),
            peaks=peaks_for(dev_name) if dev.type == "cuda" else {},
            decode_host_s=probe.decode_host_s,
            prefill_s=rec.samples("serve.prefill.seconds"),
            # the prefill is each prompt through the model and its first token sampled
            prefill_flops=float(mix.batch * flops.request_flops(z, mix.prompt_len, 1)),
            trace=tr,
            attn_calls=traced.attn_calls if traced else [],
            traced_decode_steps=traced.decode_steps if traced else 0)
        result["metrics"] = {}
        for m in spec.metrics("per_layer", workload):
            v = spec.reader(m["name"])(readings)
            if v is not None:
                result["metrics"][m["name"]] = {"value": float(v), "unit": m["unit"]}
        if tr is not None:
            device_info["busy_s"] = tr.busy_s()
            device_info["window_s"] = tr.window
            result["breakdown"] = {"device_ops": tr.top_device_ops(), "idle_gaps": tr.idle_gaps()}
    result["device"] = device_info
    result["compared"] = compared
    for k, c in compared.items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    return result


def _traced_section(serve_one, first: int, dev):
    """Whole batches under ``torch.profiler`` for at least ``TRACE_SECONDS``,
    the layer ranges on -> (`Trace` or None, the probes)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from . import trace as trace_mod

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with Probes(ranges=True) as probe:
        with profile(activities=acts) as prof:
            with record_function(WINDOW):
                t0, i = time.perf_counter(), first
                while i == first or time.perf_counter() - t0 < TRACE_SECONDS:
                    serve_one(i, Recorder())
                    i += 1
                _sync(dev)
    return trace_mod.from_profiler(prof), probe
