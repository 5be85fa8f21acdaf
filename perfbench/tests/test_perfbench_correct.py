"""``correct`` at a size the CPU holds: sound runs pass, the fp8 control
fails, and so does a run whose timed path is broken underneath (a decode
step that returns its state unchanged, half of the batch left out and
answered by the other half, logits shifted by one id where they are
produced, a served token altered after it was chosen).  The
chip check is skipped and the rest of a run is driven as ``run.py`` drives
it; the window is one batch (``seconds=0``), the batch the limits of the
test cells were read from (``data/workloads/*.json``, ``limits_from``)."""
import pytest
import torch

from perfbench import check
from perfbench.harness import run_cell
from perfbench.spec import Spec

CELLS = ("tiny-whisper.audio", "tiny-phi-moe.chat")


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [3, 2 ** 31 + 77])
def test_sound_runs_are_correct(tiny_root, cell, seed):
    r = run_cell(tiny_root, cell, seed, 0.0, False, device="cpu")
    assert r["correct"], r["compared"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_fp8_control_is_not_correct(tiny_root, cell):
    """The reference in fp8 put in the program's place, on the same batch."""
    from repro_torch.models import transformer as T

    from perfbench import weights
    from perfbench.harness import _traffic, port_config
    from perfbench.probes import Capture, Recorder
    from repro_torch.launch import serve

    spec = Spec(tiny_root)
    c = spec.cell(cell)
    cfg_file = spec.config(c.config)
    cfg = port_config(cfg_file)
    limits = spec.workload(cell)["limits"]
    for seed in (4, 5, 6):
        params = weights.make_params(T.abstract_params(cfg), cfg.cdtype, seed, "cpu")
        traffic = _traffic(spec, c, cfg, seed, torch.device("cpu"))
        b = traffic.batch(0)
        with Capture() as cap:
            out = serve.serve_batch(params, cfg, b.prompts, traffic.mix.gen, frames=b.frames,
                                    device="cpu", reg=Recorder())
        prog, ctrl = check.compare(params, cfg_file, [b], [out], [cap.take()], "cpu",
                                   control=True)
        assert check.judge(check.summarize(prog), limits)[0]
        assert not check.judge(check.summarize(ctrl), limits)[0], check.summarize(ctrl)


def _stuck(orig):
    def step(params, batch, cfg, cache):
        logits, _ = orig(params, batch, cfg, cache)
        return logits, cache                 # the state as it came in
    return step


def _half(orig):
    def step(params, batch, cfg, cache):
        logits, cache = orig(params, batch, cfg, cache)
        n = logits.shape[0] // 2
        logits = logits.clone()
        logits[n:2 * n] = logits[:n]         # the second half answered by the first
        return logits, cache
    return step


def _altered(orig):
    def step(params, batch, cfg, cache):
        logits, cache = orig(params, batch, cfg, cache)
        return logits.roll(1, dims=-1), cache  # each token one id past the chosen one
    return step


def _served_altered(orig):
    def serve_batch(*a, **k):
        out = orig(*a, **k).copy()
        out[:, -1] = (out[:, -1] + 1) % 2048  # the last token one id past the chosen one
        return out
    return serve_batch


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [_stuck, _half, _altered, _served_altered])
def test_a_broken_timed_path_is_not_correct(tiny_root, cell, fault, monkeypatch):
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T

    if fault is _served_altered:
        monkeypatch.setattr(serve, "serve_batch", fault(serve.serve_batch))
    else:
        monkeypatch.setattr(T, "decode_step", fault(T.decode_step))
    r = run_cell(tiny_root, cell, 3, 0.0, False, device="cpu")
    assert not r["correct"], r["compared"]


@pytest.mark.parametrize("n", [1, 3, 40])
def test_the_checked_sample_repeats_for_a_seed_and_covers_the_window(n):
    """`check.Sample` keeps ``k`` of ``n`` batches, the same ones for a seed,
    and over seeds every batch of the window is drawn."""
    def draw(seed):
        s = check.Sample(2, seed)
        for i in range(n):
            s.offer(i, f"logits {i}")
        assert all(v == f"logits {i}" for i, v in s.kept.items())
        return sorted(s.kept)

    assert draw(2 ** 31 + 5) == draw(2 ** 31 + 5)
    assert len(draw(7)) == min(2, n)
    assert set().union(*(draw(s) for s in range(400))) == set(range(n))
