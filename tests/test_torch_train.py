"""The port's training path against the JAX package, on the CPU.

The oracle is the reference's ``make_train_step`` run outside any mesh on
unsharded params (its ``launch.train`` driver fails on the CPU under its own
mesh, so its integration tests cannot serve).  llama3.2-1b SMOKE with
``attn_impl`` naive and flash (the reference's flash through Pallas in
interpret mode), batch 4, seq 16, lr 2e-3, ``total_steps=10``, ``warmup=5``,
pipeline seed 0, params converted from the reference's ``init_params(key 0)``:

* per-step ``loss`` and ``grad_norm`` within rtol 1e-4 with the port started
  from the reference's state at every step (fixed params, fixed batch), and
  the first three losses equal to the reference's 5.56545, 5.55355, 5.49985;
  the same for gemma-7b (GeGLU, embedding scale) and command-r-35b, and at
  ``dtype="bfloat16"`` (the full configs' compute type) with ``grad_norm``
  within rtol 5e-2: there the reference sums the bf16 products of a
  broadcast weight's gradient (the norms' gamma) with roundings on the way,
  where PyTorch rounds the sum once, and the gradients differ by 1-3 %
  (measured 1.6e-2 and 2.8e-2; the losses within 2e-5);
* five free-running steps: ``loss`` within rtol 1e-4, ``grad_norm`` within
  rtol 2e-3.  At step 5 the gradient moves by ~1e-3 of its norm under a
  parameter change of ~4e-6 (the reference's own naive and flash runs differ
  there by 1e-4), so the free-running gradient norm is held at 2e-3;
* the first step's grads leaf for leaf within rtol 1e-4 and atol
  max(1e-6, 1e-4 × the leaf's max |grad|).  Every leaf but the embedding
  holds at atol 1e-6; the embedding's gradient sums the lookup's and the tied
  head's terms, and 47 of its 16 384 elements differ by up to 5.4e-5 of its
  2.48 maximum.

Then AdamW, the schedule and clipping on identical inputs, the data pipeline
byte for byte, checkpoints across the two packages, the resilient runner
(the cases of tests/test_substrate.py), and the train CLI on the CPU.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import checkpoint as jckpt  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.launch.steps import make_train_step as jax_train_step  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.layers import init_params as jax_init_params  # noqa: E402
from repro_torch import checkpoint as tckpt  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch.configs import get_config as torch_config  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch.steps import loss_and_grads, make_train_step  # noqa: E402
from repro_torch.runtime import FTConfig, ResilientRunner, StepFailure  # noqa: E402

ARCH = "llama3.2-1b"
IMPLS = ["naive", "flash"]
BATCH, SEQ, LR, TOTAL, WARMUP, STEPS = 4, 16, 2e-3, 10, 5, 5
REF_LOSSES = (5.56545, 5.55355, 5.49985)        # the reference's first three steps
REF_GNORMS = (14.5088, 4.9372, 6.4413)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Keep this file's CPU load small beside the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _cfgs(impl, arch=ARCH, dtype="float32"):
    return (jax_config(arch, smoke=True).replace(attn_impl=impl, dtype=dtype),
            torch_config(arch, smoke=True).replace(attn_impl=impl, dtype=dtype))


DATA = tpipe.DataConfig(vocab=256, seq_len=SEQ, global_batch=BATCH, seed=0)


def _batch(step):
    return tpipe._synthesize(DATA, step)


def _tbatch(b):
    return {k: torch.as_tensor(v).long() for k, v in b.items()}


def _init(arch):
    p = jax_init_params(JT.abstract_params(jax_config(arch, smoke=True)), jax.random.key(0))
    return jax.tree.map(np.asarray, p)


@pytest.fixture(scope="module")
def init():
    """Reference params (numpy) of llama3.2-1b SMOKE."""
    return _init(ARCH)


def _jax_state(p):
    params = jax.tree.map(jnp.asarray, p)
    return {"params": params, "opt": joptim.adamw_init(params)}


def _to_port(jstate):
    return {"params": convert.model_params_to_torch(jax.tree.map(np.asarray, jstate["params"]),
                                                    "cpu"),
            "opt": convert.opt_state_to_torch(jax.tree.map(np.asarray, jstate["opt"]), "cpu")}


@pytest.fixture(scope="module")
def reference():
    """(impl, arch, dtype) → the reference's states before each of STEPS
    steps and its per-step metrics, computed at first use."""
    done = {}

    def get(impl, arch=ARCH, dtype="float32"):
        if (impl, arch, dtype) not in done:
            jcfg, _ = _cfgs(impl, arch, dtype)
            step = jax.jit(jax_train_step(jcfg, make_host_mesh(), joptim.AdamWConfig(lr=LR),
                                          total_steps=TOTAL, warmup=WARMUP))
            state, states, mets = _jax_state(_init(arch)), [], []
            for s in range(STEPS):
                states.append(jax.tree.map(np.asarray, state))
                state, m = step(state, {k: jnp.asarray(v) for k, v in _batch(s).items()})
                mets.append({k: float(v) for k, v in m.items()})
            done[impl, arch, dtype] = states, mets
        return done[impl, arch, dtype]
    return get


def _rel(a, b):
    return abs(a - b) / abs(b)


@pytest.mark.parametrize("impl,arch,dtype", [
    ("naive", ARCH, "float32"), ("flash", ARCH, "float32"), ("naive", "gemma-7b", "float32"),
    ("flash", "command-r-35b", "float32"), ("naive", ARCH, "bfloat16"),
    ("flash", "gemma-7b", "bfloat16")])
def test_train_step_matches_reference_per_step(impl, arch, dtype, reference):
    """From the reference's state before each step, on that step's batch."""
    _, tcfg = _cfgs(impl, arch, dtype)
    states, mets = reference(impl, arch, dtype)
    step = make_train_step(tcfg, toptim.AdamWConfig(lr=LR), total_steps=TOTAL, warmup=WARMUP)
    gnorm_tol = 1e-4 if dtype == "float32" else 5e-2
    for s in range(STEPS):
        new, m = step(_to_port(states[s]), _tbatch(_batch(s)))
        assert _rel(float(m["loss"]), mets[s]["loss"]) < 1e-4, s
        assert _rel(float(m["grad_norm"]), mets[s]["grad_norm"]) < gnorm_tol, s
        assert float(m["nll"]) == float(m["loss"]) and float(m["aux"]) == 0.0
        assert int(new["opt"]["step"]) == s + 1
        assert set(m) == {"loss", "nll", "aux", "moe_drops", "moe_peak_occupancy", "grad_norm"}
    if (arch, dtype) == (ARCH, "float32"):
        for s in range(3):
            assert abs(mets[s]["loss"] - REF_LOSSES[s]) < 1e-5
            assert _rel(mets[s]["grad_norm"], REF_GNORMS[s]) < 1e-4


@pytest.mark.parametrize("impl", IMPLS)
def test_train_run_tracks_reference(impl, init, reference):
    """Five free-running steps of the port from the converted init."""
    _, tcfg = _cfgs(impl)
    _, mets = reference(impl)
    step = make_train_step(tcfg, toptim.AdamWConfig(lr=LR), total_steps=TOTAL, warmup=WARMUP)
    state = _to_port(_jax_state(init))
    for s in range(STEPS):
        state, m = step(state, _tbatch(_batch(s)))
        assert _rel(float(m["loss"]), mets[s]["loss"]) < 1e-4, s
        assert _rel(float(m["grad_norm"]), mets[s]["grad_norm"]) < 2e-3, s


@pytest.mark.parametrize("impl", IMPLS)
def test_first_step_grads_match_reference(impl, init):
    jcfg, tcfg = _cfgs(impl)
    b = _batch(0)
    want = jax.grad(lambda p: JT.loss(p, {k: jnp.asarray(v) for k, v in b.items()}, jcfg)[0])(
        jax.tree.map(jnp.asarray, init))
    _, _, got = loss_and_grads(convert.model_params_to_torch(init, "cpu"), _tbatch(b), tcfg)
    got, want = convert.model_params_to_numpy(got), jax.tree.map(np.asarray, want)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        atol = max(1e-6, 1e-4 * float(np.abs(w).max()))
        assert a.shape == w.shape and np.allclose(a, w, rtol=1e-4, atol=atol)


def test_pod_sync_serdes_waits_for_the_mesh(init):
    """(The name dates from when ``serdes`` raised.)  Off a mesh with a pod
    axis, here on one device, ``serdes`` is ``auto`` bit for bit, as the
    reference takes ``grads_auto`` when ``n_pods == 1``; any other mode raises.
    The exchange itself: tests/test_torch_pod_sync.py."""
    _, tcfg = _cfgs("naive")
    out = []
    for mode in ("auto", "serdes"):
        step = make_train_step(tcfg, toptim.AdamWConfig(lr=LR), pod_sync=mode, total_steps=TOTAL,
                               warmup=1)
        state = {"params": convert.model_params_to_torch(init, "cpu")}
        state["opt"] = toptim.adamw_init(state["params"])
        for s in range(2):
            state, m = step(state, _tbatch(_batch(s)))
        out.append(({k: float(v) for k, v in m.items()}, convert.model_params_to_numpy(
            state["params"])))
    assert out[0][0] == out[1][0]
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(out[0][1]),
                                                    jax.tree.leaves(out[1][1])))
    with pytest.raises(ValueError, match="'auto' or 'serdes'"):
        make_train_step(tcfg, toptim.AdamWConfig(), pod_sync="ring")


# -- optimizer ----------------------------------------------------------------------

def _tree(rng, scale=1.0):
    return {"a": (rng.normal(size=(5, 7)) * scale).astype(np.float32),
            "b": {"c": (rng.normal(size=(11,)) * scale).astype(np.float32),
                  "d": (rng.normal(size=(2, 3, 4)) * scale).astype(np.float32)}}


@pytest.mark.parametrize("lr", [None, 7e-4])
@pytest.mark.parametrize("grad_scale", [0.01, 10.0])      # under and over the clip
def test_adamw_update_matches_reference(lr, grad_scale):
    rng = np.random.default_rng(3)
    p, g = _tree(rng), _tree(rng, grad_scale)
    state = {"m": _tree(rng, 0.1), "v": jax.tree.map(np.abs, _tree(rng, 0.1)),
             "step": np.int32(3)}
    cfg_j, cfg_t = joptim.AdamWConfig(lr=2e-3), toptim.AdamWConfig(lr=2e-3)
    jp, js, jm = joptim.adamw_update(
        jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, g),
        jax.tree.map(jnp.asarray, state), cfg_j, lr=None if lr is None else jnp.float32(lr))
    tp, ts, tm = toptim.adamw_update(
        convert.model_params_to_torch(p, "cpu"), convert.model_params_to_torch(g, "cpu"),
        convert.opt_state_to_torch(state, "cpu"), cfg_t,
        lr=None if lr is None else torch.tensor(lr, dtype=torch.float32))
    for a, w in zip(jax.tree.leaves(convert.model_params_to_numpy(tp)), jax.tree.leaves(jp)):
        assert np.allclose(a, np.asarray(w), rtol=1e-6, atol=0)
    ts = convert.opt_state_to_numpy(ts)
    for a, w in zip(jax.tree.leaves(ts), jax.tree.leaves(js)):
        assert np.allclose(a, np.asarray(w), rtol=1e-6, atol=0)
    assert int(ts["step"]) == 4
    assert _rel(float(tm["grad_norm"]), float(jm["grad_norm"])) < 1e-6


def test_adamw_init_matches_reference():
    p = _tree(np.random.default_rng(0))
    got = convert.opt_state_to_numpy(toptim.adamw_init(convert.model_params_to_torch(p, "cpu")))
    want = jax.tree.map(np.asarray, joptim.adamw_init(jax.tree.map(jnp.asarray, p)))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.dtype == w.dtype and np.array_equal(a, w)


@pytest.mark.parametrize("warmup,total,peak", [(5, 10, 2e-3), (0, 30, 1e-3), (10, 20, 3e-4)])
def test_cosine_schedule_matches_reference(warmup, total, peak):
    """Every step 0..30, including step 0 (lr 0 under warmup) and past total."""
    for s in range(31):
        want = float(joptim.cosine_schedule(jnp.int32(s), peak_lr=peak, warmup=warmup,
                                            total=total))
        got = toptim.cosine_schedule(torch.tensor(s, dtype=torch.int32), peak_lr=peak,
                                     warmup=warmup, total=total)
        assert got.dtype == torch.float32 and abs(float(got) - want) <= 1e-6 * peak
        assert float(toptim.cosine_schedule(s, peak_lr=peak, warmup=warmup,
                                            total=total)) == float(got)


@pytest.mark.parametrize("max_norm", [0.1, 1.0, 50.0, 1e4])
def test_clip_by_global_norm_matches_reference(max_norm):
    g = _tree(np.random.default_rng(7), 20.0)
    jc, jn = joptim.clip_by_global_norm(jax.tree.map(jnp.asarray, g), max_norm)
    tc, tn = toptim.clip_by_global_norm(convert.model_params_to_torch(g, "cpu"), max_norm)
    assert _rel(float(tn), float(jn)) < 1e-6
    for a, w in zip(jax.tree.leaves(convert.model_params_to_numpy(tc)), jax.tree.leaves(jc)):
        assert np.allclose(a, np.asarray(w), rtol=1e-6, atol=0)
    norm = float(np.sqrt(sum((a.astype(np.float64) ** 2).sum()
                             for a in jax.tree.leaves(convert.model_params_to_numpy(tc)))))
    assert norm <= max_norm * 1.001


# -- data ----------------------------------------------------------------------------

@pytest.mark.parametrize("n_shards", [1, 2, 3, 8])
def test_synthesize_byte_equal_to_reference(n_shards):
    for step in (0, 1, 7, 123, 10_000):
        for shard in range(n_shards):
            kw = dict(vocab=211, seq_len=16, global_batch=8 * n_shards, n_shards=n_shards,
                      shard=shard, seed=3)
            got = tpipe._synthesize(tpipe.DataConfig(**kw), step)
            want = jpipe._synthesize(jpipe.DataConfig(**kw), step)
            assert got.keys() == want.keys()
            for k in got:
                assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes()


def test_pipeline_resume_exact_and_equal_to_reference():
    cfg = tpipe.DataConfig(vocab=100, seq_len=8, global_batch=4)
    p = tpipe.ShardedTokenPipeline(cfg)
    try:
        seen = [next(p) for _ in range(4)]
        assert p.state() == {"step": 4}
        p = p.restore({"step": 2})
        assert np.array_equal(next(p)["tokens"], seen[2]["tokens"])
        want = jpipe._synthesize(jpipe.DataConfig(vocab=100, seq_len=8, global_batch=4), 3)
        assert next(p)["tokens"].tobytes() == want["tokens"].tobytes()
        assert p.batch_at(0)["labels"].tobytes() == seen[0]["labels"].tobytes()
    finally:
        p.close()
    assert not p._thread.is_alive()


# -- checkpoints -------------------------------------------------------------------------

def _train_state(init):
    rng = np.random.default_rng(11)
    return {"params": init,
            "opt": {"m": jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32), init),
                    "v": jax.tree.map(lambda a: rng.random(a.shape).astype(np.float32), init),
                    "step": np.int32(6)}}


def _port_state(st):
    return {"params": convert.model_params_to_torch(st["params"], "cpu"),
            "opt": convert.opt_state_to_torch(st["opt"], "cpu")}


def _numpy_state(st):
    return {"params": convert.model_params_to_numpy(st["params"]),
            "opt": convert.opt_state_to_numpy(st["opt"])}


def _equal(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert jax.tree.structure(a) == jax.tree.structure(b) and len(la) == len(lb)
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y)


@pytest.mark.parametrize("async_save", [False, True])
def test_checkpoint_written_by_reference_restores_in_port(tmp_path, init, async_save):
    st = _train_state(init)
    jm = jckpt.CheckpointManager(jckpt.CheckpointConfig(str(tmp_path), async_save=async_save,
                                                        volume_mb=1))
    jm.save(6, jax.tree.map(jnp.asarray, st), extra={"data_step": 6})
    jm.wait()
    tm = tckpt.CheckpointManager(tckpt.CheckpointConfig(str(tmp_path)))
    got, step, extra = tm.restore(_port_state(jax.tree.map(np.zeros_like, st)))
    assert step == 6 and extra == {"data_step": 6}
    _equal(_numpy_state(got), st)


@pytest.mark.parametrize("async_save", [False, True])
def test_checkpoint_written_by_port_restores_in_reference(tmp_path, init, async_save):
    st = _train_state(init)
    tm = tckpt.CheckpointManager(tckpt.CheckpointConfig(str(tmp_path), async_save=async_save,
                                                        volume_mb=1))
    port = _port_state(st)
    tm.save(9, port, extra={"data_step": 9})
    for t in jax.tree.leaves(port["params"]):       # an in-place update after save()
        t.add_(1.0)
    tm.wait()
    jm = jckpt.CheckpointManager(jckpt.CheckpointConfig(str(tmp_path)))
    got, step, extra = jm.restore(jax.tree.map(jnp.asarray, st))
    assert step == 9 and extra == {"data_step": 9}
    _equal(jax.tree.map(np.asarray, got), st)
    names = set(os.listdir(tmp_path / "step_00000009"))
    assert {"COMMITTED", "meta.json", "arrays_00.npz", "arrays_01.npz"} <= names


def _small():
    return {"a": torch.arange(6.0).reshape(2, 3), "b": {"c": torch.ones(4, dtype=torch.int32)},
            "step": torch.zeros((), dtype=torch.int32)}


def test_checkpoint_roundtrip_and_gc(tmp_path):
    cm = tckpt.CheckpointManager(tckpt.CheckpointConfig(str(tmp_path), keep_last=2,
                                                        async_save=False))
    t = _small()
    for s in (1, 2, 3):
        cm.save(s, t)
    assert cm.all_steps() == [2, 3]
    rt, step, _ = cm.restore(t)
    assert step == 3
    _equal(jax.tree.map(lambda x: x.numpy(), rt), jax.tree.map(lambda x: x.numpy(), t))


def test_checkpoint_ignores_torn_writes(tmp_path):
    cm = tckpt.CheckpointManager(tckpt.CheckpointConfig(str(tmp_path), async_save=False))
    cm.save(5, _small())
    os.makedirs(tmp_path / "step_00000009")          # no COMMITTED sentinel
    assert cm.latest_step() == 5
    _, step, _ = cm.restore(_small())
    assert step == 5
    jm = jckpt.CheckpointManager(jckpt.CheckpointConfig(str(tmp_path)))
    assert jm.latest_step() == 5


def test_checkpoint_structure_mismatch_rejected(tmp_path):
    cm = tckpt.CheckpointManager(tckpt.CheckpointConfig(str(tmp_path), async_save=False))
    cm.save(1, _small())
    with pytest.raises(ValueError, match="structure mismatch"):
        cm.restore({"other": torch.zeros(3)})
    with pytest.raises(FileNotFoundError):
        tckpt.CheckpointManager(tckpt.CheckpointConfig(str(tmp_path / "empty"))).restore(_small())


# -- resilient runner -----------------------------------------------------------------------

def _pipe():
    return tpipe.ShardedTokenPipeline(tpipe.DataConfig(vocab=50, seq_len=4, global_batch=2))


def test_ft_failure_recovery_exact(tmp_path):
    """Injected failures + restore give the same final state as a clean run
    (deterministic data replay makes recovery exact)."""
    cm = tckpt.CheckpointManager(tckpt.CheckpointConfig(str(tmp_path), async_save=False))

    def step_fn(st, b):
        return {"x": st["x"] * 1.01 + float(b["tokens"].sum() % 97)}

    fails = {3: 1, 7: 2}

    def inject(s):
        if fails.get(s, 0):
            fails[s] -= 1
            raise StepFailure(s)

    pipe = _pipe()
    try:
        r = ResilientRunner(step_fn, cm, FTConfig(checkpoint_every=2, max_failures=4),
                            fail_injector=inject)
        state, stats = r.run({"x": 1.0}, pipe, 12)
        ref = {"x": 1.0}
        for s in range(12):
            ref = step_fn(ref, pipe.batch_at(s))
    finally:
        pipe.close()
    assert stats.failures == 3 and stats.restores == 3
    assert stats.steps == 15                   # steps 2 and 6 (twice) replayed
    assert abs(float(state["x"]) - ref["x"]) < 1e-9


def test_ft_gives_up_after_max_failures(tmp_path):
    cm = tckpt.CheckpointManager(tckpt.CheckpointConfig(str(tmp_path), async_save=False))

    def inject(s):
        raise StepFailure("always")

    pipe = _pipe()
    try:
        r = ResilientRunner(lambda st, b: st, cm, FTConfig(max_failures=2), fail_injector=inject)
        with pytest.raises(StepFailure):
            r.run({"x": 0.0}, pipe, 5)
    finally:
        pipe.close()
    assert r.stats.failures == 3


def test_straggler_detection(tmp_path):
    import time
    cm = tckpt.CheckpointManager(tckpt.CheckpointConfig(str(tmp_path), async_save=False))
    slow_steps = set(range(10, 14))

    def step_fn(st, b):
        if step_fn.i in slow_steps:
            time.sleep(0.05)
        step_fn.i += 1
        return st

    step_fn.i = 0
    hits = []
    pipe = _pipe()
    try:
        r = ResilientRunner(step_fn, cm, FTConfig(checkpoint_every=100, straggler_factor=3.0,
                                                  straggler_patience=2),
                            on_straggler=lambda s: hits.append(s))
        _, stats = r.run({"x": 0.0}, pipe, 20)
    finally:
        pipe.close()
    assert stats.stragglers >= 2 and len(hits) >= 1


# -- the train CLI ----------------------------------------------------------------------------

CLI = ["--smoke", "--device", "cpu", "--batch", "4", "--seq", "16", "--lr", "2e-3",
       "--log-every", "100"]


def test_train_cli_resumes_exactly(tmp_path, capsys):
    """6 steps with a checkpoint every 3, then a run to 10 resumes at step 6:
    its losses for steps 6-9 equal those of an uninterrupted 10-step run."""
    d = str(tmp_path / "ck")
    first = ttrain.run(CLI + ["--steps", "6", "--ckpt", d, "--ckpt-every", "3"])
    resumed = ttrain.run(CLI + ["--steps", "10", "--ckpt", d, "--ckpt-every", "5"])
    whole = ttrain.run(CLI + ["--steps", "10"])
    assert "restored from step 6" in capsys.readouterr().out
    assert len(first) == 6 and len(resumed) == 4 and len(whole) == 10
    assert first == whole[:6]
    assert resumed == whole[6:]
    assert tckpt.CheckpointManager(tckpt.CheckpointConfig(d)).all_steps() == [6, 10]


def test_train_cli_metrics(capsys):
    import json
    ttrain.run(CLI + ["--steps", "3", "--metrics", "-"])
    out = capsys.readouterr().out
    snap = json.loads(out[out.index("{"):])
    assert snap["histograms"]["train.step.seconds"]["count"] == 3
    from repro_torch.telemetry import get_registry
    assert get_registry() is None


def test_train_needs_a_gpu_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.run(["--smoke", "--steps", "1"])


def test_opt_state_convert_round_trip(init):
    st = _train_state(init)["opt"]
    back = convert.opt_state_to_numpy(convert.opt_state_to_torch(st, "cpu"))
    _equal(back, st)
    with pytest.raises(KeyError):
        convert.opt_state_to_torch({"m": {}, "v": {}}, "cpu")


def test_build_state_draws_from_a_cpu_generator_and_places_on_the_device():
    """The seeded weights come from a CPU generator, whatever the device: the
    leaves are drawn there and then placed (here on the meta device)."""
    from repro_torch._tree import leaves
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import init_params

    cfg = torch_config("llama3.2-1b", smoke=True)
    state = ttrain.build_state(cfg, 3, "cpu")
    want = init_params(T.abstract_params(cfg), torch.Generator().manual_seed(3))
    assert all(torch.equal(a, b) for a, b in zip(leaves(state["params"]), leaves(want)))
    placed = init_params(T.abstract_params(cfg), torch.Generator().manual_seed(3), "meta")
    assert all(p.is_meta and p.shape == w.shape and p.dtype == w.dtype
               for p, w in zip(leaves(placed), leaves(want)))
