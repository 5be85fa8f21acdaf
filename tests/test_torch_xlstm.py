"""The port's mLSTM and sLSTM mixers and the xlstm family (xlstm-350m) against
the JAX package, on the CPU.

* ``mlstm_apply`` and ``slstm_apply`` against the reference's on the same
  params: without a cache over 21 tokens (mLSTM at chunk 8, a padded last
  chunk, and at chunk 32), and with a cache (a prefill of 13 tokens, one of
  5, then two decode steps), outputs within 1e-5 × max(|out|, 1) and every state
  within 1e-5 (the stabilizers ``m`` start at -1e30 and stay float32); in
  bf16 within 3e-2; the gradients through the chunked path within 1e-5.
* The chunked path against the port's own ``mlstm_seq_ref`` within 1e-4 and
  extreme gates without overflow (the counterparts of tests/test_models.py:92
  and :102).
* xlstm-350m at SMOKE (6 layers: five mLSTM, one sLSTM, tied embeddings):
  forward, prefill + 4 decode logits within 2e-3 × max(|logit|, 1), serve
  tokens equal to the reference's ``serve_batch``, three train steps' loss
  and grad norm within rtol 1e-4 with a finite gradient; the serve and train
  CLIs.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models import xlstm as JX  # noqa: E402
from repro.models.layers import init_params as jax_init_params  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch._tree import leaves  # noqa: E402
from repro_torch.configs import ALL_ARCHS  # noqa: E402
from repro_torch.configs import get_config as torch_config  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch.steps import loss_and_grads  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models import xlstm as TX  # noqa: E402
from tests import torch_lm_oracle as O  # noqa: E402

ARCH = "xlstm-350m"
MIXERS = {"mlstm": (JX.mlstm_specs, JX.mlstm_apply, TX.mlstm_apply),
          "slstm": (JX.slstm_specs, JX.slstm_apply, TX.slstm_apply)}


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Keep this file's CPU load small beside the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _cfgs(chunk=8, d=32, H=4):
    return JX.XLSTMConfig(d, H, chunk=chunk), TX.XLSTMConfig(d, H, chunk=chunk)


def _params(mixer, seed=3, scale=1.0, **kw):
    """The reference's init of a narrow mixer (d 32, 4 heads: mLSTM head dim
    16 of d_inner 64, sLSTM head dim 8), matrices times ``scale``."""
    jc, _ = _cfgs(**kw)
    p = jax_init_params(MIXERS[mixer][0](jc), jax.random.key(seed))
    return {k: np.asarray(v) * (scale if v.ndim >= 2 else 1.0) for k, v in p.items()}


def _both(p):
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.as_tensor(np.array(v)) for k, v in p.items()})


def _jit(mixer, jc):
    """The reference's apply of ``mixer`` under ``jax.jit``: one compile a
    shape where eager dispatch compiles every primitive."""
    apply = MIXERS[mixer][1]
    return jax.jit(lambda p, x, cache=None: apply(p, x, jc, cache))


def _close(a, b, tol=1e-5):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape
    err = np.abs(a - b).max()
    assert err <= tol * max(1.0, float(np.abs(b).max())), err


def _x(S=21, seed=1, d=32):
    return np.random.default_rng(seed).normal(size=(2, S, d)).astype(np.float32)


def test_specs_and_caches_match_reference():
    jc, tc = _cfgs()
    for js, ts in ((JX.mlstm_specs(jc), TX.mlstm_specs(tc)),
                   (JX.slstm_specs(jc), TX.slstm_specs(tc))):
        assert {k: (s.shape, s.axes, s.init, s.scale) for k, s in ts.items()} == {
            k: (s.shape, s.axes, s.init, s.scale) for k, s in js.items()}
    for jcache, tcache in ((JX.init_mlstm_cache(jc, 3), TX.init_mlstm_cache(tc, 3)),
                           (JX.init_slstm_cache(jc, 3), TX.init_slstm_cache(tc, 3))):
        assert {k: (tuple(v.shape), v.dtype) for k, v in tcache.items()} == {
            k: (v.shape, torch.float32) for k, v in jcache.items()}
        for k in tcache:
            _close(tcache[k], jcache[k], 0.0)


@pytest.mark.parametrize("mixer,chunk", [("mlstm", 8), ("mlstm", 32), ("slstm", 8)])
def test_mixer_matches_reference(mixer, chunk):
    """sLSTM has no chunks: one case."""
    jc, tc = _cfgs(chunk)
    jp, tp = _both(_params(mixer))
    x = _x()
    want, _ = _jit(mixer, jc)(jp, jnp.asarray(x))
    got, nc = MIXERS[mixer][2](tp, torch.as_tensor(x), tc)
    assert nc is None
    _close(got, want)


@pytest.mark.parametrize("mixer", ["mlstm", "slstm"])
def test_mixer_with_a_cache_matches_reference(mixer):
    """Prefill 13 tokens (two chunks, one padded), prefill 5 more against the
    cache, then two decode steps."""
    jc, tc = _cfgs()
    jp, tp = _both(_params(mixer))
    x = _x()
    init = {"mlstm": (JX.init_mlstm_cache, TX.init_mlstm_cache),
            "slstm": (JX.init_slstm_cache, TX.init_slstm_cache)}[mixer]
    jcache, tcache = init[0](jc, 2), init[1](tc, 2)
    step = _jit(mixer, jc)
    for lo, hi in ((0, 13), (13, 18), (18, 19), (19, 20)):
        want, jcache = step(jp, jnp.asarray(x[:, lo:hi]), jcache)
        got, tcache = MIXERS[mixer][2](tp, torch.as_tensor(x[:, lo:hi]), tc, tcache)
        _close(got, want)
        assert set(tcache) == set(jcache)
        for k in tcache:
            assert tcache[k].dtype == torch.float32
            _close(tcache[k], jcache[k])


@pytest.mark.parametrize("mixer", ["mlstm", "slstm"])
def test_mixer_bf16_matches_reference(mixer):
    jc, tc = _cfgs()
    jp, tp = _both(_params(mixer, seed=5))
    x = _x(seed=4)
    want, _ = _jit(mixer, jc)(jp, jnp.asarray(x, jnp.bfloat16))
    got, _ = MIXERS[mixer][2](tp, torch.as_tensor(x).bfloat16(), tc)
    assert got.dtype == torch.bfloat16
    _close(got.float(), np.asarray(want, np.float32), 3e-2)


@pytest.mark.parametrize("mixer", ["mlstm", "slstm"])
def test_mixer_gradient_matches_reference(mixer):
    """The gradients of x and of every weight within 1e-5 of their scale
    (16 tokens at chunk 8: two whole chunks, no pad rows)."""
    jc, tc = _cfgs()
    jp, tp = _both(_params(mixer))
    x = _x(S=16)
    apply = MIXERS[mixer][1]
    jg = jax.jit(jax.grad(lambda p, x: jnp.sum(apply(p, x, jc)[0] ** 2), (0, 1)))(
        jp, jnp.asarray(x))
    tp = {k: v.requires_grad_() for k, v in tp.items()}
    tx = torch.as_tensor(x).requires_grad_()
    (MIXERS[mixer][2](tp, tx, tc)[0] ** 2).sum().backward()
    _close(tx.grad, jg[1])
    for k in tp:
        assert torch.isfinite(tp[k].grad).all()
        _close(tp[k].grad, jg[0][k])


@pytest.mark.parametrize("chunk", [8, 32])
def test_mlstm_chunked_equals_sequential(chunk):
    _, tc = _cfgs(chunk)
    _, tp = _both(_params("mlstm"))
    x = torch.as_tensor(_x())
    a, _ = TX.mlstm_apply(tp, x, tc)
    b = TX.mlstm_seq_ref(tp, x, tc)
    assert torch.allclose(a, b, atol=1e-4)


def test_mlstm_no_overflow_with_extreme_gates():
    """Stabilized exponential gating: no NaN or inf with huge gate logits,
    and the reference's values."""
    jc, tc = _cfgs(chunk=4, d=16, H=2)
    p = _params("mlstm", seed=4, scale=30.0, chunk=4, d=16, H=2)
    jp, tp = _both(p)
    x = np.random.default_rng(6).normal(size=(1, 13, 16)).astype(np.float32) * 10
    got, _ = TX.mlstm_apply(tp, torch.as_tensor(x), tc)
    assert torch.isfinite(got).all()
    _close(got, _jit("mlstm", jc)(jp, jnp.asarray(x))[0])


# -- xlstm-350m --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def params():
    return O.ref_params(ARCH)


def test_xlstm_registered_as_the_reference():
    assert ARCH in ALL_ARCHS
    for smoke in (False, True):
        t, j = torch_config(ARCH, smoke=smoke), jax_config(ARCH, smoke=smoke)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.param_count() == j.param_count()
    assert torch_config(ARCH).param_count() == 272_782_496
    assert torch_config(ARCH).tie_embeddings


def test_forward_prefill_decode_match_reference(params):
    jcfg, tcfg = O.cfgs(ARCH, "naive")
    full_j, serve_j, _ = O.jax_logits(params, jcfg, O.inputs(jcfg))
    full_t, serve_t, st = O.torch_logits(params, tcfg, O.inputs(tcfg))
    assert full_t.shape == (O.B, O.S, tcfg.vocab)
    assert np.abs(full_t - full_j).max() < O.tol(full_j)
    assert np.abs(serve_t - serve_j).max() < O.tol(full_j)
    assert np.abs(serve_t - full_j[:, O.PRE - 1:]).max() < O.tol(full_j)
    assert st == {"moe_drops": 0, "moe_peak_occupancy": 0}


def test_serve_batch_tokens_equal_reference(params):
    jcfg, tcfg = O.cfgs(ARCH, "naive")
    prompts = np.random.default_rng(5).integers(0, jcfg.vocab, (O.B, O.PRE)).astype(np.int32)
    want = jserve.serve_batch(jax.tree.map(jnp.asarray, params), jcfg, prompts, 4,
                              make_host_mesh())
    got = tserve.serve_batch(convert.model_params_to_torch(params, "cpu"), tcfg, prompts, 4,
                             device="cpu")
    assert np.array_equal(got, np.asarray(want))


def test_train_steps_match_reference(params):
    jcfg, tcfg = O.cfgs(ARCH, "naive")
    states, mets = O.jax_train(params, jcfg)
    O.check_train_steps(tcfg, states, mets)


def test_train_gradient_is_finite_under_remat(params):
    """Seq 16 at chunk 16 (no pad rows): every gradient leaf finite, and the
    same with and without remat."""
    _, tcfg = O.cfgs(ARCH, "naive")
    p = convert.model_params_to_torch(params, "cpu")
    b = O._tbatch(O.train_batch(tcfg, 0))
    flat = [torch.cat([g.flatten() for g in leaves(loss_and_grads(p, b, tcfg.replace(
        remat=r))[2])]) for r in (False, True)]
    assert torch.isfinite(flat[0]).all()
    assert torch.allclose(flat[0], flat[1], atol=1e-6)


def test_init_cache_matches_reference_layout():
    """The reference's keys and shapes, every state float32 under a bf16
    model, no index, and the stabilizers at -1e30."""
    jcfg, tcfg = (c.replace(dtype="bfloat16") for c in O.cfgs(ARCH, "naive"))
    jc = JT.init_cache(jcfg, 2, 7)["blocks"]
    tc = TT.init_cache(tcfg, 2, 7, device="cpu")["blocks"]
    assert set(tc) == set(jc)
    for i in tc:
        assert {k: (tuple(v.shape), v.dtype) for k, v in tc[i].items()} == {
            k: (v.shape, torch.float32) for k, v in jc[i].items()}
        assert (tc[i]["m"] == -1e30).all()


def test_serving_copy_keeps_the_float32_leaves(params):
    """``cast_params`` keeps sLSTM's recurrent weights in float32 (the
    reference reads them so), so the bf16 serving copy computes what the
    float32 masters do."""
    tcfg = torch_config(ARCH, smoke=True).replace(dtype="bfloat16")
    p = convert.model_params_to_torch(params, "cpu")
    cp = TT.cast_params(p, tcfg.cdtype)
    sl = cp["blocks"]["5"]["slstm"]
    assert all(sl[f"r{g}"].dtype == torch.float32 for g in "zifo")
    assert sl["wz"].dtype == cp["blocks"]["0"]["mlstm"]["wq"].dtype == torch.bfloat16
    toks = {"tokens": torch.as_tensor(O.inputs(tcfg)["tokens"])}
    assert torch.equal(TT.forward(p, toks, tcfg)[0], TT.forward(cp, toks, tcfg)[0])


def test_param_tree_follows_reference():
    O.check_param_tree(ARCH)


def test_serve_and_train_clis_on_cpu(capsys):
    out = tserve.run(["--arch", ARCH, "--smoke", "--device", "cpu", "--requests", "3",
                      "--batch", "2", "--prompt-len", "4", "--gen", "3"])
    assert out.shape == (3, 3) and out.min() >= 0 and out.max() < 256
    losses = ttrain.run(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "2",
                         "--batch", "2", "--seq", "16"])
    assert len(losses) == 2 and np.isfinite(losses).all()
    out = capsys.readouterr().out
    assert "done: 3 requests" in out and f"arch={ARCH}" in out
