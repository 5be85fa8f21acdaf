"""The port's Mamba mixer and the hybrid family (jamba-v0.1-52b) against the
JAX package, on the CPU.

* ``_chunk_recurrence``, the doubling scan, against a sequential loop over the
  chunk within 1e-6 of its scale, at chunk lengths that are and are not
  powers of two.
* ``mamba_apply`` against the reference's on the same params: without a
  cache over 21 tokens at chunk 8 (a padded last chunk) and at chunk 32 (one
  chunk), and with a cache (a prefill of 13 tokens, one of 5, then two decode
  steps), outputs within 1e-5 × max(|out|, 1) and the conv and ssm states
  within 1e-5; in bf16 within 3e-2.  The caches are float32, as the
  reference's.
* The chunked path against the port's own ``mamba_scan_ref`` within 1e-4
  (the counterpart of tests/test_models.py:82).
* jamba at SMOKE (8 layers: Mamba and attention 7:1, MoE every other layer
  on ``moe_impl="dense"``): forward, prefill + 4 decode logits under
  naive and flash within 2e-3 × max(|logit|, 1), serve tokens equal to
  the reference's ``serve_batch``, three train steps' loss and grad norm
  within rtol 1e-4; the serve and train CLIs.
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
from repro.models import ssm as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.layers import init_params as jax_init_params  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import ALL_ARCHS  # noqa: E402
from repro_torch.configs import get_config as torch_config  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from tests import torch_lm_oracle as O  # noqa: E402

ARCH = "jamba-v0.1-52b"
# the attention impls of the one attention layer a period (the blocked impl
# is held in the dense and MoE families' files)
IMPLS = ["naive", "flash"]


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Keep this file's CPU load small beside the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _cfgs(chunk=8):
    kw = dict(d_state=8, d_conv=4, expand=2, chunk=chunk)
    return JS.MambaConfig(32, **kw), TS.MambaConfig(32, **kw)


def _params(seed=2):
    """The reference's init of a narrow Mamba (d 32, d_inner 64, N 8, rank 2)."""
    jc, _ = _cfgs()
    return jax.tree.map(np.asarray, jax_init_params(JS.mamba_specs(jc), jax.random.key(seed)))


def _both(p):
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.as_tensor(np.array(v)) for k, v in p.items()})


def _jit(jc):
    """The reference's ``mamba_apply`` under ``jax.jit``: one compile a shape
    where eager dispatch compiles every primitive."""
    return jax.jit(lambda p, x, cache=None: JS.mamba_apply(p, x, jc, cache))


def _close(a, b, tol=1e-5):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape
    err = np.abs(a - b).max()
    assert err <= tol * max(1.0, float(np.abs(b).max())), err


def _x(S=21, seed=1):
    return np.random.default_rng(seed).normal(size=(2, S, 32)).astype(np.float32)


def test_specs_and_cache_match_reference():
    jc, tc = _cfgs()
    js, ts = JS.mamba_specs(jc), TS.mamba_specs(tc)
    assert {k: (s.shape, s.axes, s.init, s.scale) for k, s in ts.items()} == {
        k: (s.shape, s.axes, s.init, s.scale) for k, s in js.items()}
    jcache, tcache = JS.init_mamba_cache(jc, 3), TS.init_mamba_cache(tc, 3)
    assert {k: (tuple(v.shape), v.dtype) for k, v in tcache.items()} == {
        k: (v.shape, torch.float32) for k, v in jcache.items()}


@pytest.mark.parametrize("Q", [1, 2, 5, 8, 13, 32])
def test_doubling_scan_matches_sequential(Q):
    """The Hillis–Steele scan gives every prefix state of the recurrence."""
    g = torch.Generator().manual_seed(Q)
    decay = torch.rand((2, Q, 6, 4), generator=g) * 0.9 + 0.05
    inc = torch.randn((2, Q, 6, 4), generator=g)
    h0 = torch.randn((2, 6, 4), generator=g)
    want, h = [], h0
    for t in range(Q):
        h = decay[:, t] * h + inc[:, t]
        want.append(h)
    _close(TS._chunk_recurrence(h0, decay, inc), torch.stack(want, 1), 1e-6)


@pytest.mark.parametrize("chunk", [8, 32])
def test_mamba_apply_matches_reference(chunk):
    jc, tc = _cfgs(chunk)
    jp, tp = _both(_params())
    x = _x()
    want, _ = _jit(jc)(jp, jnp.asarray(x))
    got, nc = TS.mamba_apply(tp, torch.as_tensor(x), tc)
    assert nc is None
    _close(got, want)


def test_mamba_apply_with_a_cache_matches_reference():
    """Prefill 13 tokens (two chunks, one padded), prefill 5 more against the
    cache, then two decode steps; the states are float32 after every call."""
    jc, tc = _cfgs()
    jp, tp = _both(_params())
    x = _x()
    jcache, tcache = JS.init_mamba_cache(jc, 2), TS.init_mamba_cache(tc, 2)
    step = _jit(jc)
    for lo, hi in ((0, 13), (13, 18), (18, 19), (19, 20)):
        want, jcache = step(jp, jnp.asarray(x[:, lo:hi]), jcache)
        got, tcache = TS.mamba_apply(tp, torch.as_tensor(x[:, lo:hi]), tc, tcache)
        _close(got, want)
        for k in ("conv", "ssm"):
            assert tcache[k].dtype == torch.float32
            _close(tcache[k], jcache[k])


def test_mamba_apply_bf16_matches_reference():
    jc, tc = _cfgs()
    jp, tp = _both(_params(3))
    x = _x(seed=4)
    want, _ = _jit(jc)(jp, jnp.asarray(x, jnp.bfloat16))
    got, _ = TS.mamba_apply(tp, torch.as_tensor(x).bfloat16(), tc)
    assert got.dtype == torch.bfloat16
    _close(got.float(), np.asarray(want, np.float32), 3e-2)


@pytest.mark.parametrize("chunk", [8, 32])
def test_mamba_chunked_equals_sequential(chunk):
    _, tc = _cfgs(chunk)
    _, tp = _both(_params())
    x = torch.as_tensor(_x())
    a, _ = TS.mamba_apply(tp, x, tc)
    b = TS.mamba_scan_ref(tp, x, tc)
    assert torch.allclose(a, b, atol=1e-4)


def test_mamba_gradient_matches_reference():
    """The gradients of x and of every weight through the chunked path (a
    padded last chunk) within 1e-5 of their scale."""
    jc, tc = _cfgs()
    jp, tp = _both(_params())
    x = _x()
    jg = jax.jit(jax.grad(lambda p, x: jnp.sum(JS.mamba_apply(p, x, jc)[0] ** 2), (0, 1)))(
        jp, jnp.asarray(x))
    tp = {k: v.requires_grad_() for k, v in tp.items()}
    tx = torch.as_tensor(x).requires_grad_()
    (TS.mamba_apply(tp, tx, tc)[0] ** 2).sum().backward()
    _close(tx.grad, jg[1])
    for k in tp:
        _close(tp[k].grad, jg[0][k])


# -- jamba-v0.1-52b ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def params():
    return O.ref_params(ARCH)


@pytest.fixture(scope="module")
def reference(params):
    done = {}

    def get(impl):
        if impl not in done:
            jcfg, _ = O.cfgs(ARCH, impl)
            done[impl] = O.jax_logits(params, jcfg, O.inputs(jcfg))
        return done[impl]
    return get


def test_jamba_registered_as_the_reference():
    assert ARCH in ALL_ARCHS
    for smoke in (False, True):
        t, j = torch_config(ARCH, smoke=smoke), jax_config(ARCH, smoke=smoke)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.param_count() == j.param_count()
    assert torch_config(ARCH).param_count() == 51_570_315_264
    assert torch_config(ARCH, smoke=True).moe_impl == "dense"


@pytest.mark.parametrize("impl", IMPLS)
def test_forward_prefill_decode_match_reference(impl, params, reference):
    _, tcfg = O.cfgs(ARCH, impl)
    full_j, serve_j, st_j = reference(impl)
    full_t, serve_t, st = O.torch_logits(params, tcfg, O.inputs(tcfg))
    assert full_t.shape == (O.B, O.S, tcfg.vocab)
    assert np.abs(full_t - full_j).max() < O.tol(full_j)
    assert np.abs(serve_t - serve_j).max() < O.tol(full_j)
    assert np.abs(serve_t - full_j[:, O.PRE - 1:]).max() < O.tol(full_j)
    assert st == st_j


def test_serve_batch_tokens_equal_reference(params):
    """The port under ``attn_impl="flash"`` against the reference's naive
    serve (its Pallas interpret mode fails under its host mesh, ROADMAP
    Queue 3): a cached prefill takes the plain path in both packages."""
    jcfg, _ = O.cfgs(ARCH, "naive")
    _, tcfg = O.cfgs(ARCH, "flash")
    prompts = np.random.default_rng(5).integers(0, jcfg.vocab, (O.B, O.PRE)).astype(np.int32)
    want = jserve.serve_batch(jax.tree.map(jnp.asarray, params), jcfg, prompts, 4,
                              make_host_mesh())
    tops.reset_launch_counts()
    got = tserve.serve_batch(convert.model_params_to_torch(params, "cpu"), tcfg, prompts, 4,
                             device="cpu")
    assert np.array_equal(got, np.asarray(want))
    assert tops.launch_counts()["flash_attention"] == 0


def test_train_steps_match_reference(params):
    jcfg, tcfg = O.cfgs(ARCH, "naive")
    states, mets = O.jax_train(params, jcfg)
    O.check_train_steps(tcfg, states, mets)


def test_init_cache_matches_reference_layout():
    """Per sub-layer the reference's keys and shapes; the Mamba states float32
    under a bf16 model, the attention K/V in bf16 with its index."""
    jcfg, tcfg = (c.replace(dtype="bfloat16") for c in O.cfgs(ARCH, "naive"))
    jc = JT.init_cache(jcfg, 2, 7)["blocks"]
    tc = TT.init_cache(tcfg, 2, 7, device="cpu")["blocks"]
    assert set(tc) == set(jc)
    for i, (mixer, _) in enumerate(tcfg.pattern):
        got, want = tc[str(i)], jc[str(i)]
        assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in got.items()
                if k != "idx"} == {k: (v.shape, str(v.dtype)) for k, v in want.items()
                                   if k != "idx"}
        assert ("idx" in got) == (mixer == "attn")


def test_serving_copy_keeps_the_float32_leaves(params):
    """``cast_params`` keeps the leaves the forward reads in float32 (a_log,
    d_skip), so the bf16 serving copy computes what the float32 masters do."""
    tcfg = torch_config(ARCH, smoke=True).replace(dtype="bfloat16")
    p = convert.model_params_to_torch(params, "cpu")
    cp = TT.cast_params(p, tcfg.cdtype)
    mamba = cp["blocks"]["0"]["mamba"]
    assert mamba["a_log"].dtype == mamba["d_skip"].dtype == torch.float32
    assert mamba["in_proj"].dtype == cp["embed"].dtype == torch.bfloat16
    toks = {"tokens": torch.as_tensor(O.inputs(tcfg)["tokens"])}
    a = TT.forward(p, toks, tcfg)[0]
    assert torch.equal(a, TT.forward(cp, toks, tcfg)[0])


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
