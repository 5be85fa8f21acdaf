"""The port's MLA (multi-head latent attention) and minicpm3-4b against the JAX
package, on the CPU.

* ``mla_apply``, expanded and absorbed, without a cache, prefilling a cache
  and decoding one token against it, under ``impl`` naive and blocked (bkv 4,
  so the blocked impl walks KV blocks): outputs within 1e-5 × max(|out|, 1)
  and the cache equal; in bf16 within 3e-2.  The specs and the cache layout
  are the reference's.  MLA never reaches the flash kernel, as in the
  reference: ``impl="flash"`` takes ``_blocked``.
* minicpm3-4b at SMOKE (q_lora 768, kv_lora 256 as at full size): forward,
  prefill + 4 decode logits and serve tokens under naive/blocked/flash,
  expanded and absorbed, within 2e-3 × max(|logit|, 1); three train steps,
  loss within rtol 1e-4 and grad norm within rtol 2e-3.  The grad norm's gate
  is the float32 noise of this network: at its second step both packages'
  gradients are off a float64 run of the port by about 1e-4 of their norm
  (embedding gradient 3.0e-3 off for the port, 5.3e-3 for the reference, of
  a 36.9 norm), and the two differ by 9e-4 of the norm there.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.launch import serve as jserve  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.models import mla as JMLA  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import ALL_ARCHS  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import mla as TMLA  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from tests import torch_lm_oracle as O  # noqa: E402

ARCH = "minicpm3-4b"
IMPLS = ["naive", "blocked", "flash"]


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Keep this file's CPU load small beside the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _mcfgs(**kw):
    """A narrow MLA (d 32, 4 heads, q_lora 48, kv_lora 24, nope 16, rope 8,
    v 12: q/k dim 24 against v dim 12) in both packages."""
    kw = dict(q_lora_rank=48, kv_lora_rank=24, qk_nope_dim=16, qk_rope_dim=8, v_dim=12,
              bkv=4, **kw)
    return JMLA.MLAConfig(32, 4, **kw), TMLA.MLAConfig(32, 4, **kw)


def _params(seed=0):
    jc, _ = _mcfgs()
    rng = np.random.default_rng(seed)
    specs = JMLA.mla_specs(jc)
    return {k: (rng.normal(size=s.shape) / np.sqrt(s.shape[0])).astype(np.float32)
            if s.init != "ones" else (1 + 0.1 * rng.normal(size=s.shape)).astype(np.float32)
            for k, s in specs.items()}


def _close(a, b, tol=1e-5):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape
    err = np.abs(a - b).max()
    assert err <= tol * max(1.0, float(np.abs(b).max())), err


def test_specs_and_cache_match_reference():
    jc, tc = _mcfgs()
    js, ts = JMLA.mla_specs(jc), TMLA.mla_specs(tc)
    assert {k: (s.shape, s.axes, s.init) for k, s in ts.items()} == {
        k: (s.shape, s.axes, s.init) for k, s in js.items()}
    jcache, tcache = JMLA.init_mla_cache(jc, 3, 10), TMLA.init_mla_cache(tc, 3, 10)
    assert {k: tuple(v.shape) for k, v in tcache.items() if k != "idx"} == {
        k: v.shape for k, v in jcache.items() if k != "idx"}
    assert tcache["ckv"].dtype == torch.bfloat16 and tcache["idx"] == 0


@pytest.mark.parametrize("impl", ["naive", "blocked"])
@pytest.mark.parametrize("absorb", [False, True])
@pytest.mark.parametrize("case", ["nocache", "cache"])
def test_mla_apply_matches_reference(case, absorb, impl):
    """Without a cache over 9 tokens; with one, a prefill of 7 tokens at
    index 0, then a prefill of 2 and one decode step (S == 1 takes _naive)."""
    jc, tc = _mcfgs(absorb=absorb, impl=impl)
    p = _params()
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.as_tensor(v) for k, v in p.items()}
    x = np.random.default_rng(1).normal(size=(2, 10, 32)).astype(np.float32)
    if case == "nocache":
        want, _ = JMLA.mla_apply(jp, jnp.asarray(x[:, :9]), jc)
        got, nc = TMLA.mla_apply(tp, torch.as_tensor(x[:, :9]), tc)
        assert nc is None
        _close(got, want)
        return
    jcache = JMLA.init_mla_cache(jc, 2, 12, jnp.float32)
    tcache = TMLA.init_mla_cache(tc, 2, 12, torch.float32)
    for lo, hi in ((0, 7), (7, 9), (9, 10)):
        want, jcache = JMLA.mla_apply(jp, jnp.asarray(x[:, lo:hi]), jc, cache=jcache)
        got, tcache = TMLA.mla_apply(tp, torch.as_tensor(x[:, lo:hi]), tc, cache=tcache)
        _close(got, want)
        assert tcache["idx"] == int(jcache["idx"]) == hi
        for k in ("ckv", "k_rope"):
            _close(tcache[k], jcache[k])


@pytest.mark.parametrize("absorb", [False, True])
def test_mla_apply_bf16_matches_reference(absorb):
    jc, tc = _mcfgs(absorb=absorb, impl="blocked")
    p = _params(2)
    x = np.random.default_rng(3).normal(size=(2, 9, 32)).astype(np.float32)
    want, _ = JMLA.mla_apply({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x, jnp.bfloat16), jc)
    got, _ = TMLA.mla_apply({k: torch.as_tensor(v) for k, v in p.items()},
                            torch.as_tensor(x).bfloat16(), tc)
    assert got.dtype == torch.bfloat16
    _close(got.float(), np.asarray(want, np.float32), 3e-2)


def test_mla_never_reaches_the_flash_kernel(monkeypatch):
    """The reference's dispatch: impl="flash" takes _blocked (more than one
    query) or _naive (one query); the kernel is never called."""
    def boom(*a, **k):
        raise AssertionError("MLA reached the flash kernel")

    monkeypatch.setattr(tops, "flash_attention", boom)
    _, tf = _mcfgs(impl="flash")
    _, tb = _mcfgs(impl="blocked")
    tp = {k: torch.as_tensor(v) for k, v in _params().items()}
    x = torch.as_tensor(np.random.default_rng(4).normal(size=(2, 9, 32)).astype(np.float32))
    assert torch.equal(TMLA.mla_apply(tp, x, tf)[0], TMLA.mla_apply(tp, x, tb)[0])
    _, tcfg = O.cfgs(ARCH, "flash")
    TT.forward(convert.model_params_to_torch(O.ref_params(ARCH), "cpu"),
               {"tokens": torch.zeros((1, 5), dtype=torch.long)}, tcfg)


# -- minicpm3-4b -------------------------------------------------------------------------

@pytest.fixture(scope="module")
def params():
    return O.ref_params(ARCH)


@pytest.fixture(scope="module")
def reference(params):
    done = {}

    def get(impl, absorb):
        if (impl, absorb) not in done:
            jcfg, _ = O.cfgs(ARCH, impl, mla_absorb=absorb)
            done[impl, absorb] = O.jax_logits(params, jcfg, O.inputs(jcfg))
        return done[impl, absorb]
    return get


def test_minicpm3_registered():
    cfg = O.cfgs(ARCH, "naive")[1]
    assert ARCH in ALL_ARCHS and cfg.pattern == (("mla", "mlp"),)


@pytest.mark.parametrize("absorb", [False, True])
@pytest.mark.parametrize("impl", IMPLS)
def test_forward_prefill_decode_match_reference(impl, absorb, params, reference):
    _, tcfg = O.cfgs(ARCH, impl, mla_absorb=absorb)
    full_j, serve_j, _ = reference(impl, absorb)
    full_t, serve_t, st = O.torch_logits(params, tcfg, O.inputs(tcfg))
    assert full_t.shape == (O.B, O.S, tcfg.vocab)
    assert np.abs(full_t - full_j).max() < O.tol(full_j)
    assert np.abs(serve_t - serve_j).max() < O.tol(full_j)
    if not (absorb and impl != "naive"):
        # the absorbed _blocked rounds its operands to bf16 (the reference's
        # compute_dtype="bf16") where a decode step's _naive does not
        assert np.abs(serve_t - full_j[:, O.PRE - 1:]).max() < O.tol(full_j)
    assert st == {"moe_drops": 0, "moe_peak_occupancy": 0}


@pytest.mark.parametrize("impl", IMPLS)
def test_serve_batch_tokens_equal_reference(impl, params):
    jcfg, _ = O.cfgs(ARCH, impl)
    _, tcfg = O.cfgs(ARCH, impl)
    prompts = np.random.default_rng(5).integers(0, jcfg.vocab, (O.B, O.PRE)).astype(np.int32)
    want = jserve.serve_batch(jax.tree.map(jnp.asarray, params), jcfg, prompts, 4,
                              make_host_mesh())
    tops.reset_launch_counts()
    got = tserve.serve_batch(convert.model_params_to_torch(params, "cpu"), tcfg, prompts, 4,
                             device="cpu")
    assert np.array_equal(got, np.asarray(want))
    assert tops.launch_counts()["flash_attention"] == 0


@pytest.mark.parametrize("absorb", [False, True])
def test_train_steps_match_reference(absorb, params):
    jcfg, tcfg = O.cfgs(ARCH, "naive", mla_absorb=absorb)
    states, mets = O.jax_train(params, jcfg)
    O.check_train_steps(tcfg, states, mets, gnorm_rtol=2e-3)


def test_init_cache_matches_reference_layout():
    jcfg, tcfg = O.cfgs(ARCH, "naive")
    jc = JT.init_cache(jcfg, 2, 7)["blocks"]["0"]
    tc = TT.init_cache(tcfg, 2, 7, device="cpu")["blocks"]["0"]
    assert {k: tuple(v.shape) for k, v in tc.items() if k != "idx"} == {
        k: v.shape for k, v in jc.items() if k != "idx"}


def test_param_tree_follows_reference():
    O.check_param_tree(ARCH)
