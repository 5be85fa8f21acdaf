"""The port's vlm family (internvl2-1b: a patch prefix before the text) against
the JAX package, on the CPU.

At SMOKE (8 patches of width 16 before the tokens), on params made by the
reference's ``init_params``: forward logits of the text positions, prefill
(patches and 8 tokens) + 4 decode logits, within 2e-3 × max(|logit|, 1),
under naive/blocked/flash; the flash kernel's call over prefix + text; greedy
serve tokens against the reference's prefill and decode driven by hand with a
cache of n_patches + S + gen.  The reference's ``serve_batch`` sizes the
cache S + gen and its prefill overflows it; the port's ``serve_batch`` sizes
it n_patches + S + gen.  Then three train steps (seeded patches) with loss
and grad norm within rtol 1e-4, and the zero patches the train CLI feeds.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.launch import serve as jserve  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import ALL_ARCHS  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from tests import torch_lm_oracle as O  # noqa: E402

ARCH = "internvl2-1b"
IMPLS = ["naive", "blocked", "flash"]


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Keep this file's CPU load small beside the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


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


def test_vlm_registered():
    _, cfg = O.cfgs(ARCH, "naive")
    assert ARCH in ALL_ARCHS and cfg.family == "vlm" and (cfg.n_patches, cfg.d_frontend) == (8, 16)


@pytest.mark.parametrize("impl", IMPLS)
def test_forward_prefill_decode_match_reference(impl, params, reference):
    _, tcfg = O.cfgs(ARCH, impl)
    full_j, serve_j, _ = reference(impl)
    full_t, serve_t, _ = O.torch_logits(params, tcfg, O.inputs(tcfg))
    assert full_t.shape == (O.B, O.S, tcfg.vocab)        # the text positions only
    assert np.abs(full_t - full_j).max() < O.tol(full_j)
    assert np.abs(serve_t - serve_j).max() < O.tol(full_j)
    assert np.abs(serve_t - full_j[:, O.PRE - 1:]).max() < O.tol(full_j)


def test_flash_runs_over_prefix_and_text(params, monkeypatch):
    """Without a cache the kernel sees n_patches + S positions, causal, once a
    layer; a prefill against a cache takes the plain path."""
    _, cfg = O.cfgs(ARCH, "flash")
    calls = []
    real = tops.flash_attention

    def spy(q, k, v, causal=True, use_kernel=False):
        calls.append((tuple(q.shape), tuple(k.shape), causal))
        return real(q, k, v, causal, use_kernel)

    monkeypatch.setattr(tops, "flash_attention", spy)
    inp = {k: torch.as_tensor(v) for k, v in O.inputs(cfg).items()}
    TT.forward(convert.model_params_to_torch(params, "cpu"), inp, cfg)
    L = cfg.n_patches + O.S
    assert calls == [((O.B, cfg.n_heads, L, cfg.hd), (O.B, cfg.n_kv_heads, L, cfg.hd),
                      True)] * cfg.n_layers


@pytest.mark.parametrize("impl", IMPLS)
def test_serve_batch_tokens_equal_reference(impl, params, monkeypatch):
    """The port's serve_batch against the reference's prefill and decode
    driven by hand (zero patches, a cache of n_patches + S + gen); with a
    cache flash takes the plain path, so flash is held to naive tokens."""
    jcfg, _ = O.cfgs(ARCH, "naive" if impl == "flash" else impl)
    _, tcfg = O.cfgs(ARCH, impl)
    prompts = np.random.default_rng(5).integers(0, jcfg.vocab, (O.B, O.PRE)).astype(np.int32)
    want = O.jax_greedy(params, jcfg, prompts, 4)
    lens = []
    real = TT.init_cache
    monkeypatch.setattr(TT, "init_cache", lambda c, b, n, device=None: lens.append(n) or
                        real(c, b, n, device))
    got = tserve.serve_batch(convert.model_params_to_torch(params, "cpu"), tcfg, prompts, 4,
                             device="cpu")
    assert lens == [tcfg.n_patches + O.PRE + 4]
    assert np.array_equal(got, want)


def test_reference_serve_batch_overflows_a_vlm_cache(params):
    """Why the port's cache differs: the reference's serve_batch sizes it
    S + gen and its prefill writes n_patches + S positions."""
    jcfg, _ = O.cfgs(ARCH, "naive")
    prompts = np.zeros((O.B, O.PRE), np.int32)
    with pytest.raises(TypeError, match="dynamic_update_slice"):
        jserve.serve_batch(jax.tree.map(jnp.asarray, params), jcfg, prompts, 4,
                           make_host_mesh())


def test_train_steps_match_reference(params):
    jcfg, tcfg = O.cfgs(ARCH, "naive")
    states, mets = O.jax_train(params, jcfg)
    O.check_train_steps(tcfg, states, mets)


def test_train_batches_carry_zero_patches():
    _, cfg = O.cfgs(ARCH, "naive")
    b = ttrain.device_batch(O.train_batch(O.cfgs("llama3.2-1b", "naive")[1], 0), cfg, "cpu")
    assert b["patches"].shape == (4, cfg.n_patches, cfg.d_frontend)
    assert b["patches"].dtype == cfg.cdtype and not b["patches"].any()
    assert b["tokens"].dtype == torch.long and "frames" not in b


def test_param_tree_follows_reference():
    O.check_param_tree(ARCH)
