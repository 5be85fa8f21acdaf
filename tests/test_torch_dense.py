"""The port's dense family (llama3.2-1b, gemma-7b, command-r-35b) against the
JAX package, on the CPU.

Each arch at SMOKE with each attention impl (naive, blocked, flash), on params
made by the reference's ``init_params`` and carried across by
``convert.model_params_to_torch``: ``forward`` logits, then ``prefill`` and 4
teacher-forced ``decode_step`` logits (RoPE positions advancing with the
cache), within 2e-3 × max(|logits|, 1), the whisper tests' tolerance
(tests/test_torch_models.py); ``serve_batch`` tokens equal to the reference's.
Then the layers on their own (``rope``, ``swiglu`` with SiLU and GELU,
``layer_norm``, ``cross_entropy`` with ignored labels) within 1e-5, the
``compute_dtype="bf16"`` branches of ``_naive`` and ``_blocked`` on bf16
inputs within 3e-2, the rounding of a bf16 weight's gradient, remat, and the
configs and their ``param_count``.  The
reference runs outside any mesh, flash through Pallas in interpret mode.
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
from repro.models import attention as JA  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import ALL_ARCHS  # noqa: E402
from repro_torch.configs import get_config as torch_config  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch.steps import loss_and_grads  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

ARCHS = ["llama3.2-1b", "gemma-7b", "command-r-35b"]
IMPLS = ["naive", "blocked", "flash"]
B, S, PRE = 2, 12, 8          # batch, sequence, prefill length (then 4 decode steps)


def _cfgs(arch, impl, **kw):
    # bkv 8 < S 12, so the blocked impl really walks KV blocks
    kw = dict(attn_impl=impl, bkv=8, **kw)
    return (jax_config(arch, smoke=True).replace(**kw),
            torch_config(arch, smoke=True).replace(**kw))


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Keep this file's CPU load small beside the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def params():
    """arch → reference params as numpy, made once."""
    done = {}

    def get(arch):
        if arch not in done:
            cfg = jax_config(arch, smoke=True)
            p = JL.init_params(JT.abstract_params(cfg), jax.random.key(0))
            done[arch] = jax.tree.map(np.asarray, p)
        return done[arch]
    return get


TOKENS = np.random.default_rng(0).integers(0, 256, (B, S)).astype(np.int32)


@pytest.fixture(scope="module")
def reference(params):
    """(arch, impl) → (JAX forward logits (B, S, V), JAX serve logits
    (B, 1 + S - PRE, V)), computed at first use."""
    done = {}

    def get(arch, impl):
        if (arch, impl) not in done:
            cfg, _ = _cfgs(arch, impl)
            p = jax.tree.map(jnp.asarray, params(arch))
            toks = jnp.asarray(TOKENS)
            full, *_ = JT.forward(p, {"tokens": toks}, cfg)
            cache = JT.init_cache(cfg, B, S)
            lg, cache = JT.prefill(p, {"tokens": toks[:, :PRE]}, cfg, cache)
            steps = [np.asarray(lg[:, 0])]
            for t in range(PRE, S):
                lg, cache = JT.decode_step(p, {"tokens": toks[:, t:t + 1]}, cfg, cache)
                steps.append(np.asarray(lg))
            done[arch, impl] = np.asarray(full), np.stack(steps, 1)
        return done[arch, impl]
    return get


def _tol(ref_logits):
    return 2e-3 * max(float(np.abs(ref_logits).max()), 1.0)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, impl, params, reference):
    _, cfg = _cfgs(arch, impl)
    full_j, _ = reference(arch, impl)
    logits, aux, cache, _ = TT.forward(convert.model_params_to_torch(params(arch), "cpu"),
                                       {"tokens": torch.as_tensor(TOKENS)}, cfg)
    assert logits.shape == (B, S, cfg.vocab) and cache is None and float(aux) == 0.0
    assert np.abs(logits.numpy() - full_j).max() < _tol(full_j)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, impl, params, reference):
    """Prefill PRE tokens, then decode 4 teacher-forced steps: each step's
    logits against the reference's and against the forward pass at the same
    position, which holds only if RoPE's positions advance with the cache."""
    _, cfg = _cfgs(arch, impl)
    full_j, serve_j = reference(arch, impl)
    tparams = convert.model_params_to_torch(params(arch), "cpu")
    toks = torch.as_tensor(TOKENS)
    cache = TT.init_cache(cfg, B, S, device="cpu")
    lg, cache = TT.prefill(tparams, {"tokens": toks[:, :PRE]}, cfg, cache)
    steps = [lg[:, 0]]
    for t in range(PRE, S):
        lg, cache = TT.decode_step(tparams, {"tokens": toks[:, t:t + 1]}, cfg, cache)
        steps.append(lg)
    serve_t = torch.stack(steps, 1).numpy()
    assert serve_t.shape == serve_j.shape == (B, 1 + S - PRE, cfg.vocab)
    assert np.abs(serve_t - serve_j).max() < _tol(full_j)
    assert np.abs(serve_t - full_j[:, PRE - 1:]).max() < _tol(full_j)
    assert cache["pos"] == S and cache["blocks"]["0"]["idx"] == S


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_batch_tokens_equal_reference(arch, impl, params):
    """Greedy tokens of the port's serve_batch equal the JAX serve_batch's.
    The reference's serve_batch cannot run impl="flash" on the CPU (Pallas
    interpret mode raises under its host mesh), so the port's flash tokens are
    held to the reference's naive ones; with a cache both take the plain path."""
    jcfg, _ = _cfgs(arch, "naive" if impl == "flash" else impl)
    _, tcfg = _cfgs(arch, impl)
    prompts = np.random.default_rng(5).integers(0, jcfg.vocab, (B, PRE)).astype(np.int32)
    out_j = jserve.serve_batch(jax.tree.map(jnp.asarray, params(arch)), jcfg, prompts, 4,
                               make_host_mesh())
    tops.reset_launch_counts()
    out_t = tserve.serve_batch(convert.model_params_to_torch(params(arch), "cpu"), tcfg,
                               prompts, 4, device="cpu")
    assert out_t.shape == (B, 4)
    assert np.array_equal(out_t, np.asarray(out_j))
    assert tops.launch_counts()["flash_attention"] == 0


def test_flash_taken_without_a_cache_only(params, monkeypatch):
    """attention.py:224: a forward without a cache takes the kernel once per
    layer (causal, GQA shapes); prefill and decode against a cache never do."""
    _, cfg = _cfgs("llama3.2-1b", "flash")
    calls = []
    real = tops.flash_attention

    def spy(q, k, v, causal=True, use_kernel=False):
        calls.append((tuple(q.shape), tuple(k.shape), causal, use_kernel))
        return real(q, k, v, causal, use_kernel)

    monkeypatch.setattr(tops, "flash_attention", spy)
    tparams = convert.model_params_to_torch(params("llama3.2-1b"), "cpu")
    toks = torch.as_tensor(TOKENS)
    TT.forward(tparams, {"tokens": toks}, cfg)
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    assert calls == [((B, H, S, D), (B, Hkv, S, D), True, True)] * cfg.n_layers
    cache = TT.init_cache(cfg, B, S, device="cpu")
    _, cache = TT.prefill(tparams, {"tokens": toks[:, :PRE]}, cfg, cache)
    TT.decode_step(tparams, {"tokens": toks[:, PRE:PRE + 1]}, cfg, cache)
    assert len(calls) == cfg.n_layers


# -- the layers on their own ----------------------------------------------------

RNG = np.random.default_rng(1)


def _close(a, b, tol=1e-5):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * max(1.0, float(np.abs(b).max()))


@pytest.mark.parametrize("shape,pos_shape", [((2, 7, 3, 16), (2, 7)), ((3, 5, 8), (3, 5))])
@pytest.mark.parametrize("rope_dim", [None, 6])
def test_rope_matches_reference(shape, pos_shape, rope_dim):
    x = RNG.normal(size=shape).astype(np.float32)
    pos = RNG.integers(0, 4000, pos_shape).astype(np.int32)
    for theta in (10000.0, 500_000.0):
        want = JL.rope(jnp.asarray(x), jnp.asarray(pos), theta, rope_dim)
        got = TL.rope(torch.as_tensor(x), torch.as_tensor(pos), theta, rope_dim)
        _close(got, want)
    # bf16 in, bf16 out, computed in float32 in between
    xb = torch.as_tensor(x).bfloat16()
    got = TL.rope(xb, torch.as_tensor(pos), 10000.0, rope_dim)
    want = JL.rope(jnp.asarray(x, jnp.bfloat16), jnp.asarray(pos), 10000.0, rope_dim)
    assert got.dtype == torch.bfloat16
    _close(got.float(), np.asarray(want, np.float32), 1e-2)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_gated_mlp_matches_reference(act):
    x = RNG.normal(size=(2, 5, 24)).astype(np.float32)
    w = {n: (RNG.normal(size=s) / np.sqrt(s[0])).astype(np.float32)
         for n, s in (("gate", (24, 40)), ("up", (24, 40)), ("down", (40, 24)))}
    want = JL.swiglu(jnp.asarray(x), *(jnp.asarray(w[n]) for n in ("gate", "up", "down")),
                     act=act)
    got = TL.swiglu(torch.as_tensor(x), *(torch.as_tensor(w[n]) for n in ("gate", "up", "down")),
                    act=act)
    _close(got, want)
    tw = {k: torch.as_tensor(v) for k, v in w.items()}
    _close(TL.mlp_apply(tw, torch.as_tensor(x), act),
           JL.mlp_apply({k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(x), act))
    plain = {k: v for k, v in tw.items() if k != "gate"}
    _close(TL.mlp_apply(plain, torch.as_tensor(x), act),
           JL.mlp_apply({k: jnp.asarray(v.numpy()) for k, v in plain.items()},
                        jnp.asarray(x), act))


def test_layer_norm_matches_reference():
    x = (RNG.normal(size=(3, 4, 32)) * 3 + 1).astype(np.float32)
    g, b = RNG.normal(size=32).astype(np.float32), RNG.normal(size=32).astype(np.float32)
    for eps in (1e-5, 1e-2):
        _close(TL.layer_norm(*(torch.as_tensor(a) for a in (x, g, b)), eps),
               JL.layer_norm(*(jnp.asarray(a) for a in (x, g, b)), eps))


@pytest.mark.parametrize("n_ignored", [0, 5, 24])
def test_cross_entropy_matches_reference(n_ignored):
    """Mean NLL over the kept labels; all labels ignored gives 0 (the count's
    floor of 1), as in the reference."""
    logits = (RNG.normal(size=(3, 8, 50)) * 4).astype(np.float32)
    labels = RNG.integers(0, 50, (3, 8)).astype(np.int32)
    labels.reshape(-1)[RNG.permutation(24)[:n_ignored]] = -1
    want = float(JL.cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    got = TL.cross_entropy(torch.as_tensor(logits), torch.as_tensor(labels))
    assert got.dtype == torch.float32
    assert abs(float(got) - want) <= 1e-5 * max(1.0, abs(want))
    got_b = TL.cross_entropy(torch.as_tensor(logits).bfloat16(), torch.as_tensor(labels))
    want_b = float(JL.cross_entropy(jnp.asarray(logits, jnp.bfloat16), jnp.asarray(labels)))
    assert abs(float(got_b) - want_b) <= 1e-5 * max(1.0, abs(want_b))


# -- attention with compute_dtype="bf16" ------------------------------------------

@pytest.mark.parametrize("fn", ["naive", "blocked"])
@pytest.mark.parametrize("case", ["causal", "cache", "cross"])
def test_bf16_compute_matches_reference(fn, case):
    """bf16 q, k, v (the cdtype of a cfg.dtype="bfloat16" model) through the
    bf16-operand, f32-accumulation branch, GQA 4:2, within 3e-2; bkv 4 < T,
    so _blocked walks blocks."""
    Bq, Hq, Hkv, D = 2, 4, 2, 16
    S_, T_, kv_len, q_off, causal = {"causal": (9, 9, None, None, True),
                                     "cache": (3, 14, 11, 8, True),
                                     "cross": (5, 13, None, None, False)}[case]
    q, k, v = (RNG.normal(size=s).astype(np.float32)
               for s in ((Bq, Hq, S_, D), (Bq, Hkv, T_, D), (Bq, Hkv, T_, D)))
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    tq, tk, tv = (torch.as_tensor(a).bfloat16() for a in (q, k, v))
    if fn == "naive":
        want = JA._naive(jq, jk, jv, causal, kv_len, 0.0, q_off, compute_dtype="bf16")
        got = TA._naive(tq, tk, tv, causal, kv_len, 0.0, q_off, compute_dtype="bf16")
    else:
        want = JA._blocked(jq, jk, jv, causal, kv_len, 4, 0.0, q_off, compute_dtype="bf16")
        got = TA._blocked(tq, tk, tv, causal, kv_len, 4, 0.0, q_off, compute_dtype="bf16")
    assert got.dtype == torch.bfloat16
    _close(got.float(), np.asarray(want, np.float32), 3e-2)
    # the f32 branch on the same inputs stays within the same gate of it
    f32 = getattr(TA, f"_{fn}")(tq, tk, tv, causal, kv_len, *(() if fn == "naive" else (4,)),
                                0.0, q_off)
    _close(got.float(), f32.float(), 3e-2)


@pytest.mark.parametrize("impl", ["naive", "blocked"])
def test_bf16_model_matches_reference(impl, params):
    """llama3.2-1b SMOKE at cfg.dtype="bfloat16", attn_compute_dtype="bf16":
    forward logits within 3e-2 × max(|logits|, 1) of the reference's."""
    kw = dict(dtype="bfloat16", attn_compute_dtype="bf16")
    jcfg, tcfg = _cfgs("llama3.2-1b", impl, **kw)
    p = params("llama3.2-1b")
    want = np.asarray(JT.forward(jax.tree.map(jnp.asarray, p),
                                 {"tokens": jnp.asarray(TOKENS)}, jcfg)[0], np.float32)
    got = TT.forward(convert.model_params_to_torch(p, "cpu"),
                     {"tokens": torch.as_tensor(TOKENS)}, tcfg)[0]
    assert got.dtype == torch.bfloat16
    assert np.abs(got.float().numpy() - want).max() <= 3e-2 * max(1.0, np.abs(want).max())


def test_bf16_weight_gradient_rounds_once():
    """The gradient of a broadcast bf16 weight (rms_norm's gamma) is the sum
    of its bf16 products rounded once to bf16 in the port; the reference
    rounds on the way, so it is no closer to the exact sum.  This is the
    1-3 % bf16 gradient gap of tests/test_torch_train.py."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 64)).astype(np.float32)
    g = (1 + 0.1 * rng.normal(size=64)).astype(np.float32)
    c = rng.normal(size=(64, 64)).astype(np.float32)
    want = np.asarray(jax.grad(lambda w: jnp.sum((JL.rms_norm(
        jnp.asarray(x, jnp.bfloat16), w.astype(jnp.bfloat16)) * jnp.asarray(c, jnp.bfloat16)
                                                   ).astype(jnp.float32)))(jnp.asarray(g)))
    gt = torch.tensor(g, requires_grad=True)
    xn = TL.rms_norm(torch.tensor(x).bfloat16(), gt.bfloat16())
    (xn * torch.tensor(c).bfloat16()).float().sum().backward()
    products = (TL.rms_norm(torch.tensor(x).bfloat16(), torch.ones(64, dtype=torch.bfloat16))
                * torch.tensor(c).bfloat16()).double()
    exact = products.sum(0).numpy()
    half_ulp = 2.0 ** (np.floor(np.log2(np.abs(exact))) - 8)
    got = gt.grad.numpy()
    assert np.all(np.abs(got - exact) <= half_ulp * 1.01)
    assert np.abs(want - exact).max() >= np.abs(got - exact).max()


# -- remat, configs ---------------------------------------------------------------

def test_remat_gives_the_same_loss_and_grads(params):
    """cfg.remat checkpoints each period: the same loss and grads as without,
    and the period's forward runs twice (once more in the backward)."""
    _, cfg = _cfgs("llama3.2-1b", "flash")
    tparams = convert.model_params_to_torch(params("llama3.2-1b"), "cpu")
    toks = torch.as_tensor(TOKENS).long()
    batch = {"tokens": toks, "labels": toks.roll(-1, 1)}
    calls = []
    real = tops.flash_attention

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    tops.flash_attention = spy
    try:
        outs = [loss_and_grads(tparams, batch, cfg.replace(remat=r)) for r in (False, True)]
    finally:
        tops.flash_attention = real
    assert len(calls) == 3 * cfg.n_layers      # once without remat, twice with
    (l0, _, g0), (l1, _, g1) = outs
    assert float(l0) == float(l1)
    for a, b in zip(jax.tree.leaves(convert.model_params_to_numpy(g0)),
                    jax.tree.leaves(convert.model_params_to_numpy(g1))):
        assert np.allclose(a, b, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_reference(arch, smoke):
    j, t = jax_config(arch, smoke=smoke), torch_config(arch, smoke=smoke)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert t.param_count() == j.param_count()
    assert t.cdtype == (torch.float32 if smoke else torch.bfloat16)


def test_registry_and_full_sizes():
    """The port registers the reference's archs, all ten, with the
    reference's parameter counts and, for MoE, active parameter counts."""
    from repro.configs import ALL_ARCHS as JAX_ARCHS
    assert ALL_ARCHS == JAX_ARCHS
    assert {"whisper-large-v3", *ARCHS} <= set(ALL_ARCHS)
    assert torch_config("llama3.2-1b").param_count() == 1_235_814_400
    for arch in ALL_ARCHS:
        for smoke in (False, True):
            assert (dataclasses.asdict(torch_config(arch, smoke=smoke))
                    == dataclasses.asdict(jax_config(arch, smoke=smoke)))
        t, j = torch_config(arch), jax_config(arch)
        assert t.param_count() == j.param_count()
        assert t.active_param_count() == j.active_param_count()
