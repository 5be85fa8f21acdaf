"""The port's whisper serve path against the JAX package, on the CPU.

Whisper SMOKE with each attention impl (flash, blocked, naive), on params made
by the reference's ``init_params`` and carried across by
``convert.model_params_to_torch``: ``forward`` logits, then ``prefill`` and
teacher-forced ``decode_step`` logits, within 2e-3 × max(|logits|, 1) (the
tolerance of tests/test_models.py); the rule that the kernel is taken only
where ``attention.py:224`` takes it; the parameter conversion; ``serve_batch``
tokens against the reference's; the configs and init rules.  Each JAX
reference is computed once per module.
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
from repro.models.layers import init_params as jax_init_params  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config as torch_config  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

ARCH = "whisper-large-v3"
IMPLS = ["flash", "blocked", "naive"]
B, S, PRE = 2, 12, 8          # batch, sequence, prefill length (then S - PRE decode steps)


def _cfgs(impl):
    # bkv 8 < enc_seq 24, so the blocked impl really walks KV blocks
    kw = dict(attn_impl=impl, bkv=8)
    return jax_config(ARCH, smoke=True).replace(**kw), torch_config(ARCH, smoke=True).replace(**kw)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Keep this file's CPU load small beside the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def params():
    """Reference params as numpy (the same tree for every impl)."""
    p = jax_init_params(JT.abstract_params(jax_config(ARCH, smoke=True)), jax.random.key(0))
    return jax.tree.map(np.asarray, p)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    cfg = jax_config(ARCH, smoke=True)
    return {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
            "frames": rng.normal(size=(B, cfg.enc_seq, cfg.d_frontend)).astype(np.float32)}


@pytest.fixture(scope="module")
def reference(params, inputs):
    """impl → (JAX forward logits (B, S, V), JAX serve logits (B, 1 + S - PRE, V)),
    computed at first use."""
    done = {}

    def get(impl):
        if impl not in done:
            cfg, _ = _cfgs(impl)
            p = jax.tree.map(jnp.asarray, params)
            toks, frames = jnp.asarray(inputs["tokens"]), jnp.asarray(inputs["frames"])
            full, *_ = JT.forward(p, {"tokens": toks, "frames": frames}, cfg)
            cache = JT.init_cache(cfg, B, S)
            lg, cache = JT.prefill(p, {"tokens": toks[:, :PRE], "frames": frames}, cfg, cache)
            steps = [np.asarray(lg[:, 0])]
            for t in range(PRE, S):
                lg, cache = JT.decode_step(p, {"tokens": toks[:, t:t + 1]}, cfg, cache)
                steps.append(np.asarray(lg))
            done[impl] = np.asarray(full), np.stack(steps, 1)
        return done[impl]
    return get


def _port_serve_logits(tparams, cfg, inputs):
    toks = torch.as_tensor(inputs["tokens"])
    cache = TT.init_cache(cfg, B, S, device="cpu")
    lg, cache = TT.prefill(tparams, {"tokens": toks[:, :PRE],
                                     "frames": torch.as_tensor(inputs["frames"])}, cfg, cache)
    steps = [lg[:, 0]]
    for t in range(PRE, S):
        lg, cache = TT.decode_step(tparams, {"tokens": toks[:, t:t + 1]}, cfg, cache)
        steps.append(lg)
    return torch.stack(steps, 1).numpy(), cache


def _tol(ref_logits):
    return 2e-3 * max(float(np.abs(ref_logits).max()), 1.0)


@pytest.mark.parametrize("impl", IMPLS)
def test_forward_matches_reference(impl, params, inputs, reference):
    _, cfg = _cfgs(impl)
    full_j, _ = reference(impl)
    tparams = convert.model_params_to_torch(params, "cpu")
    logits, aux, cache, _ = TT.forward(tparams, {k: torch.as_tensor(v) for k, v in inputs.items()},
                                       cfg)
    assert logits.shape == (B, S, cfg.vocab) and cache is None and float(aux) == 0.0
    assert np.abs(logits.numpy() - full_j).max() < _tol(full_j)


@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_and_decode_match_reference(impl, params, inputs, reference):
    """Prefill PRE tokens, then decode the rest teacher-forced; every step's
    logits against the reference's, and the last against the forward pass."""
    _, cfg = _cfgs(impl)
    full_j, serve_j = reference(impl)
    serve_t, cache = _port_serve_logits(convert.model_params_to_torch(params, "cpu"), cfg,
                                        inputs)
    assert serve_t.shape == serve_j.shape == (B, 1 + S - PRE, cfg.vocab)
    assert np.abs(serve_t - serve_j).max() < _tol(full_j)
    assert np.abs(serve_t - full_j[:, PRE - 1:]).max() < _tol(full_j)
    assert cache["pos"] == S and cache["blocks"]["0"]["idx"] == S
    assert tuple(cache["enc_out"].shape) == (B, cfg.enc_seq, cfg.d_model)


@pytest.mark.parametrize("impl", IMPLS)
def test_kernel_taken_exactly_where_the_reference_takes_it(impl, params, inputs, monkeypatch):
    """attention.py:224: the kernel only for impl == "flash", S > 1 and no KV
    cache.  A prefill takes it once per encoder layer (self-attention) and once
    per decoder layer (cross-attention), never for the cached decoder
    self-attention; a decode step (S = 1) never.  On CPU tensors it runs the
    plain version and counts no launch."""
    _, cfg = _cfgs(impl)
    calls = []
    real = tops.flash_attention

    def spy(q, k, v, causal=True, use_kernel=False):
        calls.append((tuple(q.shape), tuple(k.shape), causal, use_kernel))
        return real(q, k, v, causal, use_kernel)

    monkeypatch.setattr(tops, "flash_attention", spy)
    tops.reset_launch_counts()
    tparams = convert.model_params_to_torch(params, "cpu")
    toks = torch.as_tensor(inputs["tokens"])
    cache = TT.init_cache(cfg, B, S, device="cpu")
    _, cache = TT.prefill(tparams, {"tokens": toks[:, :PRE],
                                    "frames": torch.as_tensor(inputs["frames"])}, cfg, cache)
    H, D, E = cfg.n_heads, cfg.hd, cfg.enc_seq
    if impl == "flash":
        assert calls == ([((B, H, E, D), (B, H, E, D), False, True)] * cfg.n_enc_layers
                         + [((B, H, PRE, D), (B, H, E, D), False, True)] * cfg.n_layers)
    else:
        assert calls == []
    n_prefill = len(calls)
    TT.decode_step(tparams, {"tokens": toks[:, PRE:PRE + 1]}, cfg, cache)
    assert len(calls) == n_prefill
    assert tops.launch_counts()["flash_attention"] == 0


def test_padded_vocab_classes_masked_as_in_reference(inputs):
    """pad_vocab rounds V up to a multiple of 256; the padded classes' logits
    are -1e30 and the rest match the reference."""
    jcfg = jax_config(ARCH, smoke=True).replace(pad_vocab=True, vocab=250)
    tcfg = torch_config(ARCH, smoke=True).replace(pad_vocab=True, vocab=250)
    p = jax_init_params(JT.abstract_params(jcfg), jax.random.key(2))
    toks = inputs["tokens"] % 250
    full_j, *_ = JT.forward(p, {"tokens": jnp.asarray(toks),
                                "frames": jnp.asarray(inputs["frames"])}, jcfg)
    full_t, *_ = TT.forward(convert.model_params_to_torch(jax.tree.map(np.asarray, p), "cpu"),
                            {"tokens": torch.as_tensor(toks),
                             "frames": torch.as_tensor(inputs["frames"])}, tcfg)
    full_j = np.asarray(full_j)
    assert full_t.shape == (B, S, 256)
    assert np.all(full_t[..., 250:].numpy() == -1e30) and np.all(full_j[..., 250:] == -1e30)
    assert np.abs(full_t[..., :250].numpy() - full_j[..., :250]).max() < _tol(full_j[..., :250])


def test_convert_round_trip(params):
    tparams = convert.model_params_to_torch(params, "cpu")
    spec_shapes = tlayers.spec_tree_map(lambda s: s.shape,
                                        TT.abstract_params(torch_config(ARCH, smoke=True)))
    assert jax.tree.map(lambda t: tuple(t.shape), tparams) == spec_shapes
    back = convert.model_params_to_numpy(tparams)
    leaves_a, tree_a = jax.tree.flatten(params)
    leaves_b, tree_b = jax.tree.flatten(back)
    assert tree_a == tree_b
    for a, b in zip(leaves_a, leaves_b):
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)
    with pytest.raises(TypeError, match="floating point"):
        convert.model_params_to_torch({"embed": np.zeros((2, 2), np.int32)}, "cpu")


@pytest.mark.parametrize("impl", IMPLS)
def test_serve_batch_tokens_equal_reference(impl, params):
    """Greedy tokens of the port's serve_batch (zero frames, as the reference
    feeds) equal the JAX serve_batch's on the same prompts.  The reference's
    serve_batch cannot run impl="flash" on the CPU (its Pallas interpret mode
    raises ShardingTypeError under the host mesh), so the port's flash tokens
    are held to the reference's naive ones, which its own tests hold to flash."""
    jcfg, _ = _cfgs("naive" if impl == "flash" else impl)
    _, tcfg = _cfgs(impl)
    prompts = np.random.default_rng(5).integers(0, jcfg.vocab, (B, PRE)).astype(np.int32)
    out_j = jserve.serve_batch(jax.tree.map(jnp.asarray, params), jcfg, prompts, 4,
                               make_host_mesh())
    out_t = tserve.serve_batch(convert.model_params_to_torch(params, "cpu"), tcfg, prompts, 4,
                               device="cpu")
    assert out_t.shape == (B, 4)
    assert np.array_equal(out_t, np.asarray(out_j))


def test_serve_run_cli_on_cpu(capsys):
    out = tserve.run(["--smoke", "--device", "cpu", "--requests", "3", "--batch", "2",
                      "--prompt-len", "4", "--gen", "3"])
    assert out.shape == (3, 3) and out.min() >= 0 and out.max() < 256
    assert "done: 3 requests" in capsys.readouterr().out
    with pytest.raises(SystemExit):           # only the archs the registry holds
        tserve.run(["--arch", "no-such-arch", "--smoke", "--device", "cpu"])


def test_serve_needs_a_gpu_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.run(["--smoke", "--requests", "1", "--batch", "1", "--gen", "1"])


@pytest.mark.parametrize("smoke", [False, True])
def test_configs_equal_reference(smoke):
    j, t = jax_config(ARCH, smoke=smoke), torch_config(ARCH, smoke=smoke)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert t.param_count() == j.param_count()
    assert t.cdtype == (torch.float32 if smoke else torch.bfloat16)


def test_init_params_follow_reference_rules(params):
    """Same tree, shapes and dtypes as the reference; ones stay ones; random
    leaves have the reference's scale (fan-in from the middle dim of stacked
    weights)."""
    cfg = torch_config(ARCH, smoke=True)
    tparams = tlayers.init_params(TT.abstract_params(cfg), torch.Generator().manual_seed(0))
    leaves_t, tree_t = jax.tree.flatten(convert.model_params_to_numpy(tparams))
    leaves_j, tree_j = jax.tree.flatten(params)
    assert tree_t == tree_j
    for a, b in zip(leaves_t, leaves_j):
        assert a.shape == b.shape and a.dtype == b.dtype
        if np.all(b == 1):
            assert np.all(a == 1)
        elif b.size >= 1000:
            assert abs(a.std() / b.std() - 1) < 0.1


@pytest.mark.parametrize("change", [
    dict(pattern=(("attn", "moe"),), n_experts=4, top_k=2, d_ff_expert=8, moe_impl="noc"),
    dict(pattern=(("attn", "moe"),), n_experts=4, top_k=2, d_ff_expert=8, moe_impl="noc",
         moe_topology="ring", moe_flit_buffer_depth=1),
])
def test_unported_paths_raise(change):
    """The path that raised until the mesh half of the LM stack came, a MoE
    ffn on the noc engine, now runs with no mesh: the one-rank noc engine,
    whose forward logits equal the reference's under a one-device Auto-axis
    ``("data", "model")`` mesh within 2e-3 × max(|logits|, 1), its drops and
    peak exactly."""
    from jax.sharding import Mesh

    from repro.launch.mesh import set_mesh

    cfg = torch_config(ARCH, smoke=True).replace(**change)
    jcfg = jax_config(ARCH, smoke=True).replace(**change)
    p = tlayers.init_params(TT.abstract_params(cfg), torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, (1, 4)).astype(np.int32)
    frames = rng.normal(size=(1, cfg.enc_seq, cfg.d_frontend)).astype(np.float32)
    with torch.no_grad():
        logits, _, _, st = TT.forward(p, {"tokens": torch.as_tensor(toks).long(),
                                          "frames": torch.as_tensor(frames)}, cfg)
    jp = jax.tree.map(jnp.asarray, convert.model_params_to_numpy(p))
    with set_mesh(Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))):
        jlogits, _, _, jst = jax.jit(lambda p, b: JT.forward(p, b, jcfg))(
            jp, {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)})
    jlogits = np.asarray(jlogits)
    assert np.abs(logits.numpy() - jlogits).max() <= 2e-3 * max(1.0, np.abs(jlogits).max())
    for k in ("moe_drops", "moe_peak_occupancy"):
        assert int(st[k]) == int(jst[k])


def test_unknown_mixer_raises():
    cfg = torch_config(ARCH, smoke=True).replace(pattern=(("conv", "mlp"),))
    with pytest.raises(ValueError, match="unknown mixer 'conv'"):
        TT.abstract_params(cfg)
    with pytest.raises(ValueError, match="unknown mixer 'conv'"):
        TT.init_cache(cfg, 1, 4, device="cpu")
