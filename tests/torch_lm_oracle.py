"""Shared oracle of the port's model-family tests (tests/test_torch_moe.py,
test_torch_mla.py, test_torch_vlm.py); not collected itself.

Each family file holds its archs at SMOKE to the JAX package, on params made
by the reference's ``init_params`` and carried across by
``convert.model_params_to_torch``:

* ``forward`` logits, then ``prefill`` of PRE tokens and teacher-forced
  ``decode_step`` logits, within 2e-3 × max(|logits|, 1) (the tolerance of
  tests/test_models.py and of the dense family's tests);
* greedy serve tokens equal to the reference's;
* per-step ``loss`` within rtol 1e-4 and ``grad_norm`` within rtol 1e-4 (or
  the float32 noise a family file states) for three train steps, the port
  started from the reference's state at every step.

A vlm batch carries seeded ``patches``; its caches hold ``n_patches + S``
positions (the reference's own test sizes them so).  ``mesh`` runs the
reference under a one-device ``("data", "model")`` mesh with Auto axes, the
context its MoE gather engine needs (under ``make_host_mesh()``'s Explicit
axes ``moe_apply`` raises ``NotImplementedError``); the reference's loss and
grads are then taken under the same mesh as its forward.
"""
import contextlib

import numpy as np
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from repro import optim as joptim
from repro.configs import get_config as jax_config
from repro.launch.mesh import set_mesh
from repro.launch.steps import make_train_step as jax_train_step
from repro.models import transformer as JT
from repro.models.layers import init_params as jax_init_params
from repro_torch import convert
from repro_torch import optim as toptim
from repro_torch.configs import get_config as torch_config
from repro_torch.data import pipeline as tpipe
from repro_torch.launch.steps import make_train_step
from repro_torch.models import transformer as TT

B, S, PRE = 2, 12, 8          # batch, sequence, prefill length (then S - PRE decode steps)
LR, TOTAL, WARMUP, STEPS = 2e-3, 10, 5, 3


def cfgs(arch, impl, **kw):
    """(reference config, port config) at SMOKE; bkv 8 < S so the blocked
    impl walks KV blocks."""
    kw = dict(attn_impl=impl, bkv=8, **kw)
    return (jax_config(arch, smoke=True).replace(**kw),
            torch_config(arch, smoke=True).replace(**kw))


def auto_mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


def in_mesh(mesh):
    return set_mesh(mesh) if mesh is not None else contextlib.nullcontext()


def ref_params(arch, seed=0):
    """The reference's SMOKE params as numpy."""
    p = jax_init_params(JT.abstract_params(jax_config(arch, smoke=True)), jax.random.key(seed))
    return jax.tree.map(np.asarray, p)


def check_param_tree(arch):
    """The port's SMOKE init has the reference's tree, leaf order, shapes and
    dtypes, and the reference's params round-trip through ``convert``."""
    from repro_torch.models.layers import init_params

    ref = ref_params(arch)
    mine = init_params(TT.abstract_params(torch_config(arch, smoke=True)),
                       torch.Generator().manual_seed(0))
    got, tree = jax.tree.flatten(convert.model_params_to_numpy(mine))
    want, tree_j = jax.tree.flatten(ref)
    assert tree == tree_j
    assert [(a.shape, a.dtype) for a in got] == [(b.shape, b.dtype) for b in want]
    back = jax.tree.leaves(convert.model_params_to_numpy(convert.model_params_to_torch(ref,
                                                                                      "cpu")))
    assert all(np.array_equal(a, b) for a, b in zip(back, want))


def inputs(cfg, seed=0):
    """Seeded tokens (B, S), and patches for a vlm config."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        out["patches"] = rng.normal(size=(B, cfg.n_patches, cfg.d_frontend)).astype(np.float32)
    return out


def _cache_len(cfg, n):
    return n + (cfg.n_patches if cfg.family == "vlm" else 0)


def jax_logits(params, cfg, inp, mesh=None):
    """The reference's (forward logits (B, S, V), serve logits (B, 1 + S - PRE,
    V), forward moe_stats) on numpy inputs."""
    p = jax.tree.map(jnp.asarray, params)
    b = {k: jnp.asarray(v) for k, v in inp.items()}
    with in_mesh(mesh):
        full, _, _, st = JT.forward(p, b, cfg)
        cache = JT.init_cache(cfg, B, _cache_len(cfg, S))
        lg, cache = JT.prefill(p, dict(b, tokens=b["tokens"][:, :PRE]), cfg, cache)
        steps = [np.asarray(lg[:, 0])]
        for t in range(PRE, S):
            lg, cache = JT.decode_step(p, {"tokens": b["tokens"][:, t:t + 1]}, cfg, cache)
            steps.append(np.asarray(lg))
    return np.asarray(full), np.stack(steps, 1), {k: int(v) for k, v in st.items()}


def torch_logits(params, cfg, inp):
    """The port's counterpart of `jax_logits`, on the CPU."""
    p = convert.model_params_to_torch(params, "cpu")
    b = {k: torch.as_tensor(v) for k, v in inp.items()}
    full, _, _, st = TT.forward(p, b, cfg)
    cache = TT.init_cache(cfg, B, _cache_len(cfg, S), device="cpu")
    lg, cache = TT.prefill(p, dict(b, tokens=b["tokens"][:, :PRE]), cfg, cache)
    steps = [lg[:, 0]]
    for t in range(PRE, S):
        lg, cache = TT.decode_step(p, {"tokens": b["tokens"][:, t:t + 1]}, cfg, cache)
        steps.append(lg)
    assert cache["pos"] == _cache_len(cfg, S)
    return full.numpy(), torch.stack(steps, 1).numpy(), {k: int(v) for k, v in st.items()}


def tol(ref_logits):
    return 2e-3 * max(float(np.abs(ref_logits).max()), 1.0)


def jax_greedy(params, cfg, prompts, gen, mesh=None):
    """The reference's prefill and greedy decode driven by hand with a cache of
    n_patches + S + gen (its ``serve_batch`` sizes a vlm cache S + gen and
    overflows it), zero patches for a vlm config as its ``serve_batch`` feeds."""
    p = jax.tree.map(jnp.asarray, params)
    Bp, Sp = prompts.shape
    b = {"tokens": jnp.asarray(prompts)}
    if cfg.family == "vlm":
        b["patches"] = jnp.zeros((Bp, cfg.n_patches, cfg.d_frontend), cfg.cdtype)
    with in_mesh(mesh):
        cache = JT.init_cache(cfg, Bp, _cache_len(cfg, Sp + gen))
        lg, cache = JT.prefill(p, b, cfg, cache)
        tok = jnp.argmax(lg[:, -1], -1)
        out = [np.asarray(tok)]
        for _ in range(gen - 1):
            lg, cache = JT.decode_step(p, {"tokens": tok[:, None]}, cfg, cache)
            tok = jnp.argmax(lg, -1)
            out.append(np.asarray(tok))
    return np.stack(out, 1)


# -- training -------------------------------------------------------------------

def train_batch(cfg, step):
    """The pipeline's batch of ``step`` (batch 4, seq 16), with seeded patches
    for a vlm config."""
    b = tpipe._synthesize(tpipe.DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4,
                                           seed=0), step)
    if cfg.family == "vlm":
        rng = np.random.default_rng(100 + step)
        b["patches"] = rng.normal(size=(4, cfg.n_patches, cfg.d_frontend)).astype(np.float32)
    return b


def _tbatch(b):
    return {k: (torch.as_tensor(v).long() if v.dtype.kind == "i" else torch.as_tensor(v))
            for k, v in b.items()}


def jax_train(params, cfg, mesh=None):
    """The reference's states before each of STEPS steps and its per-step
    metrics, its jitted ``make_train_step`` traced and run under ``mesh``."""
    with in_mesh(mesh):
        step = jax.jit(jax_train_step(cfg, mesh or auto_mesh(), joptim.AdamWConfig(lr=LR),
                                      total_steps=TOTAL, warmup=WARMUP))
        p = jax.tree.map(jnp.asarray, params)
        state, states, mets = {"params": p, "opt": joptim.adamw_init(p)}, [], []
        for s in range(STEPS):
            states.append(jax.tree.map(np.asarray, state))
            state, m = step(state, {k: jnp.asarray(v) for k, v in train_batch(cfg, s).items()})
            mets.append({k: float(v) for k, v in m.items()})
    return states, mets


def check_train_steps(cfg, states, mets, gnorm_rtol=1e-4):
    """The port's step from the reference's state before each step: loss
    within rtol 1e-4, grad norm within ``gnorm_rtol``, aux within 1e-5 and
    the MoE counters equal."""
    step = make_train_step(cfg, toptim.AdamWConfig(lr=LR), total_steps=TOTAL, warmup=WARMUP)
    got = []
    for s in range(STEPS):
        state = {"params": convert.model_params_to_torch(states[s]["params"], "cpu"),
                 "opt": convert.opt_state_to_torch(states[s]["opt"], "cpu")}
        _, m = step(state, _tbatch(train_batch(cfg, s)))
        m = {k: float(v) for k, v in m.items()}
        for k, rtol in (("loss", 1e-4), ("grad_norm", gnorm_rtol)):
            assert abs(m[k] - mets[s][k]) <= rtol * abs(mets[s][k]), (s, k, m[k], mets[s][k])
        assert abs(m["aux"] - mets[s]["aux"]) <= 1e-5 * max(abs(mets[s]["aux"]), 1.0)
        for k in ("moe_drops", "moe_peak_occupancy"):
            assert m[k] == mets[s][k], (s, k)
        got.append(m)
    return got
