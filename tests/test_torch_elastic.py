"""Elastic rescale (``runtime.elastic``: ``factor_mesh``,
``make_mesh_from_devices``, ``remesh_plan``; ``CheckpointManager.restore(
shardings=)``) against the JAX package, on the CPU.

* ``factor_mesh`` equals the reference's for every n in 1-512, every
  ``prefer_model`` of {0, 1, 2, 4, 16}, with and without ``multi_pod``.
* ``remesh_plan``'s specs equal the reference's ``param_pspecs`` for
  llama3.2-1b, qwen3-moe and minicpm3-4b SMOKE on (2, 2), (1, 2), (4, 1)
  and (2, 2, 2) meshes, each bound to the mesh given (the specs need only
  its axis names and shape, so a mesh of 8 needs no 8 ranks here).
* The flow of tests/test_distributed.py:154-162 across two gloo worlds
  (`tests/torch_spmd_worlds.py`, cases in `tests/torch_pod_cases.py`): 4
  ranks train llama3.2-1b SMOKE 4 steps on a (2, 2) mesh and save; 2 ranks
  restore on ``factor_mesh(2, prefer_model=2)`` through
  ``restore(shardings=remesh_plan(...))``: every block equals the saved
  array cut by ``core.partition.block`` bit for bit, and the resumed step's
  loss and grad norm are within rtol 1e-5 and 1e-4 of the one-rank port's
  step (restored with ``shardings=None`` onto one device, every leaf bit for
  bit the saved array) and of the reference's step from the same saved
  arrays (its ``make_train_step`` outside its mesh, as
  tests/test_torch_train.py runs it).
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec  # noqa: E402

from repro import checkpoint as jckpt  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.core.partition import DEFAULT_RULES as JAX_RULES  # noqa: E402
from repro.launch.steps import make_train_step as jax_train_step  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.layers import param_pspecs as jax_param_pspecs  # noqa: E402
from repro.runtime import factor_mesh as jax_factor_mesh  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch._tree import flatten  # noqa: E402
from repro_torch.checkpoint import CheckpointConfig, CheckpointManager  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.partition import spec_leaves  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.launch.train import build_state  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.runtime import factor_mesh, remesh_plan  # noqa: E402
from tests import torch_pod_cases as C  # noqa: E402
from tests import torch_spmd_worlds as W  # noqa: E402
from tests.torch_lm_oracle import auto_mesh  # noqa: E402


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("prefer", [0, 1, 2, 4, 16])
def test_factor_mesh_matches_reference(prefer, multi_pod):
    for n in range(1, 513):
        got = factor_mesh(n, prefer_model=prefer, multi_pod=multi_pod)
        assert got == jax_factor_mesh(n, prefer_model=prefer, multi_pod=multi_pod), n
    with pytest.raises(ValueError):
        factor_mesh(0)


@pytest.mark.parametrize("shape", [(2, 2), (1, 2), (4, 1), (2, 2, 2)])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen3-moe-235b-a22b", "minicpm3-4b"])
def test_remesh_plan_matches_reference_specs(arch, shape):
    axes = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    mesh = types.SimpleNamespace(axis_names=axes, shape=shape)
    plan = spec_leaves(remesh_plan(T.abstract_params(get_config(arch, smoke=True)), mesh))
    want = jax.tree.leaves(
        jax_param_pspecs(JT.abstract_params(jax_config(arch, smoke=True)), JAX_RULES, axes,
                         dict(zip(axes, shape))),
        is_leaf=lambda x: isinstance(x, PartitionSpec))
    assert len(plan) == len(want) > 0
    for got, w in zip(plan, want):
        assert got.mesh is mesh
        assert tuple(got.spec) == tuple(w), (got.spec, w)


@pytest.fixture(scope="module")
def rescale(tmp_path_factory):
    """(the saving world's losses, the restoring ranks' results, the
    checkpoint's directory)."""
    tmp = tmp_path_factory.mktemp("elastic")
    ckpt = str(tmp / "ckpt")
    saved = W.one_result(W.World("elastic_save", 4, tmp / "save", args=(ckpt,), timeout=120.0))
    world = W.World("elastic_restore", 2, tmp / "restore", args=(ckpt,), timeout=120.0)
    try:
        res = world.results()
    finally:
        world.close()
    return saved, res, ckpt


def test_rescale_restores_each_block_bit_for_bit(rescale):
    saved, res, _ = rescale
    assert len(saved["losses"]) == C.ELASTIC_STEPS and np.isfinite(saved["losses"]).all()
    for r in res:
        assert r["mesh"] == ((1, 2), ("data", "model")) and r["step"] == C.ELASTIC_STEPS
        assert r["equal"] and all(r["equal"].values()), r["equal"]
    # the embedding is cut over the vocab, the norms' gains are whole
    cfg = get_config(C.ARCH, smoke=True)
    assert res[0]["shapes"]["params/embed"] == (cfg.vocab // 2, cfg.d_model)
    assert res[0]["shapes"]["opt/step"] == ()
    assert res[0]["mets"] == res[1]["mets"]


def test_resumed_step_matches_one_rank_and_reference(rescale):
    _, res, ckpt = rescale
    cfg = get_config(C.ARCH, smoke=True)
    proto = build_state(cfg, 1, "cpu")
    state, step_no, _ = CheckpointManager(CheckpointConfig(ckpt)).restore(proto)
    assert step_no == C.ELASTIC_STEPS
    for (_, t), want in zip(flatten(state), C.saved_arrays(ckpt, step_no)):
        assert t.numpy().dtype == want.dtype and t.numpy().tobytes() == want.tobytes()
    batch = C.train_batches(cfg.vocab, C.ELASTIC_STEPS + 1)[-1]
    step = make_train_step(cfg, toptim.AdamWConfig(lr=C.LR), total_steps=C.TOTAL,
                           warmup=C.WARMUP)
    # the reference's state, read by its own manager from the same files
    jproto = {"params": convert.model_params_to_numpy(state["params"]),
              "opt": convert.opt_state_to_numpy(state["opt"])}
    jstate, _, _ = jckpt.CheckpointManager(jckpt.CheckpointConfig(ckpt)).restore(jproto)
    _, one = step(state, {k: torch.as_tensor(v).long() for k, v in batch.items()})
    jstep = jax.jit(jax_train_step(jax_config(C.ARCH, smoke=True), auto_mesh(),
                                   joptim.AdamWConfig(lr=C.LR), total_steps=C.TOTAL,
                                   warmup=C.WARMUP))
    _, ref = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    got = res[0]["mets"]
    for want in ({k: float(v) for k, v in one.items()}, {k: float(v) for k, v in ref.items()}):
        assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"]), (got, want)
        assert abs(got["grad_norm"] - want["grad_norm"]) <= 1e-4 * abs(want["grad_norm"])


def test_restore_shardings_must_match_the_target(rescale):
    _, _, ckpt = rescale
    proto = build_state(get_config(C.ARCH, smoke=True), 1, "cpu")
    with pytest.raises(ValueError, match="shardings hold 2 leaves"):
        CheckpointManager(CheckpointConfig(ckpt)).restore(
            proto, shardings={"params": None, "opt": None})
