"""The LM's train step on ``("data", "model")`` meshes of gloo ranks,
against the JAX package's ``make_train_step`` outside its mesh and the
port's one-rank gradients, on the CPU.

This process runs the reference's jitted step for 3 steps of llama3.2-1b and
qwen3-moe SMOKE (`tests/torch_lm_oracle.py` `jax_train`); one gloo world of 4
single-threaded ranks (`tests/torch_spmd_worlds.py`) then takes each step on
(2, 2) and (1, 4) meshes from the reference's state before it
(`tests/torch_tp_cases.py`):

* per-step ``loss`` and ``grad_norm`` within rtol 1e-4 of the reference's,
  ``aux`` within 1e-5 and the MoE counters equal;
* every leaf's gradient, gathered from the ranks' blocks and averaged over
  the data axis, within 1e-5 (relative L2) of the one-rank port's on the
  same state: a replicated region summed twice would show here n times too
  large;
* minicpm3-4b, jamba-v0.1-52b and xlstm-350m (the mla, mamba, mlstm and
  slstm mixers, ROADMAP item 8(e) part 2b) take a step on a model axis of 2
  (the (1, 2) mesh) whose loss is within rtol 1e-5 and grad norm within
  rtol 1e-4 of the one-rank step's, and their step on a (2, 1) mesh (data
  parallelism alone) equals the one-rank step within rtol 1e-5
  (`tests/test_torch_tp_mixers_train.py` holds them on every mesh);
* llama3.2-1b SMOKE with a vocab of 250 padded to 256 through ``loss`` on
  (1, 2), (1, 4) and (2, 2) meshes, with labels in every rank's vocab block
  and ignored labels (the vocab-parallel cross-entropy, no vocab block
  gathered): the loss within rtol 1e-5 and every gathered gradient within
  1e-5 of the one-rank port's.
"""
import pickle

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.layers import init_params as jax_init_params  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from tests import torch_lm_oracle as O  # noqa: E402
from tests import torch_spmd_worlds as W  # noqa: E402
from tests import torch_tp_cases as C  # noqa: E402


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's per-step metrics by arch, the ranks' results)."""
    tmp = tmp_path_factory.mktemp("tp_train")
    data, ref = {}, {}
    for arch in C.TRAIN_ARCHS:
        jcfg = jax_config(arch, smoke=True)
        params = jax.tree.map(np.asarray, jax_init_params(JT.abstract_params(jcfg),
                                                          jax.random.key(0)))
        states, mets = O.jax_train(params, jcfg)
        tcfg = get_config(arch, smoke=True)
        data[arch] = (states, [O.train_batch(tcfg, s) for s in range(C.STEPS)])
        ref[arch] = mets
    data["part2b-batch"] = O.train_batch(get_config("llama3.2-1b", smoke=True), 0)
    in_path = str(tmp / "inputs.pkl")
    with open(in_path, "wb") as fh:
        pickle.dump(data, fh)
    world = W.World("tp_train", 4, tmp / "world", args=(in_path,), timeout=240.0)
    try:
        res = world.results()
    finally:
        world.close()
    for r, other in enumerate(res[1:], 1):
        assert W.same(res[0]["same"], other["same"]), f"rank {r} differs from rank 0"
    return ref, res[0]["same"]


@pytest.mark.parametrize("shape", C.TRAIN_MESHES)
@pytest.mark.parametrize("arch", C.TRAIN_ARCHS)
def test_train_steps_match_reference(runs, arch, shape):
    ref, port = runs
    mets, _ = port[("train", arch, shape)]
    for s in range(C.STEPS):
        got, want = mets[s], ref[arch][s]
        for k in ("loss", "grad_norm"):
            assert abs(got[k] - want[k]) <= 1e-4 * abs(want[k]), (s, k, got[k], want[k])
        assert abs(got["aux"] - want["aux"]) <= 1e-5 * max(abs(want["aux"]), 1.0)
        for k in ("moe_drops", "moe_peak_occupancy"):
            assert got[k] == want[k], (s, k)


@pytest.mark.parametrize("shape", C.TRAIN_MESHES)
@pytest.mark.parametrize("arch", C.TRAIN_ARCHS)
def test_gathered_grads_equal_the_one_rank_port(runs, arch, shape):
    _, port = runs
    _, gerr = port[("train", arch, shape)]
    for s, errs in enumerate(gerr):
        worst = max(errs, key=errs.get)
        assert errs[worst] <= 1e-5, (s, worst, errs[worst])


@pytest.mark.parametrize("arch", C.PART_2B)
def test_part_2b_mixers_raise_on_a_model_axis_and_train_on_the_data_axis(runs, arch):
    """(The name dates from when these mixers refused a model axis of more
    than one rank.)  A step on a model axis of 2 and on the data axis alone
    against the one-rank step."""
    _, port = runs
    model, data, one = port[("part2b", arch)]
    for k, rtol in (("loss", 1e-5), ("grad_norm", 1e-4)):
        assert abs(model[k] - one[k]) <= rtol * abs(one[k]), (k, model[k], one[k])
    for k in ("loss", "grad_norm"):
        assert abs(data[k] - one[k]) <= 1e-5 * abs(one[k]), (k, data[k], one[k])


@pytest.mark.parametrize("shape", C.MESHES)
def test_vocab_parallel_loss_gradients_equal_the_one_rank_port(runs, shape):
    _, port = runs
    split, gathers, loss, one, errs = port[("vocab-grads", shape)]
    assert split == shape[1] and gathers == []
    assert abs(loss - one) <= 1e-5 * abs(one), (loss, one)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-5, (worst, errs[worst])
