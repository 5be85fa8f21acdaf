"""The train step of the archs with the mla, mamba, mlstm and slstm mixers
on ``("data", "model")`` meshes of gloo ranks, against the JAX package's
``make_train_step`` outside its mesh and the port's one rank; and their
checkpoints across meshes; on the CPU.

This process runs the reference's jitted step for 3 steps of minicpm3-4b,
jamba-v0.1-52b and xlstm-350m SMOKE (`tests/torch_lm_oracle.py`
``jax_train``); one gloo world of 4 single-threaded ranks
(`tests/torch_spmd_worlds.py`) then takes each step on (1, 2), (1, 4) and
(2, 2) meshes from the reference's state before it (`tests/torch_tp_cases.py`
``mixer_train_results``):

* per-step ``loss`` within rtol 1e-4 of the reference's, ``grad_norm``
  within each arch's one-rank gate (rtol 1e-4; minicpm3-4b 2e-3, its
  float32 noise, `tests/test_torch_mla.py`), ``aux`` within 1e-5 and the MoE
  counters equal;
* every leaf's gradient, gathered from the ranks' blocks and averaged over
  the data axis, against the one-rank port's on the same state (relative
  L2 over at least ``GRAD_FLOOR`` of the whole gradient's norm): within
  ``GRAD_RTOL``.  At the reference's init these SMOKE networks turn float32
  rounding into gradient changes of that order (the sums' order alone moved
  them by up to 1.1e-4 for minicpm3-4b, 2.4e-5 for jamba and 1.4e-5 for
  xlstm here), where a gradient not summed over the model axis, or summed
  twice, would be off by a half or more;
* a jamba and an xlstm train state (their fused ``in_proj`` and ``up`` cut
  part by part) saved from the (1, 2) mesh restore bit for bit on the
  (1, 4) mesh and on one device.
"""
import pickle

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.layers import init_params as jax_init_params  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from tests import torch_lm_oracle as O  # noqa: E402
from tests import torch_spmd_worlds as W  # noqa: E402
from tests import torch_tp_cases as C  # noqa: E402

GNORM_RTOL = {"minicpm3-4b": 2e-3, "jamba-v0.1-52b": 1e-4, "xlstm-350m": 1e-4}
GRAD_RTOL = {"minicpm3-4b": 5e-4, "jamba-v0.1-52b": 1e-4, "xlstm-350m": 5e-5}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's per-step metrics by arch, the ranks' results)."""
    tmp = tmp_path_factory.mktemp("tp_mixers_train")
    data, ref = {}, {}
    for arch in C.PART_2B:
        jcfg = jax_config(arch, smoke=True)
        params = jax.tree.map(np.asarray, jax_init_params(JT.abstract_params(jcfg),
                                                          jax.random.key(0)))
        states, mets = O.jax_train(params, jcfg)
        tcfg = get_config(arch, smoke=True)
        data[arch] = (states, [O.train_batch(tcfg, s) for s in range(C.STEPS)])
        ref[arch] = mets
    in_path = str(tmp / "inputs.pkl")
    with open(in_path, "wb") as fh:
        pickle.dump(data, fh)
    world = W.World("tp_mixers_train", 4, tmp / "world", args=(in_path, str(tmp / "ckpt")),
                    timeout=240.0)
    try:
        res = world.results()
    finally:
        world.close()
    for r, other in enumerate(res[1:], 1):
        assert W.same(res[0]["same"], other["same"]), f"rank {r} differs from rank 0"
    return ref, res[0]["same"]


@pytest.mark.parametrize("shape", C.MESHES)
@pytest.mark.parametrize("arch", C.PART_2B)
def test_train_steps_match_reference(runs, arch, shape):
    ref, port = runs
    mets, _ = port[("train", arch, shape)]
    for s in range(C.STEPS):
        got, want = mets[s], ref[arch][s]
        for k, rtol in (("loss", 1e-4), ("grad_norm", GNORM_RTOL[arch])):
            assert abs(got[k] - want[k]) <= rtol * abs(want[k]), (s, k, got[k], want[k])
        assert abs(got["aux"] - want["aux"]) <= 1e-5 * max(abs(want["aux"]), 1.0)
        for k in ("moe_drops", "moe_peak_occupancy"):
            assert got[k] == want[k], (s, k)


@pytest.mark.parametrize("shape", C.MESHES)
@pytest.mark.parametrize("arch", C.PART_2B)
def test_gathered_grads_equal_the_one_rank_port(runs, arch, shape):
    _, port = runs
    _, gerr = port[("train", arch, shape)]
    for s, errs in enumerate(gerr):
        worst = max(errs, key=errs.get)
        assert errs[worst] <= GRAD_RTOL[arch], (s, worst, errs[worst])


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "xlstm-350m"])
def test_checkpoint_from_one_mesh_restores_on_another_and_on_one_device(runs, arch):
    _, port = runs
    assert port[("checkpoint", arch)] == {(1, 4): (3, True), None: (3, True)}
