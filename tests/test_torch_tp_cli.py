"""``serve`` and ``train --model-parallel 2 --dist-backend gloo --device cpu``
on 4 ranks (a (2, 2) mesh of one gloo world, `tests/torch_spmd_worlds.py`,
the CLIs joining the group the world made as they join torchrun's), against
the one-device CLIs in this process, on the CPU:

* the served tokens equal the one-device CLI's, the step losses within rtol
  1e-5 of its;
* the checkpoint the mesh run writes (rank 0, the gathered tree) has the
  one-device run's leaves and shapes, and a one-device run restarts from it
  with the uninterrupted run's losses;
* minicpm3-4b, jamba-v0.1-52b and xlstm-350m (the part-2b mixers) serve
  and train on the mesh: tokens equal to the one-device CLI's, losses
  within rtol 1e-5; more than one rank needs ``--dist-backend``, and
  ``--model-parallel`` above 1 needs torchrun.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import serve, train  # noqa: E402
from tests import torch_spmd_worlds as W  # noqa: E402
from tests import torch_tp_cases as C  # noqa: E402


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(what every rank of the mesh run returned, the mesh run's checkpoint
    directory)."""
    tmp = tmp_path_factory.mktemp("tp_cli")
    ckpt = str(tmp / "ckpt")
    world = W.World("tp_cli", 4, tmp / "world", args=(ckpt,), timeout=240.0)
    try:
        res = world.results()
    finally:
        world.close()
    return res, ckpt


def test_mesh_serve_equals_one_device(runs):
    res, _ = runs
    one = serve.run(C.SERVE_ARGS)
    for r in res:
        assert r["tokens"].shape == one.shape == (6, 4)
        assert np.array_equal(r["tokens"], one)


def test_mesh_train_losses_equal_one_device(runs):
    res, _ = runs
    one = train.run(C.TRAIN_ARGS)
    for r in res:
        assert len(r["losses"]) == len(one) == 4
        assert np.allclose(r["losses"], one, rtol=1e-5, atol=0)


def test_mesh_checkpoint_restarts_on_one_device(runs, tmp_path):
    _, ckpt = runs
    mine = str(tmp_path / "one")
    train.run(C.TRAIN_ARGS + ["--ckpt", mine, "--ckpt-every", "2"])
    for step in ("step_00000002", "step_00000004"):
        with open(os.path.join(ckpt, step, "meta.json")) as fh:
            got = json.load(fh)
        with open(os.path.join(mine, step, "meta.json")) as fh:
            want = json.load(fh)
        assert (got["paths"], got["shapes"], got["dtypes"]) == (
            want["paths"], want["shapes"], want["dtypes"])
    resumed = train.run(C.TRAIN_ARGS[:4] + ["6"] + C.TRAIN_ARGS[5:] + ["--ckpt", ckpt])
    whole = train.run(C.TRAIN_ARGS[:4] + ["6"] + C.TRAIN_ARGS[5:])
    assert len(resumed) == 2
    assert np.allclose(resumed, whole[4:], rtol=1e-5, atol=0)


def test_part_2b_arch_raises_on_the_mesh(runs):
    """(The name dates from when these archs refused a model axis of more
    than one rank.)  Each serves and trains on the (2, 2) mesh as on one
    device."""
    res, _ = runs
    for arch in C.PART_2B:
        toks = serve.run(["--arch", arch] + C.SERVE_ARGS)
        losses = train.run(["--arch", arch] + C.PART_2B_TRAIN_ARGS)
        for r in res:
            got_toks, got_losses = r["part2b"][arch]
            assert got_toks.shape == toks.shape == (6, 4)
            assert np.array_equal(got_toks, toks), arch
            assert len(got_losses) == len(losses) == 2
            assert np.allclose(got_losses, losses, rtol=1e-5, atol=0), (arch, got_losses, losses)


def test_mesh_flags_need_torchrun_and_a_backend(monkeypatch, capsys):
    with pytest.raises(SystemExit):
        serve.run(C.SERVE_ARGS + ["--model-parallel", "2"])
    assert "torchrun" in capsys.readouterr().err
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(SystemExit):
        train.run(C.TRAIN_ARGS + ["--model-parallel", "2"])
    assert "--dist-backend" in capsys.readouterr().err
