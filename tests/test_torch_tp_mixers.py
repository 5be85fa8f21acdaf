"""Tensor and data parallelism of the mla, mamba, mlstm and slstm mixers on
``("data", "model")`` meshes of gloo ranks, against the JAX package's
unsharded results and the port's one rank, on the CPU.

One gloo world of 4 single-threaded ranks (`tests/torch_spmd_worlds.py`)
runs the cases of `tests/torch_tp_cases.py` (``MIXER_CASES``,
``MIXER_LAYERS``) on (1, 2), (1, 4) and (2, 2) meshes while this process
computes the reference's results on the same params (the reference's init)
and inputs: minicpm3-4b with MLA expanded and absorbed, jamba-v0.1-52b,
xlstm-350m, and xlstm-350m with 2 heads, which a model axis of 4 does not
divide where it divides mLSTM's inner channels (the mixer then gathers its
leaves and runs whole on every rank, never on part of a head).

* ``forward``, ``prefill`` and teacher-forced ``decode_step`` logits within
  2e-3 × max(|logits|, 1) of the reference's (each arch's one-rank test
  tolerance, `tests/torch_lm_oracle.py`), ``loss`` within rtol 1e-4 with the
  MoE counters equal, and ``serve_batch(mesh=)`` tokens equal;
* each rank holds exactly its `param_pspecs` block of every leaf (Mamba's
  ``in_proj`` and mLSTM's ``up`` cut part by part), and its cache its batch
  rows and its block of each recurrent state (the MLA latent whole);
* ``shard_params`` then ``gather_params`` gives the tree back bit for bit;
* each mixer alone (norm and mixer, the reference's init) on (1, 2) and
  (1, 4) against one rank: the output within 1e-5 × max |out|, the gradient
  of x and the gathered gradient of every leaf within 1e-5 (relative L2,
  over at least ``GRAD_FLOOR`` of the whole gradient's norm); absorbed MLA
  within 1e-4, since its attention rounds the operands and probabilities to
  bf16 (the reference's ``compute_dtype="bf16"`` on that path) and a last-bit
  difference of a head's query flips roundings there.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_config  # noqa: E402
from repro_torch._tree import flatten  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.partition import Parts, local_shape, spec_leaves  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.layers import param_shapes  # noqa: E402
from tests import torch_spmd_worlds as W  # noqa: E402
from tests import torch_tp_cases as C  # noqa: E402

CASES = [c for c, _, _ in C.MIXER_CASES]
LAYERS = [c for c, _, _, _ in C.MIXER_LAYERS]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's results by case, the ranks' common results, each
    rank's own)."""
    tmp = tmp_path_factory.mktemp("tp_mixers")
    in_path = str(tmp / "inputs.pkl")
    data = C.write_model_inputs(in_path, C.MIXER_CASES)
    world = W.World("tp_mixers", 4, tmp / "world", args=(in_path,), timeout=240.0)
    try:
        ref = {case: C.ref_model(data[case][0], jax_config(arch, smoke=True).replace(**kw),
                                 data[case][1])
               for case, arch, kw in C.MIXER_CASES}
        res = world.results()
    finally:
        world.close()
    for r, other in enumerate(res[1:], 1):
        assert W.same(res[0]["same"], other["same"]), f"rank {r} differs from rank 0"
    return ref, res[0]["same"], [r["rank"] for r in res]


def _cfg(case):
    _, arch, kw = next(c for c in C.MIXER_CASES if c[0] == case)
    return get_config(arch, smoke=True).replace(**kw)


def _tol(ref_logits):
    return 2e-3 * max(float(np.abs(ref_logits).max()), 1.0)


def _err(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


@pytest.mark.parametrize("shape", C.MESHES)
@pytest.mark.parametrize("case", CASES)
def test_forward_and_loss_match_reference(runs, case, shape):
    ref, port, _ = runs
    got, want = port[(case, shape)], ref[case]
    assert got["forward"].shape == want["forward"].shape
    assert _err(got["forward"], want["forward"]) < _tol(want["forward"])
    assert abs(got["loss"] - want["loss"]) <= 1e-4 * abs(want["loss"])
    for k in ("moe_drops", "moe_peak_occupancy"):
        assert got["mets"][k] == want["mets"][k]
    assert abs(got["mets"]["aux"] - want["mets"]["aux"]) <= 1e-5 * max(abs(want["mets"]["aux"]), 1)


@pytest.mark.parametrize("shape", C.MESHES)
@pytest.mark.parametrize("case", CASES)
def test_prefill_decode_and_serve_match_reference(runs, case, shape):
    ref, port, _ = runs
    got, want = port[(case, shape)], ref[case]
    assert got["serve_logits"].shape == want["serve_logits"].shape
    assert _err(got["serve_logits"], want["serve_logits"]) < _tol(want["serve_logits"])
    assert got["tokens"].shape == (C.B, C.GEN)
    assert np.array_equal(got["tokens"], want["tokens"])


def _want_caches(cfg, shape):
    """The rank's cache shapes on a mesh of ``shape``: the one-rank cache of
    the rank's batch rows, with each split dim divided by the model axis
    where it divides the dim (the attention kv heads; Mamba's inner
    channels; mLSTM's heads and inner channels when it divides both;
    sLSTM's heads); the MLA latent whole."""
    n_data, n_model = shape
    b = C.B // n_data if C.B % n_data == 0 else C.B
    whole = TS.cache_struct(cfg, b, C.S)["blocks"]
    xc = T._xlstm_cfg(cfg)
    out = {}
    for i, (mixer, _) in enumerate(cfg.pattern):
        for k, t in whole[str(i)].items():
            if not isinstance(t, torch.Tensor):
                continue
            dims = list(t.shape)
            if mixer == "attn" and cfg.n_kv_heads % n_model == 0:
                dims[2] //= n_model
            elif mixer == "mamba" and T._mamba_cfg(cfg).d_inner % n_model == 0:
                dims[-1 if k == "conv" else 2] //= n_model
            elif (mixer == "mlstm" and cfg.n_heads % n_model == 0
                  and xc.d_inner % n_model == 0):
                dims[-1 if k == "conv" else 2] //= n_model
            elif mixer == "slstm" and cfg.n_heads % n_model == 0:
                dims[2] //= n_model
            out[f"{i}/{k}"] = tuple(dims)
    return out


@pytest.mark.parametrize("shape", C.MESHES)
@pytest.mark.parametrize("case", CASES)
def test_each_rank_holds_its_block(runs, case, shape):
    """Every leaf's shape is the `param_pspecs` block's (the fused leaves
    with a `Parts` entry), every cache tensor the rank's block; the blocks
    go back bit for bit."""
    _, port, mine = runs
    cfg = _cfg(case)
    mesh = types.SimpleNamespace(axis_names=("data", "model"), shape=shape)
    specs = TS.shardings_for_params(cfg, mesh)
    want = {"/".join(map(str, k)): local_shape(v.shape, sp, mesh)
            for (k, v), sp in zip(flatten(param_shapes(T.abstract_params(cfg))),
                                  spec_leaves(specs))}
    fused = [("/".join(map(str, k)), sp[-1]) for (k, _), sp in
             zip(flatten(param_shapes(T.abstract_params(cfg))), spec_leaves(specs))
             if k[-1] in ("in_proj", "up") and k[-2] in ("mamba", "mlstm")]
    for path, entry in fused:
        assert isinstance(entry, Parts) and entry.n == 2, (path, entry)
    # each rank holds its columns of x beside its columns of z
    assert port[("fused", case, shape)] == {p: True for p, _ in fused}
    for rank_res in mine:
        assert rank_res[("shapes", case, shape)] == want
        assert rank_res[("caches", case, shape)] == _want_caches(cfg, shape)
    assert port[("round-trip", case, shape)] is True


@pytest.mark.parametrize("shape", C.LAYER_MESHES)
@pytest.mark.parametrize("case", LAYERS)
def test_each_mixer_alone_equals_one_rank(runs, case, shape):
    """The output, the gradient of x and every leaf's gathered gradient of
    the mixer on the mesh against one rank: a replicated tensor read by
    per-rank work whose gradient were not summed over the model axis would
    be off by a factor of the axis's size here."""
    _, port, _ = runs
    errs, _ = port[("layer", case, shape)]
    worst = max(errs, key=errs.get)
    assert errs[worst] <= (1e-4 if case == "mla-absorb" else 1e-5), (worst, errs[worst])


def test_mlstm_with_heads_the_axis_does_not_divide_runs_whole(runs):
    """xlstm with 2 heads on (1, 4): the ``ssm_inner`` rule cuts ``up``,
    ``conv``, ``norm`` and ``down`` four ways while ``heads`` leaves ``wq``
    … whole; the mixer gathers the cut leaves (its cache is whole) and
    matches one rank (the layer and model tests above)."""
    _, port, mine = runs
    _, local = port[("layer", "mlstm-2heads", (1, 4))]
    assert local["mlstm/up"] == (64, 2 * 128 // 4)
    assert local["mlstm/down"] == (128 // 4, 64)
    assert local["mlstm/wq"] == (2, 64, 64)
    caches = mine[0][("caches", "xlstm-2heads", (1, 4))]
    assert caches["0/conv"][-1] == 128 and caches["0/C"][2] == 2
