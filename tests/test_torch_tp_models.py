"""Tensor and data parallelism of the LM's forward paths on ``("data",
"model")`` meshes of gloo ranks, against the JAX package's unsharded
results, on the CPU.

One gloo world of 4 single-threaded ranks (`tests/torch_spmd_worlds.py`)
runs the cases of `tests/torch_tp_cases.py` on (1, 2), (1, 4) and (2, 2)
meshes while this process computes the reference's results on the same
params (the reference's init) and inputs: llama3.2-1b, gemma-7b,
whisper-large-v3, internvl2-1b, phi3.5-moe and qwen3-moe at SMOKE, and
llama3.2-1b with a vocab of 255, which no model axis divides, and with a
vocab of 250 padded to 256 (``pad_vocab``).

* ``forward``, ``prefill`` and teacher-forced ``decode_step`` logits within
  2e-3 × max(|logits|, 1) of the reference's (each arch's one-rank test
  tolerance, `tests/torch_lm_oracle.py`), ``loss`` within rtol 1e-4 with the
  MoE counters equal, and ``serve_batch(mesh=)`` tokens equal;
* each rank holds exactly its `param_pspecs` block of every leaf, and its
  cache its batch rows and kv heads;
* ``shard_params`` then ``gather_params`` gives the tree back bit for bit;
* the logits stay sharded where the reference's do: ``loss`` gathers no
  vocab block, ``prefill`` gathers only the last position's (rows, 1, V/m)
  blocks, its logits equal the gathered forward's last position bit for
  bit and own a storage of B·V elements;
* the vocab-parallel cross-entropy (labels in every rank's block, ignored
  labels, the padded vocab) of each rank's block and the block's gradient
  within 1e-6 of `cross_entropy` over the gathered logits, and the mesh
  ``loss`` and nll within rtol 1e-4 of the reference's.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_config  # noqa: E402
from repro_torch._tree import flatten  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.partition import local_shape, spec_leaves  # noqa: E402
from repro_torch.launch.steps import shardings_for_params  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.layers import param_shapes  # noqa: E402
from tests import torch_spmd_worlds as W  # noqa: E402
from tests import torch_tp_cases as C  # noqa: E402

CASES = [c for c, _, _ in C.MODEL_CASES]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's results by case, the ranks' common results, each
    rank's own)."""
    tmp = tmp_path_factory.mktemp("tp_models")
    in_path = str(tmp / "inputs.pkl")
    data = C.write_model_inputs(in_path)
    world = W.World("tp_models", 4, tmp / "world", args=(in_path,), timeout=240.0)
    try:
        ref = {case: C.ref_model(data[case][0], jax_config(arch, smoke=True).replace(**kw),
                                 data[case][1])
               for case, arch, kw in C.MODEL_CASES}
        for case in C.NLL_CASES:
            _, arch, kw = C._model_case(case)
            ref[("nll", case)] = C.ref_nll_loss(
                data[case][0], jax_config(arch, smoke=True).replace(**kw), data[case][1])
        res = world.results()
    finally:
        world.close()
    for r, other in enumerate(res[1:], 1):
        assert W.same(res[0]["same"], other["same"]), f"rank {r} differs from rank 0"
    return ref, res[0]["same"], [r["rank"] for r in res]


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


@pytest.mark.parametrize("shape", C.MESHES)
@pytest.mark.parametrize("case", CASES)
def test_each_rank_holds_its_block(runs, case, shape):
    """Every leaf's shape is the `param_pspecs` block's, and the cache holds
    the rank's batch rows and kv heads; the blocks go back bit for bit."""
    _, port, mine = runs
    _, arch, kw = next(c for c in C.MODEL_CASES if c[0] == case)
    cfg = get_config(arch, smoke=True).replace(**kw)
    mesh = types.SimpleNamespace(axis_names=("data", "model"), shape=shape)
    specs = shardings_for_params(cfg, mesh)
    want = {"/".join(map(str, k)): local_shape(v.shape, sp, mesh)
            for (k, v), sp in zip(flatten(param_shapes(T.abstract_params(cfg))),
                                  spec_leaves(specs))}
    for rank_res in mine:
        assert rank_res[("shapes", case, shape)] == want
        n_data, n_model = shape
        kv = cfg.n_kv_heads // n_model if cfg.n_kv_heads % n_model == 0 else cfg.n_kv_heads
        b = C.B // n_data if C.B % n_data == 0 else C.B
        assert rank_res[("cache", case, shape)][1:3] == (b, kv)
    assert port[("round-trip", case, shape)] is True


@pytest.mark.parametrize("shape", C.MESHES)
def test_whole_params_under_a_mesh_raise(runs, shape):
    """A whole param tree under a mesh would add the ranks' copies: the
    forward raises and names ``shard_params``."""
    _, port, _ = runs
    msg = port[("whole-tree", shape)]
    assert msg is not None and "shard_params" in msg


@pytest.mark.parametrize("shape", C.MESHES)
@pytest.mark.parametrize("case", CASES)
def test_loss_and_prefill_keep_the_logits_sharded(runs, case, shape):
    """``loss`` gathers no vocab block; ``prefill`` gathers the last
    position's blocks alone, equals the gathered forward's last position bit
    for bit, and returns logits that own a storage of B·V elements."""
    _, port, _ = runs
    got = port[("sharded", case, shape)]
    _, arch, kw = C._model_case(case)
    V = get_config(arch, smoke=True).replace(**kw).vocab_padded
    n_data, n_model = shape
    rows = C.B // n_data if C.B % n_data == 0 else C.B
    assert got["prefill_equal"] is True
    assert got["shape"] == (C.B, 1, V) and got["storage"] == C.B * V
    assert got["loss_gathers"] == []
    assert got["prefill_gathers"] == ([(rows, 1, V // n_model)] if V % n_model == 0 else [])


@pytest.mark.parametrize("shape", C.MESHES)
@pytest.mark.parametrize("case", C.NLL_CASES)
def test_vocab_parallel_cross_entropy(runs, case, shape):
    """On each rank's rows, the nll of its vocab block and the block's
    gradient against `cross_entropy` over the gathered logits; the mesh
    ``loss`` against the reference's, with labels in every block and
    ignored labels."""
    ref, port, mine = runs
    got = port[("nll", case, shape)]
    assert got["split"] == shape[1]
    want_loss, want_nll = ref[("nll", case)]
    assert abs(got["loss"] - want_loss) <= 1e-4 * abs(want_loss)
    assert abs(got["nll"] - want_nll) <= 1e-4 * abs(want_nll)
    for rank_res in mine:
        r = rank_res[("nll", case, shape)]
        assert abs(r["vp"] - r["ce"]) <= 1e-6 * abs(r["ce"]), r
        assert r["grad"] <= 1e-6, r
