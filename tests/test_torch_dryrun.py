"""The port's multi-pod dry run (``python -m repro_torch.launch.dryrun``) on
the CPU (``--device cpu``: on a torch built without CUDA a fake CUDA tensor
cannot be indexed), against what the reference's
``repro.launch.dryrun`` records: its record keys, its skip reasons, its mesh
names, its ``params``/``active_params``, its resume over ``--out`` and its
exit codes.  The reference's own dry run lowers on 256 or 512 XLA host
devices, which needs ``XLA_FLAGS`` before jax is imported; the oracle here is
its record layout (its ``Roofline`` fields and ``extrapolate`` keys) and its
configs.  Counts are compared exactly."""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import dryrun as tdry  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.launch import roofline as jrl  # noqa: E402

TOP_KEYS = {"arch", "shape", "mesh", "status", "reason", "lower_s", "compile_s", "params",
            "active_params", "roofline", "roofline_corrected", "memory"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes", "peak_bytes"}


def corrected_keys():
    c = {"flops": 2.0, "bytes": 2.0, "coll_bytes": 2.0}
    return set(jrl.extrapolate(c, c, 2, n_chips=256, model_flops_global=1.0))


def run_cli(argv, capsys):
    capsys.readouterr()
    with pytest.raises(SystemExit) as exc:
        tdry.main(argv)
    return exc.value.code, capsys.readouterr().out


@pytest.fixture(scope="module")
def decode_dir(tmp_path_factory):
    """The llama3.2-1b × decode_32k single-pod record, written once."""
    d = tmp_path_factory.mktemp("dry")
    with pytest.raises(SystemExit) as exc:
        tdry.main(["--arch", "llama3.2-1b", "--shape", "decode_32k", "--single-pod-only",
                   "--device", "cpu", "--out", str(d)])
    assert exc.value.code == 0
    return d


def test_decode_cell_ok_with_the_reference_keys(decode_dir):
    rec = json.loads((decode_dir / "llama3.2-1b__decode_32k__16x16.json").read_text())
    assert rec["status"] == "ok", rec.get("error")
    assert set(rec) == TOP_KEYS
    assert set(rec["roofline"]) == {f.name for f in dataclasses.fields(jrl.Roofline)}
    assert set(rec["roofline_corrected"]) == corrected_keys()
    assert set(rec["memory"]) == MEMORY_KEYS
    jc = jconfigs.get_config("llama3.2-1b")
    assert rec["params"] == jc.param_count()
    assert rec["active_params"] == jc.active_param_count()
    r = rec["roofline"]
    assert r["flops_per_chip"] > 0 and r["collective_ops"] > 0
    assert r["model_flops_global"] == jrl.model_flops(jc, jconfigs.SHAPES["decode_32k"])
    # the corrected fields come from the same full-depth count
    rc = rec["roofline_corrected"]
    assert rc["flops_per_chip"] == r["flops_per_chip"]
    assert rc["collective_bytes_per_chip"] == r["collective_bytes_per_chip"]
    m = rec["memory"]
    assert m["peak_bytes"] == m["argument_bytes"] + m["temp_bytes"]
    # the rank's blocks: its params, its 8 of the 128 rows of the K/V cache
    # (16 layers × 8 kv heads, which do not split over 16 model ranks ×
    # 32768 × 64, bf16, k and v) and its tokens
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import param_blocks
    with tdry.fake_world(256):
        blocks = param_blocks(tdry.get_config("llama3.2-1b"), make_production_mesh(), "meta",
                              serve=True)
    params = sum(t.numel() * t.element_size() for t in tdry.leaves(blocks))
    assert m["argument_bytes"] == params + 16 * 8 * 8 * 32768 * 64 * 2 * 2 + 128 * 4
    assert params < jc.param_count() * 4 // 8
    assert not torch.distributed.is_initialized()


def test_resume_skips_a_recorded_cell(decode_dir, capsys):
    code, out = run_cli(["--arch", "llama3.2-1b", "--shape", "decode_32k", "--single-pod-only",
                         "--device", "cpu", "--out", str(decode_dir)], capsys)
    assert code == 0
    assert "SKIP(cached) llama3.2-1b × decode_32k × 16x16" in out
    assert "failures: 0" in out


def test_long_500k_skips_a_pure_attention_arch(capsys):
    code, out = run_cli(["--arch", "llama3.2-1b", "--shape", "long_500k", "--device", "cpu"],
                        capsys)
    assert code == 0
    _, why = jconfigs.cell_supported(jconfigs.get_config("llama3.2-1b"),
                                     jconfigs.SHAPES["long_500k"])
    for mesh in ("16x16", "2x16x16"):
        assert f"SKIP llama3.2-1b × long_500k × {mesh}: {why}" in out
    rec = tdry.dryrun_cell("llama3.2-1b", "long_500k", multi_pod=False, device="cpu")
    assert rec == {"arch": "llama3.2-1b", "shape": "long_500k", "mesh": "16x16",
                   "status": "skip", "reason": why}


def test_multi_pod_only_gives_the_pod_mesh(tmp_path, capsys):
    code, out = run_cli(["--arch", "xlstm-350m", "--shape", "long_500k", "--multi-pod-only",
                         "--device", "cpu", "--out", str(tmp_path)], capsys)
    assert code == 0
    assert [p.name for p in tmp_path.iterdir()] == ["xlstm-350m__long_500k__2x16x16.json"]
    rec = json.loads((tmp_path / "xlstm-350m__long_500k__2x16x16.json").read_text())
    assert rec["status"] == "ok" and rec["mesh"] == "2x16x16"
    assert rec["roofline_corrected"] == {"error": "n/a (roofline table is single-pod)"}
    assert "OK   xlstm-350m × long_500k × 2x16x16" in out


def test_single_and_multi_pod_of_a_recurrent_cell():
    """xlstm-350m × long_500k on both meshes: the 512-rank world makes its
    pod groups and tears them down; the single-pod record is corrected."""
    one = tdry.dryrun_cell("xlstm-350m", "long_500k", multi_pod=False, device="cpu")
    two = tdry.dryrun_cell("xlstm-350m", "long_500k", multi_pod=True, device="cpu")
    assert one["status"] == two["status"] == "ok"
    assert "error" not in one["roofline_corrected"]
    assert one["params"] == two["params"] == jconfigs.get_config("xlstm-350m").param_count()
    assert not torch.distributed.is_initialized()


def test_moe_cell():
    """A MoE cell (phi3.5-moe at one layer of its full width: the dispatch,
    its capacity and drop counters on fake tensors) ends ok."""
    rec = tdry.dryrun_cell("phi3.5-moe-42b-a6.6b", "train_4k", multi_pod=False,
                           overrides={"n_layers": 1}, device="cpu")
    assert rec["status"] == "ok", rec.get("error")
    assert rec["roofline"]["flops_per_chip"] > 0
    assert "error" not in rec["roofline_corrected"]


def test_a_failing_cell_is_recorded_and_exits_1(tmp_path, capsys):
    """A config that cannot be built (jamba's 8-layer pattern at 3 layers)
    ends FAIL with the error, and the CLI exits 1."""
    code, out = run_cli(["--arch", "jamba-v0.1-52b", "--shape", "long_500k",
                         "--single-pod-only", "--device", "cpu", "--override", "n_layers=3",
                         "--out", str(tmp_path)], capsys)
    assert code == 1
    rec = json.loads((tmp_path / "jamba-v0.1-52b__long_500k__16x16.json").read_text())
    assert rec["status"] == "FAIL" and rec["error"].startswith("ValueError")
    assert "trace" in rec
    assert "FAIL jamba-v0.1-52b × long_500k × 16x16: ValueError" in out
    assert "failures: 1" in out
    assert not torch.distributed.is_initialized()


def test_cuda_device_without_cuda_fails_the_cell():
    """On a torch without CUDA, ``--device cuda`` (the default) ends the
    cell FAIL naming ``--device cpu``; nothing falls back to the CPU."""
    if torch.backends.cuda.is_built():
        pytest.skip("this torch has CUDA")
    rec = tdry.dryrun_cell("xlstm-350m", "long_500k", multi_pod=False)
    assert rec["status"] == "FAIL" and "--device cpu" in rec["error"]


def test_overrides_reach_the_cell():
    """``no_tp`` and cfg fields as in the reference: without tensor
    parallelism the rank holds every param (argument bytes grow)."""
    base = tdry.dryrun_cell("xlstm-350m", "long_500k", multi_pod=False, device="cpu")
    notp = tdry.dryrun_cell("xlstm-350m", "long_500k", multi_pod=False, device="cpu",
                            overrides={"no_tp": True})
    assert notp["status"] == "ok"
    assert notp["memory"]["argument_bytes"] > base["memory"]["argument_bytes"]


# one rank's vocab-gathered logits on the (16, 16) mesh: llama3.2-1b's
# prefill_32k (2 rows a rank x 32768 x 128256, bf16) and train_4k (16 rows a
# rank x 4096 x 128256, the cross-entropy's float32)
GATHERED_LOGITS = {"prefill_32k": 2 * 32768 * 128256 * 2, "train_4k": 16 * 4096 * 128256 * 4}


@pytest.mark.parametrize("shape", sorted(GATHERED_LOGITS))
def test_mesh_logits_stay_sharded(shape):
    """llama3.2-1b at 2 of its 16 layers on the production mesh: the
    temporaries a rank holds (and a prefill's output, the last position
    alone) stay under one rank's vocab-gathered logits, as the reference's
    vocab-sharded logits do (``loss`` takes a vocab-parallel cross-entropy,
    ``prefill`` cuts the last position before its gathers)."""
    rec = tdry.dryrun_cell("llama3.2-1b", shape, multi_pod=False, overrides={"n_layers": 2},
                           device="cpu")
    assert rec["status"] == "ok", rec.get("error")
    m = rec["memory"]
    assert m["temp_bytes"] < GATHERED_LOGITS[shape], m
    if shape == "prefill_32k":
        assert m["output_bytes"] < GATHERED_LOGITS[shape], m
