"""The result's line, and what run.py does without a chip or a program."""
import json
import shutil
import subprocess
import sys

import pytest

from perfbench.harness import run_cell

from .conftest import PERFBENCH, ROOT

DEVICE_KEYS = {"platform", "kind", "count", "memory_peak_bytes"}


@pytest.mark.parametrize("trace", [False, True])
def test_result_line(tiny_root, trace, capsys):
    r = run_cell(tiny_root, "tiny-phi-moe.chat", 11, 0.0, trace, device="cpu")
    line = json.loads(json.dumps(r))
    assert list(line)[-1] == "compared"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["attempted"] == 8 and line["failed"] == 0
    assert DEVICE_KEYS <= set(line["device"])
    for name, m in line["metrics"].items():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float), name
    if trace:
        assert line["metrics"] == {}      # BENCHMARK.json lists no per-layer metric for it
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        # the end-to-end metrics that list no cells (a test cell is in no list)
        assert set(line["metrics"]) == {"tokens_per_s", "itl_p95_ms", "setup_s"}
    for k, c in line["compared"].items():
        assert set(c) == {"value", "limit"}
    err = capsys.readouterr().err.strip().splitlines()
    assert err[-len(line["compared"]):] == [
        f"check {k}: {c['value']!r} (limit {c['limit']!r})" for k, c in line["compared"].items()]


def test_a_suffixed_metric_reports_its_quantity(tiny_root, tmp_path):
    """``<quantity>.<suffix>`` reports the quantity in the cells it lists."""
    root = tmp_path / "c"
    shutil.copytree(tiny_root, root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["end_to_end"].append({"name": "ttft_ms.tiny", "unit": "ms", "better": "lower",
                                "bound": 0.25, "source": "host_clock",
                                "workloads": ["tiny-phi-moe.chat"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    r = run_cell(root, "tiny-phi-moe.chat", 11, 0.0, False, device="cpu")
    assert "ttft_ms" not in r["metrics"]
    assert r["metrics"]["ttft_ms.tiny"]["unit"] == "ms"
    assert r["metrics"]["ttft_ms.tiny"]["value"] > 0


def _run(args, cwd, env=None):
    return subprocess.run([sys.executable, "perfbench/run.py", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_no_chip_no_result():
    import os

    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _run(["--workload", "whisper-v3.transcribe", "--seed", "1", "--seconds", "1",
                "--trace", "0"], ROOT, env)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_only_the_benchmark_files_no_result(tmp_path):
    shutil.copytree(PERFBENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = _run(["--workload", "whisper-v3.transcribe", "--seed", "1", "--seconds", "1",
                "--trace", "0"], tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
