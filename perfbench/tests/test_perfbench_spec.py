"""BENCHMARK.json keeps to the contract, and a cell is added as data alone."""
import json
import re

import pytest

from perfbench.spec import Spec, SpecError

from .conftest import ROOT

KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"}}
ONE_LINE = re.compile(r"[^\n\t]{1,200}")


def test_committed_benchmark_validates():
    spec = Spec(ROOT)
    spec.validate()
    b = spec.bench
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["command"] == ["python3", "perfbench/run.py"] and b["paths"] == ["perfbench"]
    assert 1 <= b["run_seconds"] <= 51
    for kind, keys in KEYS.items():
        for e in b[kind]:
            assert set(e) <= keys, (kind, e["name"])
    for e in b["configs"] + b["workloads"]:
        assert ONE_LINE.fullmatch(e["why"])
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert {m["name"] for m in b["end_to_end"]} >= {"setup_s"}
    for w in spec.cells():
        assert spec.metrics("end_to_end", w) and spec.metrics("per_layer", w)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) < 64 * 1024


def test_a_cell_is_added_as_files_and_entries(tiny_root):
    """The test checkout holds the committed files plus the test cells' data
    files and entries: the harness lists and validates them, no code edited."""
    spec = Spec(tiny_root)
    spec.validate()
    assert {"tiny-whisper.audio", "tiny-phi-moe.chat"} <= set(spec.cells())
    assert spec.cell("tiny-phi-moe.chat").config == "tiny-phi-moe"
    assert spec.traffic("tiny-chat")["prompt_len"] == 12
    assert spec.workload("tiny-whisper.audio")["limits"]


def test_missing_files_are_named(tiny_root, tmp_path):
    import shutil

    root = tmp_path / "c"
    shutil.copytree(tiny_root, root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "x.y", "config": "tiny-phi-moe", "traffic": "nowhere",
                               "chips": 1, "why": "a cell with no files"})
    bench["per_layer"].append({"name": "no_reader", "unit": "ms", "better": "lower",
                               "source": "device_trace", "layer": "device",
                               "moves": "tokens_per_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    with pytest.raises(SpecError) as e:
        Spec(root).validate()
    assert "no traffic file nowhere.json" in str(e.value)
    assert "no workload file x.y.json" in str(e.value)
    assert "no reader metrics/no_reader.py" in str(e.value)


def test_a_layer_metric_moves_what_its_cells_report(tiny_root, tmp_path):
    import shutil

    root = tmp_path / "c"
    shutil.copytree(tiny_root, root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "mfu", "unit": "%", "better": "higher",
                               "source": "host_clock", "layer": "model", "moves": "ttft_ms",
                               "workloads": ["tiny-phi-moe.chat"]})
    bench["per_layer"] = [m for m in bench["per_layer"][:-1] if m["name"] != "mfu"] + [
        bench["per_layer"][-1]]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    with pytest.raises(SpecError) as e:
        Spec(root).validate()
    assert "mfu: tiny-phi-moe.chat does not report ttft_ms" in str(e.value)
