"""Shared set-up of the benchmark's CPU tests: the repository's root and
``src`` on the path, and a temporary checkout with the small test cells of
``data/`` added to the benchmark's own files and entries."""
import json
import shutil
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
PERFBENCH = HERE.parent
ROOT = PERFBENCH.parent
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def make_root(tmp: Path) -> Path:
    """A checkout under ``tmp``: BENCHMARK.json and perfbench/ as committed,
    plus the test cells' files and entries (added as data alone)."""
    shutil.copytree(PERFBENCH, tmp / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for kind in ("configs", "traffic", "workloads"):
        for f in sorted((HERE / "data" / kind).glob("*.json")):
            shutil.copy(f, tmp / "perfbench" / kind / f.name)
    for f in sorted((HERE / "data" / "configs").glob("*.json")):
        c = json.loads(f.read_text())
        bench["configs"].append({"name": c["name"], "source": c["source"],
                                 "file": f"perfbench/configs/{f.name}",
                                 "reduced": c["reduced"], "why": "a CPU test configuration"})
    for f in sorted((HERE / "data" / "workloads").glob("*.json")):
        w = json.loads(f.read_text())
        bench["workloads"].append({k: w[k] for k in ("name", "config", "traffic", "chips", "why")})
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return tmp


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("checkout"))


@pytest.fixture
def cuda_device():
    """The card, for the tests marked ``cuda``; skips without one."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
