"""The benchmark's specification: `BENCHMARK.json` and the files it names.

Everything that belongs to one configuration, one traffic mix, one cell or one
per-layer metric is a file of its own, found by its name:

    <paths[0]>/configs/<file named by the config entry>   sizes, arch, reference
    <paths[0]>/traffic/<traffic>.json                      the mix's parameters
    <paths[0]>/workloads/<cell>.json                       the cell's check and limits
    <paths[0]>/metrics/<metric>.py                         a per-layer reader

so a later change adds a cell, a configuration or a per-layer metric by adding
files and entries, with no edit to the harness.  `Spec.validate` checks that
every entry finds its files and that the names keep to the contract's
characters.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
SOURCES_E2E = ("host_clock", "device_trace")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
# the quantities the harness itself measures; an end-to-end metric is one of
# them, or one of them with a suffix after a dot (harness.run_cell)
END_TO_END = ("tokens_per_s", "ttft_ms", "itl_p95_ms", "setup_s")


class SpecError(ValueError):
    pass


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    config: str
    traffic: str
    chips: int
    why: str


class Spec:
    """`BENCHMARK.json` under ``root`` (the checkout's root) and its files."""

    def __init__(self, root):
        self.root = Path(root)
        path = self.root / "BENCHMARK.json"
        if not path.is_file():
            raise SpecError(f"no BENCHMARK.json in {self.root}")
        self.bench = json.loads(path.read_text())
        self.home = self.root / self.bench["paths"][0]

    # -- entries ---------------------------------------------------------------

    def cells(self) -> list[str]:
        return [w["name"] for w in self.bench["workloads"]]

    def cell(self, name: str) -> Cell:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return Cell(w["name"], w["config"], w["traffic"], int(w["chips"]), w["why"])
        raise SpecError(f"no workload {name!r} in BENCHMARK.json; it has {self.cells()}")

    def _config_entry(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                return c
        raise SpecError(f"no configuration {name!r} in BENCHMARK.json")

    def metrics(self, kind: str, cell: str) -> list[dict]:
        """The ``kind`` ("end_to_end" or "per_layer") metrics a cell reports:
        those whose ``workloads`` list it, or that have no such list."""
        return [m for m in self.bench[kind] if cell in m.get("workloads", [cell])]

    # -- files -----------------------------------------------------------------

    def config(self, name: str) -> dict:
        return json.loads((self.root / self._config_entry(name)["file"]).read_text())

    def traffic(self, name: str) -> dict:
        return json.loads((self.home / "traffic" / f"{name}.json").read_text())

    def workload(self, name: str) -> dict:
        return json.loads((self.home / "workloads" / f"{name}.json").read_text())

    def reader(self, metric: str):
        """The ``read`` function of ``metrics/<metric>.py``."""
        path = self.home / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(f"perfbench_metric_{metric}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read

    # -- checks ----------------------------------------------------------------

    def validate(self) -> None:
        """Raise `SpecError` naming every entry whose files or names are wrong."""
        bad = []
        b = self.bench
        names = {}
        for kind in ("configs", "workloads", "end_to_end", "per_layer"):
            for e in b[kind]:
                if not NAME.fullmatch(e["name"]):
                    bad.append(f"{kind} name {e['name']!r}")
                if e["name"] in names:
                    bad.append(f"{e['name']!r} named twice")
                names[e["name"]] = kind
        for c in b["configs"]:
            f = self.root / c["file"]
            if not f.is_file():
                bad.append(f"config {c['name']}: no file {c['file']}")
                continue
            cfg = json.loads(f.read_text())
            if set(cfg.get("reduced", [])) != set(c["reduced"]):
                bad.append(f"config {c['name']}: reduced differs from its file's")
            ref = self.home / "reference" / f"{cfg.get('reference')}.py"
            if not ref.is_file():
                bad.append(f"config {c['name']}: no reference module {ref.name}")
        pairs = set()
        for w in b["workloads"]:
            if w["config"] not in {c["name"] for c in b["configs"]}:
                bad.append(f"workload {w['name']}: unknown config {w['config']!r}")
            if (w["config"], w["traffic"]) in pairs:
                bad.append(f"workload {w['name']}: (config, traffic) pair twice")
            pairs.add((w["config"], w["traffic"]))
            if w["chips"] not in (1, 4):
                bad.append(f"workload {w['name']}: chips {w['chips']}")
            for kind, path in (("traffic", self.home / "traffic" / f"{w['traffic']}.json"),
                               ("workload", self.home / "workloads" / f"{w['name']}.json")):
                if not path.is_file():
                    bad.append(f"workload {w['name']}: no {kind} file {path.name}")
                    continue
                try:
                    json.loads(path.read_text())
                except json.JSONDecodeError as e:
                    bad.append(f"workload {w['name']}: {path.name}: {e}")
            if (self.home / "workloads" / f"{w['name']}.json").is_file():
                wl = self.workload(w["name"])
                if not wl.get("limits"):
                    bad.append(f"workload {w['name']}: no correctness limits")
        for m in b["end_to_end"]:
            if m["name"].split(".")[0] not in END_TO_END:
                bad.append(f"end-to-end metric {m['name']!r} is not one the harness measures")
            if m["source"] not in SOURCES_E2E:
                bad.append(f"end-to-end metric {m['name']}: source {m['source']}")
        for m in b["per_layer"]:
            if not (self.home / "metrics" / f"{m['name']}.py").is_file():
                bad.append(f"per-layer metric {m['name']}: no reader metrics/{m['name']}.py")
            if m["source"] not in SOURCES:
                bad.append(f"per-layer metric {m['name']}: source {m['source']}")
            if m["moves"] not in {e["name"] for e in b["end_to_end"]}:
                bad.append(f"per-layer metric {m['name']}: moves unknown {m['moves']!r}")
            for w in m.get("workloads", self.cells()):
                if w not in self.cells():
                    bad.append(f"per-layer metric {m['name']}: unknown workload {w!r}")
                elif m["moves"] not in {e["name"] for e in self.metrics("end_to_end", w)}:
                    bad.append(f"per-layer metric {m['name']}: {w} does not report "
                               f"{m['moves']}")
        for m in b["end_to_end"] + b["per_layer"]:
            if not UNIT.fullmatch(m["unit"]) or m["better"] not in ("lower", "higher"):
                bad.append(f"metric {m['name']}: unit or better")
        if bad:
            raise SpecError("; ".join(bad))
