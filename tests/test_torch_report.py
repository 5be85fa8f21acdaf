"""``python -m repro_torch.launch.report`` against ``repro.launch.report``, on
the CPU: for BMVM, LDPC and the particle filter under ``sim`` and
``buffered`` (the traced runs of ``python -m repro{,_torch}.telemetry``, made
in process), the port's report on the port's trace is byte-equal to the
reference's report on the reference's trace — the heatmap, its CSV form and
the profiler's bottleneck report — and the port's report reads a trace that
the reference wrote.  The reference's ``main()`` reads ``sys.argv``, so the
tests set it; both reports run in process with stdout captured.  The
directory mode (the roofline table) reads a directory of the port's dry-run
records (``repro_torch.launch.dryrun`` on the CPU, with a ``skip`` and a
``FAIL`` record): under the reference's constants the port's table is
byte-equal to the reference's, in CSV and Markdown, and both rewrite the
records to the same JSON."""
import json
import shutil
import sys

import pytest

pytest.importorskip("torch")

import repro.telemetry as jtel  # noqa: E402
import repro_torch.telemetry as ttel  # noqa: E402
from repro.launch import report as jreport  # noqa: E402
from repro.launch import roofline as jrl  # noqa: E402
from repro.telemetry import __main__ as jcli  # noqa: E402
from repro_torch.launch import dryrun as tdry  # noqa: E402
from repro_torch.launch import report as treport  # noqa: E402
from repro_torch.launch import roofline as trl  # noqa: E402
from repro_torch.telemetry import __main__ as tcli  # noqa: E402

APPS = ("bmvm", "ldpc", "pf")
MODES = ("sim", "buffered")
REPORTS = {"heatmap": ["--trace"], "csv": ["--trace", "{}", "--csv"],
           "profile": ["--profile"]}
_TRACES = {}


def traces(app, mode, tmp_path_factory):
    """(port trace path, reference trace path) of one traced run, written once."""
    if (app, mode) not in _TRACES:
        d = tmp_path_factory.mktemp(f"{app}_{mode}")
        tt, jt = ttel.Tracer(), jtel.Tracer()
        tcli._run_app(app, "mesh", mode, 3, False, tt, "cpu")
        jcli._run_app(app, "mesh", mode, 3, False, jt)
        pt, pj = str(d / "port.json"), str(d / "reference.json")
        ttel.write_chrome_trace(pt, tt)
        jtel.write_chrome_trace(pj, jt)
        _TRACES[app, mode] = pt, pj
    return _TRACES[app, mode]


def argv_for(kind, path):
    args = REPORTS[kind]
    return [a.format(path) for a in args] if "{}" in args else args + [path]


def port_report(argv, capsys):
    capsys.readouterr()
    treport.main(argv)
    return capsys.readouterr().out


def reference_report(argv, capsys, monkeypatch):
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", ["repro.launch.report"] + argv)
    jreport.main()
    return capsys.readouterr().out


@pytest.mark.parametrize("kind", sorted(REPORTS))
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("app", APPS)
def test_report_equals_reference_byte_for_byte(app, mode, kind, tmp_path_factory, capsys,
                                               monkeypatch):
    pt, pj = traces(app, mode, tmp_path_factory)
    got = port_report(argv_for(kind, pt), capsys)
    want = reference_report(argv_for(kind, pj), capsys, monkeypatch)
    assert got == want
    assert got.strip()


@pytest.mark.parametrize("kind", sorted(REPORTS))
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("app", APPS)
def test_report_reads_the_reference_trace(app, mode, kind, tmp_path_factory, capsys,
                                          monkeypatch):
    pt, pj = traces(app, mode, tmp_path_factory)
    got = port_report(argv_for(kind, pj), capsys)
    assert got == reference_report(argv_for(kind, pj), capsys, monkeypatch)


@pytest.fixture(scope="module")
def dryrun_dir(tmp_path_factory):
    """Records the port's dry run wrote: xlstm-350m × long_500k on both
    meshes (ok; the multi-pod one uncorrected), llama3.2-1b × long_500k
    (skip) and jamba at 3 layers (FAIL)."""
    d = tmp_path_factory.mktemp("dryrun")
    for argv in (["--arch", "xlstm-350m", "--shape", "long_500k"],
                 ["--arch", "llama3.2-1b", "--shape", "long_500k", "--single-pod-only"],
                 ["--arch", "jamba-v0.1-52b", "--shape", "long_500k", "--single-pod-only",
                  "--override", "n_layers=3"]):
        with pytest.raises(SystemExit):
            tdry.main(argv + ["--device", "cpu", "--out", str(d)])
    status = sorted(json.loads(p.read_text())["status"] for p in d.iterdir())
    assert status == ["FAIL", "ok", "ok", "skip"]
    return d


def _copy(src, dst):
    shutil.copytree(src, dst)
    return str(dst)


@pytest.mark.parametrize("md", [False, True], ids=["csv", "md"])
def test_directory_table_equals_the_reference(md, dryrun_dir, tmp_path, capsys, monkeypatch):
    for name, ref in (("PEAK_FLOPS", jrl.PEAK_FLOPS), ("HBM_BW", jrl.HBM_BW),
                      ("LINK_BW", jrl.LINK_BW), ("LINKS", jrl.ICI_LINKS)):
        monkeypatch.setattr(trl, name, ref)
    port_dir, ref_dir = _copy(dryrun_dir, tmp_path / "p"), _copy(dryrun_dir, tmp_path / "r")
    flag = ["--md"] if md else []
    got = port_report([port_dir] + flag, capsys)
    want = reference_report([ref_dir] + flag, capsys, monkeypatch)
    assert got == want
    assert len(got.splitlines()) == 4 + (2 if md else 1)
    row = "| xlstm-350m | long_500k | 16x16 | ok |" if md else "xlstm-350m,long_500k,16x16,ok,"
    assert row in got
    # both rewrote every record in place to the same JSON
    for p in (tmp_path / "p").iterdir():
        assert p.read_text() == (tmp_path / "r" / p.name).read_text()
    rc = json.loads((tmp_path / "p" / "xlstm-350m__long_500k__16x16.json").read_text())
    assert {"ideal_compute_s", "ideal_memory_s", "model_bytes_global",
            "roofline_fraction"} <= set(rc["roofline_corrected"])


def test_directory_table_under_the_h100_constants(dryrun_dir, tmp_path, capsys):
    """With its own constants the port's ideal terms are the H100's."""
    port_dir = _copy(dryrun_dir, tmp_path / "p")
    out = port_report([port_dir], capsys)
    assert out.splitlines()[0] == ("arch,shape,mesh,status,dom,compute_s,memory_s,"
                                   "collective_s,ideal_c,ideal_m,roofline_frac")
    rc = json.loads((tmp_path / "p" / "xlstm-350m__long_500k__16x16.json").read_text())
    rc = rc["roofline_corrected"]
    assert rc["ideal_compute_s"] == rc["model_flops_global"] / 256 / 989e12
    assert rc["ideal_memory_s"] == rc["model_bytes_global"] / 256 / 3.35e12


def test_no_mode_given_exits_2(capsys):
    with pytest.raises(SystemExit) as exc:
        treport.main([])
    assert exc.value.code == 2
    assert "--trace" in capsys.readouterr().err


def test_report_module_imports_no_jax():
    import ast
    import inspect
    tree = ast.parse(inspect.getsource(treport))
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    assert not [m for m in names if m.split(".")[0] in ("jax", "repro")]
