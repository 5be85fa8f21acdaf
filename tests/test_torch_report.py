"""``python -m repro_torch.launch.report`` against ``repro.launch.report``, on
the CPU: for BMVM, LDPC and the particle filter under ``sim`` and
``buffered`` (the traced runs of ``python -m repro{,_torch}.telemetry``, made
in process), the port's report on the port's trace is byte-equal to the
reference's report on the reference's trace — the heatmap, its CSV form and
the profiler's bottleneck report — and the port's report reads a trace that
the reference wrote.  The reference's ``main()`` reads ``sys.argv``, so the
tests set it; both reports run in process with stdout captured.  The
directory mode (the roofline table over the JAX dry run) is not ported: it
exits 2 with a message naming ROADMAP item 8(e)."""
import sys

import pytest

pytest.importorskip("torch")

import repro.telemetry as jtel  # noqa: E402
import repro_torch.telemetry as ttel  # noqa: E402
from repro.launch import report as jreport  # noqa: E402
from repro.telemetry import __main__ as jcli  # noqa: E402
from repro_torch.launch import report as treport  # noqa: E402
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


def test_directory_mode_exits_naming_item_8e(tmp_path, capsys):
    with pytest.raises(SystemExit) as exc:
        treport.main([str(tmp_path)])
    assert exc.value.code == 2
    assert "8(e)" in capsys.readouterr().err


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
