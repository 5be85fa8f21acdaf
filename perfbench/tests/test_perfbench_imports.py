"""Nothing under perfbench/ imports JAX or the JAX package (top-level names
compared whole: ``repro_torch`` passes, ``repro`` fails), and the reference
imports nothing of the program."""
import ast
import subprocess
import sys

from perfbench.harness import FORBIDDEN, forbidden_modules

from .conftest import PERFBENCH, ROOT


def imported_tops(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    files = list(PERFBENCH.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        assert not set(imported_tops(f)) & set(FORBIDDEN), f


def test_the_reference_imports_nothing_of_the_program():
    for f in (PERFBENCH / "reference").glob("*.py"):
        assert "repro_torch" not in set(imported_tops(f)), f


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    monkeypatch.setitem(sys.modules, "reprox.y", sys)
    assert "repro" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.kernels", sys)
    assert "repro" in forbidden_modules()


def test_a_run_loads_neither():
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "import perfbench.harness, perfbench.check, perfbench.calibrate\n"
            "import perfbench.reference.encdec, perfbench.reference.decoder\n"
            "import repro_torch.launch.serve, repro_torch.models.transformer\n"
            "from perfbench.harness import forbidden_modules\n"
            "print(forbidden_modules())" % (str(ROOT), str(ROOT / "src")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
