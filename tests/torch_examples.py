"""Shared by ``tests/test_torch_examples*.py`` (not collected): run the
reference's examples and the port's ``examples/*_torch.py`` and mask what may
differ between their stdouts.

Masking rule.  Both stdouts are split into lines and each line goes through
`mask`:

* lines that the train and serve drivers print (``arch=``, ``step N``,
  ``restored from``, ``done:``, ``served``) and the examples' loss summaries
  (``loss: a -> b``, ``loss a -> b``) are dropped: the reference cannot train
  on this host and the port's losses are held to their own properties;
* timing fields are replaced by ``<t>``: Table IV's ``software(us)``,
  ``xla_lut(us)`` / ``kernel(us)`` and ``speedup`` columns (the column names
  too: the reference times a jitted plain path, the port the kernel), and
  Table V's ``sim_ms``;
* the particle filter's tracking errors and estimates (``mean err``, ``max``,
  ``est=(...)``) are replaced by ``<e>``: the port draws its motion noise
  from a ``torch.Generator``, the reference from ``jax.random``.

Everything else must be equal, line for line."""
import ast
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")
NAMES = ("quickstart", "gf2_bmvm_topologies", "ldpc_decode", "particle_tracking", "train_lm")

DRIVER_LINE = re.compile(r"^(arch=|step +\d+ |restored from step|done: |served \d|loss:? \d)")
MASKS = [
    (re.compile(r"software\(us\)\s+(xla_lut|kernel)\(us\)\s+speedup"), "<t>"),
    (re.compile(r"^(\s*\d+)(\s+\d+\.\d+){3}$"), r"\1 <t>"),
    (re.compile(r"^(\s*(?:ring|mesh|torus|fattree)\s+\d+\s+\d+)\s+\d+\.\d+(\s+\d+\.\d+)$"),
     r"\1 <t>\2"),
    (re.compile(r"mean err \d+\.\d+px(  max \d+\.\d+px)?"), "<e>"),
    (re.compile(r"est=\(\s*-?\d+\.\d,\s*-?\d+\.\d\)"), "<e>"),
]

# run a port example on the CPU, then fail if it pulled in jax or the JAX package
PORT_RUNNER = """
import runpy, sys
path = sys.argv[1]
sys.argv = [path, "--device", "cpu"]
runpy.run_path(path, run_name="__main__")
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
if bad:
    sys.exit(f"the example imported {bad}")
"""


def env():
    """The examples' environment: the CPU, one thread each (the suite runs
    beside other workers, some with subprocesses under a time limit)."""
    e = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    e["XLA_FLAGS"] = (e.get("XLA_FLAGS", "") + " --xla_cpu_multi_thread_eigen=false "
                      "intra_op_parallelism_threads=1").strip()
    e["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep + e.get("PYTHONPATH", "")
    return e


def run_reference(name):
    return subprocess.run([sys.executable, os.path.join(EXAMPLES, f"{name}.py")],
                          capture_output=True, text=True, env=env(), cwd=ROOT, timeout=600)


def run_port(name):
    return subprocess.run([sys.executable, "-c", PORT_RUNNER,
                           os.path.join(EXAMPLES, f"{name}_torch.py")],
                          capture_output=True, text=True, env=env(), cwd=ROOT, timeout=600)


def mask(stdout):
    out = []
    for line in stdout.splitlines():
        if DRIVER_LINE.match(line.strip()):
            continue
        for pat, rep in MASKS:
            line = pat.sub(rep, line)
        out.append(line)
    return out


def steps(stdout):
    """The driver's logged (step, loss) pairs, one list per train run."""
    runs = []
    for line in stdout.splitlines():
        if line.startswith("arch="):
            runs.append([])
        found = re.match(r"step +(\d+) +loss ([\d.]+) ", line)
        if found:
            runs[-1].append((int(found.group(1)), float(found.group(2))))
    return runs


def done_steps(stdout):
    return [int(n) for n in re.findall(r"^done: (\d+) steps", stdout, re.M)]


def _ast(path):
    with open(path) as fh:
        return ast.parse(fh.read())


def docstring(path):
    return ast.get_docstring(_ast(path))


def port_imports(name):
    """Top-level package of every module the port example imports."""
    tree = _ast(os.path.join(EXAMPLES, f"{name}_torch.py"))
    mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    mods += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    return {m.split(".")[0] for m in mods}
