"""The cross-pod gradient exchange (``core.partition.cross_pod_mean``,
``launch.steps.make_train_step(pod_sync="serdes")``, ``train --pod-sync``)
against the JAX package, on the CPU.

One gloo world of 4 single-threaded ranks (`tests/torch_spmd_worlds.py`)
runs the port's cases (`tests/torch_pod_cases.py`) while three processes with
4 fake CPU devices each compute a part of the reference's results, every
call under ``jax.jit``; both sides read the same seeded inputs.

* ``cross_pod_mean`` over ("pod",) meshes of 2 and 4 ranks, ``cfg`` None
  (a pmean), ``none``, ``bf16`` and ``int8``, serialized or whole, two calls
  with the residuals carried: every rank's results and residuals bit for bit
  the reference's under ``shard_map`` for a config, within rtol 1e-6 for the
  pmean.  The reference's exchange is compiled with :data:`EXACT_FLAGS`:
  otherwise XLA divides by 127 through a reciprocal and contracts ``acc + q
  * scale`` into one rounding, where the operations as written (and the
  reference run op by op) round as the port does.
* llama3.2-1b SMOKE at batch 8 x seq 16, 2 steps with ``warmup=1`` (so the
  second step moves the params), on (2, 2, 1) and (2, 1, 2) ``("pod",
  "data", "model")`` meshes under ``auto`` and ``serdes`` with ``none``,
  ``bf16`` and ``int8``, against the reference's ``make_train_step`` on the
  same mesh shape: loss within rtol 1e-5, grad norm within rtol 1e-4, the
  gathered params within the reference test's 1e-5 (``auto``, ``none``) and
  5e-3 (``bf16``, ``int8``), AdamW's ``m`` and ``v`` within
  :data:`REF_TOL` of each leaf's largest, on rank 0 (pod 0, whose arrays the
  reference reads back); each ``serdes`` variant's grad norm within
  :data:`GNORM_TOL` of the port's own ``auto`` and its ``m`` and ``v``
  within :data:`AUTO_TOL`; the ranks of a pod equal, and the pods' states
  within those tolerances (a ring adds the pods' gradients in another order
  on each pod, and a lossy link rounds another pod's on each).
* `core.partition.block_run` against the runs each rank's block holds, and
  the leaves int8 sends whole (those whose blocks split its blocks of 256)
  for llama3.2-1b on (2, 1, 2): none at full width, 8 of 11 at SMOKE.
* qwen3-moe SMOKE on (2, 1, 2): ``serdes`` ``none`` against ``auto``, the MoE
  counters equal; a ``pod`` axis of 1 gives ``auto``'s bits; a mesh made
  without axis groups, and a batch the ``(pod, data)`` rows do not divide,
  raise ``ValueError``.
* The train CLI: ``--pod-sync serdes`` prints ``--pod-sync auto``'s losses
  (the host mesh has no ``pod`` axis); ``--pod-sync ring`` exits 2.
"""
import os
import pickle
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch._tree import leaves  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.partition import Parts, block, block_run, spec_leaves  # noqa: E402
from repro_torch.core.serdes import QuasiSerdesConfig  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch.steps import shardings_for_params  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.layers import param_shapes  # noqa: E402
from tests import torch_pod_cases as C  # noqa: E402
from tests import torch_spmd_worlds as W  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the params' tolerance by variant: the reference's (tests/test_distributed.py:113)
STATE_TOL = {"auto": 1e-5, "none": 1e-5, "bf16": 5e-3, "int8": 5e-3}
# AdamW's m and v, max |diff| over each leaf's max |.|: against the
# reference (float32 sums in another order; a bf16 or int8 word that rounds
# the other way, one bf16 ulp or one int8 step of the block's max), and
# against the port's auto or between the pods (a lossy link rounds the
# other pod's gradient, which may exceed the mean's largest; v squares it)
REF_TOL = {"auto": 1e-4, "none": 1e-4, "bf16": 5e-3, "int8": 1e-2}
AUTO_TOL = {"auto": 1e-5, "none": 1e-5, "bf16": 1e-2, "int8": 2e-2}
# the grad norm against the port's auto, relative
GNORM_TOL = {"auto": 1e-4, "none": 1e-4, "bf16": 1e-3, "int8": 1e-3}
# XLA's CPU compiler rewrites ``x / 127.0`` as ``x * (1 / 127.0)`` (its
# algebraic simplifier) and contracts ``acc + q * scale`` into a fused
# multiply-add; without both the jitted exchange rounds as its operations do
EXACT_FLAGS = " --xla_cpu_max_isa=AVX --xla_disable_hlo_passes=algsimp"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference results, the port's common results, each rank's own)."""
    tmp = tmp_path_factory.mktemp("pod_sync")
    inputs = str(tmp / "inputs.pkl")
    C.write_inputs(inputs)
    world = W.World("pod_sync", 4, tmp / "world", args=(inputs,), timeout=240.0)
    flags = "--xla_force_host_platform_device_count=4 --xla_cpu_multi_thread_eigen=false"
    procs = []
    try:
        for i, part in enumerate(C.REFERENCE_PARTS):
            out = str(tmp / f"reference{i}.pkl")
            code = ("from tests.torch_pod_cases import run_reference; "
                    f"run_reference({inputs!r}, {out!r}, {part!r})")
            env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
                       XLA_FLAGS=flags + (EXACT_FLAGS if part == "exchange" else ""),
                       PYTHONPATH=os.pathsep.join([ROOT, os.path.join(ROOT, "src")]))
            procs.append((subprocess.Popen([sys.executable, "-c", code], env=env, text=True,
                                           stdout=subprocess.PIPE, stderr=subprocess.PIPE),
                          out))
        ref = {}
        for proc, out in procs:
            stdout, stderr = proc.communicate(timeout=240)
            assert proc.returncode == 0, f"the reference failed:\n{stdout}\n{stderr}"
            with open(out, "rb") as fh:
                ref.update(pickle.load(fh))
        res = world.results()
    finally:
        world.close()
        for proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
    for r, other in enumerate(res[1:], 1):
        assert W.same(res[0]["same"], other["same"]), f"rank {r} differs from rank 0"
    return ref, res[0]["same"], [r["rank"] for r in res]


@pytest.mark.parametrize("serialized", C.SERIALIZED)
@pytest.mark.parametrize("compress", C.COMPRESS)
@pytest.mark.parametrize("n_pods", C.PODS)
def test_cross_pod_mean_matches_reference(runs, n_pods, compress, serialized):
    ref, _, mine = runs
    want = ref[("exchange", n_pods, compress, serialized)]
    for rank, res in enumerate(mine):
        coord, *got = res[("exchange", n_pods, compress, serialized)]
        assert coord == rank % n_pods
        for call, (g, w) in enumerate(zip(got, want)):
            if w is None:                       # the pmean hands residuals back as given
                assert g is None
                continue
            gl, wl = leaves(g), leaves(w)
            assert len(gl) == len(wl) == C.N_LEAVES
            for a, b in zip(gl, wl):
                if isinstance(b, float):        # none / bf16 fill the residuals with 0.0
                    assert a == b == 0.0, (rank, call)
                    continue
                b = b[coord]
                assert a.dtype == b.dtype and a.shape == b.shape, (rank, call)
                if compress == "plain":
                    assert np.allclose(a, b, rtol=1e-6, atol=0), (rank, call)
                else:
                    assert a.tobytes() == b.tobytes(), (rank, call, np.abs(a - b).max())


def test_int8_sends_split_leaves_whole(runs):
    """A leaf whose blocks over ``model`` split int8's blocks of 256 is
    exchanged whole, so each rank's result is its block of the reference's
    (bit for bit); a leaf whose blocks hold whole blocks of 256 is exchanged
    as blocks, and equals its block of the whole leaf's exchange."""
    ref, _, mine = runs
    path = [i for i, (p, _) in enumerate(C._leaf_paths(C.LEAVES)) if p == ("b", "c")][0]
    want = leaves(ref[("exchange", 2, "int8", True)][0])[path]
    for res in mine:
        for name, (pod, model, got, whole) in res["int8 blocks"].items():
            assert got.tobytes() == whole.tobytes(), (name, pod, model)
            if name == "c":
                assert got.tobytes() == want[pod][model * 150:(model + 1) * 150].tobytes()


def _state_err(a, b):
    """(max |a - b| of the params, and of m and of v each over the leaf's
    max |b|): the params move by at most about lr a step whatever the
    gradient, where m and v follow it, so they are held to their own size."""
    out = [max(float(np.abs(np.asarray(p) - np.asarray(q)).max())
               for p, q in zip(leaves(a["params"]), leaves(b["params"])))]
    for key in ("m", "v"):
        out.append(max(float(np.abs(np.asarray(p) - np.asarray(q)).max())
                       / max(float(np.abs(np.asarray(q)).max()), 1e-30)
                       for p, q in zip(leaves(a["opt"][key]), leaves(b["opt"][key]))))
    return out


@pytest.mark.parametrize("variant", C.VARIANTS)
@pytest.mark.parametrize("shape", C.TRAIN_MESHES)
def test_train_step_matches_reference(runs, shape, variant):
    """Rank 0 (pod 0) against the reference, whose arrays read back from its
    first devices, pod 0's; the ranks of a pod agree bit for bit, and pod 1
    agrees with pod 0 within the variant's tolerance."""
    ref, _, mine = runs
    rmets, rstate = ref[("train", shape, variant)]
    mets, state = mine[0][("train", shape, variant)]
    for s, (got, want) in enumerate(zip(mets, rmets)):
        assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"]), (s, got, want)
        assert abs(got["grad_norm"] - want["grad_norm"]) <= 1e-4 * abs(want["grad_norm"]), s
    assert int(state["opt"]["step"]) == int(rstate["opt"]["step"]) == C.STEPS
    errs = _state_err(state, rstate)
    assert errs[0] <= STATE_TOL[variant] and max(errs[1:]) <= REF_TOL[variant], errs
    # the reference test's oracle on the port, on what carries the exchanged
    # gradient: the grad norm (the loss is taken before the exchange), m and
    # v against auto (the params move by up to lr where Adam divides a
    # gradient near zero by its own size)
    amets, astate = mine[0][("train", shape, "auto")]
    for got, want in zip(mets, amets):
        assert abs(got["loss"] - want["loss"]) < 1e-3
        assert abs(got["grad_norm"] - want["grad_norm"]) <= GNORM_TOL[variant] * want["grad_norm"]
    aerrs = _state_err(state, astate)
    assert max(aerrs[1:]) <= AUTO_TOL[variant], aerrs
    assert W.same(mine[1][("train", shape, variant)], mine[0][("train", shape, variant)])
    assert W.same(mine[3][("train", shape, variant)], mine[2][("train", shape, variant)])
    perrs = _state_err(mine[2][("train", shape, variant)][1], state)
    assert perrs[0] <= STATE_TOL[variant] and max(perrs[1:]) <= AUTO_TOL[variant], perrs


def test_moe_serdes_matches_auto(runs):
    _, port, _ = runs
    mets, state = port[("moe", "none")]
    amets, astate = port[("moe", "auto")]
    for got, want in zip(mets, amets):
        assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
        assert abs(got["grad_norm"] - want["grad_norm"]) <= 1e-4 * abs(want["grad_norm"])
        for k in ("moe_drops", "moe_peak_occupancy"):
            assert got[k] == want[k]
    assert max(_state_err(state, astate)) <= 1e-5


def test_pod_axis_of_one_is_auto(runs):
    _, port, _ = runs
    assert W.same(port[("pod1", "none")], port[("pod1", "auto")])


def test_serdes_errors(runs):
    _, port, _ = runs
    assert "axis_groups=True" in port[("error", "no groups")]
    assert "6 rows do not divide over 4 ranks" in port[("error", "batch of 6")]


def _fake_mesh(axes, shape, coords):
    """What `block` and `block_run` read of a mesh: names, sizes, and each
    axis's size and this rank's coordinate."""
    sizes = dict(zip(axes, shape))

    def axis(name):
        names = (name,) if isinstance(name, str) else tuple(name)
        size = int(np.prod([sizes[a] for a in names]))
        coord = int(np.ravel_multi_index([coords[a] for a in names],
                                         [sizes[a] for a in names]))
        return types.SimpleNamespace(size=size, coord=coord)

    return types.SimpleNamespace(axis_names=axes, shape=shape, axis=axis)


@pytest.mark.parametrize("shape, spec", [
    ((6, 8), (None, "model")), ((8, 6), ("model", None)), ((4, 6, 8), (None, "model", None)),
    ((4, 8, 6), ("data", "model", None)), ((3, 12, 5), (None, Parts("model", 3), None)),
    ((6, 8), (None, None)), ((6, 8), ("pod", None))])
def test_block_run_is_the_blocks_runs(shape, spec):
    """`block_run` against the runs of the whole tensor's flat indices that
    each rank's block holds, in the block's flat order."""
    mesh_axes, mesh_shape_ = ("pod", "data", "model"), (1, 2, 2)
    for coords in np.ndindex(*mesh_shape_):
        mesh = _fake_mesh(mesh_axes, mesh_shape_, dict(zip(mesh_axes, coords)))
        idx = block(torch.arange(int(np.prod(shape))).reshape(shape), spec, mesh)
        flat = idx.reshape(-1).numpy()
        starts = np.flatnonzero(np.diff(flat) != 1) + 1
        runs = np.diff(np.concatenate([[0], starts, [flat.size]]))
        assert (runs == block_run(idx.shape, spec, mesh)).all(), (coords, runs)


@pytest.mark.parametrize("smoke, n_whole", [(False, 0), (True, 8)])
def test_int8_sends_whole_only_the_leaves_its_blocks_split(smoke, n_whole):
    """llama3.2-1b on (2, 1, 2): at full width every block of the model axis
    holds whole int8 blocks of 256, so each rank sends its blocks; at SMOKE
    widths 8 of 11 leaves go whole."""
    cfg = get_config(C.ARCH, smoke=smoke)
    mesh = types.SimpleNamespace(axis_names=C.AXES, shape=(2, 1, 2))
    specs = spec_leaves(shardings_for_params(cfg, mesh))
    shapes = [tuple(t.shape) for t in leaves(param_shapes(T.abstract_params(cfg)))]
    runs = [block_run([n // (2 if e == "model" else 1) for n, e in
                       zip(s, tuple(sp) + (None,) * (len(s) - len(sp)))], sp, mesh)
            for s, sp in zip(shapes, specs)]
    assert len(runs) == 11
    assert sum(r % QuasiSerdesConfig().block != 0 for r in runs) == n_whole, runs


CLI_ARGS = ["--smoke", "--device", "cpu", "--steps", "3", "--batch", "4", "--seq", "16",
            "--log-every", "1"]


def test_train_cli_pod_sync(capsys):
    out = {}
    for mode in ("auto", "serdes"):
        losses = ttrain.run(CLI_ARGS + ["--pod-sync", mode])
        lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("step")]
        out[mode] = (losses, lines)
    assert out["serdes"] == out["auto"] and len(out["auto"][1]) == 3
    with pytest.raises(SystemExit) as e:
        ttrain.run(CLI_ARGS + ["--pod-sync", "ring"])
    assert e.value.code == 2
