"""The port's BMVM (Tables IV and V) and particle-filter examples against the
reference's, on the CPU, by the masking rule of ``tests/torch_examples.py``
(the other three examples are in ``test_torch_examples.py``).

The particle tracker draws its motion noise from a ``torch.Generator``, so
its errors and estimates are masked in the line comparison; they are held to
the bounds that the reference's run (1.33 / 2.04 px) and the port's CPU run
(1.25 / 1.78 px) satisfy, 2.0 px mean and 3.0 px max, and the port's
``track`` given the reference's draws must reproduce the reference example's
printed estimates within 0.05 px, the precision of the print."""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import torch_examples as tx  # noqa: E402
from repro_torch.apps import particle_filter as tpf  # noqa: E402

TABLE_V = {"ring": (62, 1015808, "65.62"), "mesh": (20, 548864, "14.49"),
           "torus": (12, 327680, "8.33"), "fattree": (2, 31744, "1.32")}
TABLE_III = ["  pe0    raw= 16588B wrapped= 16668B", "  pe1    raw= 16588B wrapped= 16668B",
             "  pe2    raw= 16588B wrapped= 16668B", "  pe3    raw= 16588B wrapped= 16668B",
             "  root   raw=    56B wrapped=   200B"]


@pytest.fixture(scope="module")
def bmvm():
    return tx.run_reference("gf2_bmvm_topologies"), tx.run_port("gf2_bmvm_topologies")


@pytest.fixture(scope="module")
def pf():
    return tx.run_reference("particle_tracking"), tx.run_port("particle_tracking")


def ran(ref, port):
    assert ref.returncode == 0, ref.stderr[-3000:]
    assert port.returncode == 0, port.stderr[-3000:]


def test_bmvm_output_equals_reference_masked(bmvm):
    ref, port = bmvm
    ran(ref, port)
    assert tx.mask(port.stdout) == tx.mask(ref.stdout)


def test_bmvm_prints_the_lut_and_table_v(bmvm):
    _, port = bmvm
    lines = port.stdout.splitlines()
    assert lines[0] == "Table-IV analog: n=64 k=8 fold=2 (4 PEs), LUT (8, 256, 8) = 64 KiB"
    for topo, (rounds, link_bytes, model_us) in TABLE_V.items():
        (row,) = [ln.split() for ln in lines if ln.split()[:1] == [topo]]
        assert row[1:3] == [str(rounds), str(link_bytes)] and row[4] == model_us


def test_bmvm_table_iv_times_the_kernel_column(bmvm):
    _, port = bmvm
    lines = port.stdout.splitlines()
    assert lines[1].split() == ["r", "software(us)", "kernel(us)", "speedup"]
    rows = [ln.split() for ln in lines[2:6]]
    assert [int(r[0]) for r in rows] == [1, 10, 100, 1000]
    for r in rows:
        sw, hw, speedup = (float(x) for x in r[1:])
        assert sw > 0 and hw > 0 and speedup == pytest.approx(sw / hw, rel=0.02, abs=0.01)


def test_pf_output_equals_reference_masked(pf):
    ref, port = pf
    ran(ref, port)
    assert tx.mask(port.stdout) == tx.mask(ref.stdout)
    lines = port.stdout.splitlines()
    assert "(flits=456, rounds=76)" in lines[2]
    assert [ln for ln in lines if ln.startswith(("  pe", "  root"))] == TABLE_III


def errors(stdout):
    mean, mx = re.search(r"kernel path: +mean err ([\d.]+)px +max ([\d.]+)px", stdout).groups()
    noc = re.search(r"NoC \(4 PEs\): +mean err ([\d.]+)px", stdout).group(1)
    return float(mean), float(mx), float(noc)


@pytest.mark.parametrize("which", ["reference", "port"])
def test_pf_errors_within_bounds(pf, which):
    ref, port = pf
    ran(ref, port)
    mean, mx, noc = errors((ref if which == "reference" else port).stdout)
    assert mean <= 2.0 and mx <= 3.0 and noc <= 2.0


def reference_noise(cfg, n_frames):
    """The reference tracker's motion draws (key → split → normal), per frame."""
    key = jax.random.key(cfg.seed)
    out = []
    for _ in range(1, n_frames):
        key, k = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(k, (cfg.n_particles, 2))))
    return out


def test_pf_track_given_the_reference_draws_reproduces_its_estimates(pf):
    ref, _ = pf
    assert ref.returncode == 0, ref.stderr[-3000:]
    printed = np.array([[float(a), float(b)] for a, b in re.findall(
        r"frame \d: est=\(\s*([-\d.]+),\s*([-\d.]+)\)", ref.stdout)])
    assert printed.shape == (5, 2)
    cfg = tpf.PFConfig(img=64, roi=16, n_particles=64, n_bins=16, seed=0)
    frames, _ = tpf.synth_video(cfg, 20, np.random.default_rng(0))
    est = tpf.track(frames, cfg, noise=reference_noise(cfg, len(frames)), device="cpu")
    assert np.abs(est[:5] - printed).max() <= 0.05
