"""The port's examples against the reference's, on the CPU: the quickstart,
the LM train/restart/serve example and the LDPC case study (the BMVM and
particle-filter examples are in ``test_torch_examples_bmvm_pf.py``).

Each reference example runs once in a subprocess (``JAX_PLATFORMS=cpu``) and
each port example once with ``--device cpu``; their stdouts are compared line
for line after the masking rule of ``tests/torch_examples.py``.  Two
reference examples fail on this host at their first train step (ROADMAP
Queue 3): their exit code and the ``ShardingTypeError`` are pinned, and the
lines they printed before it must equal the port's.  The port's training
lines are held to their own properties: the loss falls, the restart resumes
from step 150 and runs 50 more steps, the served token matrix is (8, 8).
Besides: every port example without ``--device cpu`` raises
``resolve_device``'s ``RuntimeError`` on a host without a GPU, and none of
them imports ``jax`` or the JAX package."""
import os
import runpy

import pytest

torch = pytest.importorskip("torch")

import torch_examples as tx  # noqa: E402


@pytest.fixture(scope="module")
def quickstart():
    return tx.run_reference("quickstart"), tx.run_port("quickstart")


@pytest.fixture(scope="module")
def train_lm():
    return tx.run_reference("train_lm"), tx.run_port("train_lm")


@pytest.fixture(scope="module")
def ldpc():
    return tx.run_reference("ldpc_decode"), tx.run_port("ldpc_decode")


def assert_port_ran(port):
    assert port.returncode == 0, port.stderr[-3000:]


def assert_reference_fails_at_training(ref):
    assert ref.returncode != 0
    assert "ShardingTypeError" in ref.stderr


@pytest.mark.parametrize("fixture", ["quickstart", "train_lm"])
def test_reference_fails_at_its_first_train_step_and_the_lines_before_agree(fixture, request):
    ref, port = request.getfixturevalue(fixture)
    assert_reference_fails_at_training(ref)
    assert_port_ran(port)
    want, got = tx.mask(ref.stdout), tx.mask(port.stdout)
    assert want and got[:len(want)] == want


def test_quickstart_prints_the_reference_values(quickstart):
    ref, port = quickstart
    assert_port_ran(port)
    lines = port.stdout.splitlines()
    assert lines[0] == "single-pod NoC result: [ 1.  9. 25. 49.] ..."
    assert lines[1] == ("  network stats: {'waves': 3, 'rounds': 4, 'link_bytes': 2048, "
                        "'payload_bytes': 64, 'flits': 32, 'cross_pod_msgs': 0, "
                        "'cross_pod_wire_bytes': 0, 'cross_pod_beats': 0, 'bridge_beats': 0, "
                        "'bridge_wire_bytes': 0, 'bridge_stall_rounds': 0, "
                        "'bridge_peak_fifo': 0, 'switch_cycles': 0, 'switch_stall_cycles': 0, "
                        "'switch_arb_losses': 0, 'switch_max_queue': 0, "
                        "'switch_peak_link_flits': 0}")
    assert lines[2] == "2-pod partition identical; cross-pod msgs: 1 wire bytes: 32"
    assert lines[3] == ("traced run: 32 events -> 45 Perfetto events; trace aggregation "
                        "reproduces NoCStats bit-exactly")
    assert ref.stdout.splitlines()[:4] == lines[:4]


def test_quickstart_trains(quickstart):
    _, port = quickstart
    assert_port_ran(port)
    (run,) = tx.steps(port.stdout)
    assert [s for s, _ in run] == [1, 25, 50, 75, 100]
    assert run[-1][1] < run[0][1]
    assert tx.done_steps(port.stdout) == [100]
    assert "device=cpu" in port.stdout
    summary = port.stdout.splitlines()[-1]
    assert summary.startswith("loss: ") and summary.endswith("(decreasing => learning)")
    first, last = (float(x) for x in summary.split()[1:4:2])
    assert last < first


def test_train_lm_trains_restarts_and_serves(train_lm):
    _, port = train_lm
    assert_port_ran(port)
    first, second = tx.steps(port.stdout)
    assert [s for s, _ in first] == [1, 25, 50, 75, 100, 125, 150]
    assert first[-1][1] < first[0][1]
    assert [s for s, _ in second] == [1, 25, 50]
    assert second[-1][1] < second[0][1]
    out = port.stdout
    assert out.index("restored from step 150") < out.index("done: 50 steps")
    assert tx.done_steps(out) == [150, 50]
    assert "served 8/8 requests" in out
    assert out.splitlines()[-1] == "generated token matrix: (8, 8)"


def test_ldpc_output_equals_reference(ldpc):
    ref, port = ldpc
    assert ref.returncode == 0, ref.stderr[-3000:]
    assert_port_ran(port)
    assert tx.mask(port.stdout) == tx.mask(ref.stdout)
    # nothing of it is masked: the decode, the counters and the BER are exact
    assert port.stdout == ref.stdout


def test_ldpc_prints_the_known_values(ldpc):
    _, port = ldpc
    out = port.stdout
    assert "  chk0   raw=  24B wrapped= 120B overhead=+4.00x" in out
    assert "single-FPGA 4x4 mesh: decoded=[0 0 0 0 0 0 0] (rounds=60, flits=420)" in out
    assert "cross-chip msgs=180, wire bytes=2880" in out
    for line in ("SNR 1.0 dB: uncoded BER 0.0533  coded BER 0.0032",
                 "SNR 2.0 dB: uncoded BER 0.0355  coded BER 0.0012",
                 "SNR 3.0 dB: uncoded BER 0.0242  coded BER 0.0000",
                 "SNR 4.0 dB: uncoded BER 0.0142  coded BER 0.0000"):
        assert line in out


@pytest.mark.parametrize("name", tx.NAMES)
def test_port_example_needs_a_gpu_unless_asked_for_the_cpu(name):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the example would run on it")
    main = runpy.run_path(os.path.join(tx.EXAMPLES, f"{name}_torch.py"))["main"]
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        main([])


@pytest.mark.parametrize("name", tx.NAMES)
def test_port_example_imports_neither_jax_nor_the_jax_package(name):
    mods = tx.port_imports(name)
    assert "repro_torch" in mods
    assert not mods & {"jax", "jaxlib", "repro"}


@pytest.mark.parametrize("name", tx.NAMES)
def test_port_example_mirrors_the_reference_docstring(name):
    ref, port = (tx.docstring(os.path.join(tx.EXAMPLES, f)) for f in (f"{name}.py",
                                                                      f"{name}_torch.py"))
    assert f"python examples/{name}_torch.py [--device cpu]" in port
    assert port.split(",")[0].split(":")[0] == ref.split(",")[0].split(":")[0]
