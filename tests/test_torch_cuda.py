"""The port's CUDA kernels and GPU paths, on an NVIDIA GPU only (marker
``cuda``; every test skips where ``torch.cuda.is_available()`` is false).

Run on a GPU host with ``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_cuda.py``.  The file imports neither jax nor the reference
package: it holds each kernel to its plain PyTorch version on the card, and the
GPU paths of the apps to the same paths on the CPU."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.apps import bmvm, ldpc  # noqa: E402
from repro_torch.apps import particle_filter as pf  # noqa: E402
from repro_torch.kernels import gf2_bmvm, histogram, minsum, ops, ref  # noqa: E402

pytestmark = pytest.mark.cuda

GF2_CASES = [(16, 4, 1), (32, 4, 3), (64, 8, 5), (128, 4, 2), (128, 8, 8), (1024, 8, 64)]
MINSUM_SHAPES = [(1, 3), (7, 3), (64, 6), (200, 4), (1000, 8), (100003, 3), (513, 32)]
HIST_CASES = [(1, 64, 8), (10, 300, 16), (33, 517, 12), (8, 1024, 32), (257, 4096, 16)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.parametrize("n,k,m", GF2_CASES)
def test_gf2_bmvm_kernel_matches_plain(dev, n, k, m):
    rng = np.random.default_rng(n + m)
    A = torch.as_tensor(rng.integers(0, 2, (n, n)).astype(np.uint8), device=dev)
    V = torch.as_tensor(rng.integers(0, 2, (m, n)).astype(np.uint8), device=dev)
    lut = ref.gf2_preprocess(A, k)
    vw = ref.gf2_pack_vector(V, k)
    before = gf2_bmvm.gf2_bmvm.launches
    out = ops.gf2_bmvm(lut, vw)
    assert gf2_bmvm.gf2_bmvm.launches == before + 1
    assert torch.equal(out, ops.gf2_bmvm(lut, vw, use_kernel=False))
    assert torch.equal(ref.gf2_unpack_vector(out, k), ref.gf2_matmul_oracle(A, V))


@pytest.mark.parametrize("shape", MINSUM_SHAPES)
def test_minsum_kernel_matches_plain(dev, shape):
    rng = np.random.default_rng(shape[0])
    u = torch.as_tensor((rng.normal(size=shape) * 4).astype(np.float32), device=dev)
    before = minsum.minsum_check.launches
    out = ops.minsum_check(u)
    assert minsum.minsum_check.launches == before + 1
    assert torch.allclose(out, ops.minsum_check(u, use_kernel=False), atol=1e-6, rtol=0)


def test_minsum_kernel_sign_and_tie_rules(dev):
    u = torch.tensor([[-0.0, 1.0, 2.0], [1.0, 1.0, 3.0], [2.0, -2.0, 5.0],
                      [float("inf"), float("inf"), 5.0], [-3.0, -0.5, -0.5],
                      [0.0, -0.0, 4.0]], device=dev)
    out, plain = ops.minsum_check(u), ref.minsum_check(u)
    assert torch.equal(out, plain)
    assert torch.equal(torch.signbit(out), torch.signbit(plain))


@pytest.mark.parametrize("N,px,B", HIST_CASES)
def test_histogram_kernel_matches_plain(dev, N, px, B):
    rng = np.random.default_rng(N + px)
    bins = torch.as_tensor(rng.integers(-1, B + 1, (N, px)).astype(np.int32), device=dev)
    w = torch.as_tensor(rng.uniform(0.1, 1, (px,)).astype(np.float32), device=dev)
    rh = torch.as_tensor(rng.uniform(0, 1, (B,)).astype(np.float32), device=dev)
    rh = rh / rh.sum()
    before = histogram.particle_histogram.launches
    h, bc = ops.particle_histogram(bins, w, rh)
    assert histogram.particle_histogram.launches == before + 1
    hp, bcp = ops.particle_histogram(bins, w, rh, use_kernel=False)
    assert torch.allclose(h, hp, atol=1e-5, rtol=0) and torch.allclose(bc, bcp, atol=1e-5, rtol=0)
    # deterministic: a second launch repeats the result bit for bit
    h2, bc2 = ops.particle_histogram(bins, w, rh)
    assert torch.equal(h, h2) and torch.equal(bc, bc2)


@pytest.mark.parametrize("case", ["dtype", "contiguity", "degree", "devices", "bins"])
def test_wrappers_reject_what_the_kernels_do_not_take(dev, case):
    u = torch.randn(8, 3, device=dev)
    lut = torch.zeros((4, 16, 4), dtype=torch.int32, device=dev)
    with pytest.raises((TypeError, ValueError)):
        if case == "dtype":
            ops.minsum_check(u.double())
        elif case == "contiguity":
            ops.minsum_check(torch.randn(3, 8, device=dev).T)
        elif case == "degree":
            ops.minsum_check(torch.randn(4, 33, device=dev))
        elif case == "devices":
            ops.gf2_bmvm(lut, torch.zeros((2, 4), dtype=torch.int32))
        else:
            ops.particle_histogram(torch.zeros((2, 5), dtype=torch.int32, device=dev),
                                   torch.ones(5, device=dev), torch.ones(40, device=dev))
    torch.cuda.synchronize()


def test_apps_on_gpu_match_cpu(dev):
    rng = np.random.default_rng(0)
    cfg = bmvm.BMVMConfig(n=64, k=8, fold=2)
    A = rng.integers(0, 2, (64, 64)).astype(np.uint8)
    V = rng.integers(0, 2, (3, 64)).astype(np.uint8)
    lut_g, lut_c = bmvm.preprocess(A, cfg, device=dev), bmvm.preprocess(A, cfg, device="cpu")
    assert torch.equal(lut_g.cpu(), lut_c)
    assert torch.equal(bmvm.iterate_kernel(lut_g, V, cfg, 3, device=dev).cpu(),
                       bmvm.iterate_kernel(lut_c, V, cfg, 3, device="cpu"))
    out_g, st_g = bmvm.iterate_noc_sim(lut_g, V[0], cfg, 2, device=dev)
    out_c, st_c = bmvm.iterate_noc_sim(lut_c, V[0], cfg, 2, device="cpu")
    assert np.array_equal(out_g, out_c) and st_g.as_dict() == st_c.as_dict()

    H = ldpc.pg_ldpc_H(copies=16)
    idx = ldpc.build_edge_index(H)
    llr = np.stack([ldpc.awgn_llr(np.zeros(H.shape[1], np.int8), 3.0, rng) for _ in range(4)])
    _, post_g = ldpc.decode_minsum(idx, llr, 10, device=dev)
    _, post_c = ldpc.decode_minsum(idx, llr, 10, device="cpu")
    assert np.allclose(post_g.cpu().numpy(), post_c.numpy(), atol=1e-4)

    pcfg = pf.PFConfig(img=48, roi=12, n_particles=32, n_bins=12)
    frames, _ = pf.synth_video(pcfg, 6, rng)
    noise = [rng.normal(size=(32, 2)).astype(np.float32) for _ in range(5)]
    est_g = pf.track(frames, pcfg, noise=noise, device=dev)
    est_c = pf.track(frames, pcfg, noise=noise, device="cpu")
    est_noc, _ = pf.track_on_noc(frames, pcfg, noise=noise, device=dev)
    assert np.abs(est_g - est_c).max() < 1e-3 and np.abs(est_noc - est_c).max() < 1e-3
