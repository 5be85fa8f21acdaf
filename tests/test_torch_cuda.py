"""The port's CUDA kernels and GPU paths, on an NVIDIA GPU only (marker
``cuda``; every test skips where ``torch.cuda.is_available()`` is false).

Run on a GPU host with ``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_cuda.py``.  The file imports neither jax nor the reference
package: it holds each kernel to its plain PyTorch version on the card, the
GPU paths of the apps (traced too) and of the whisper serve path to the same
paths on the CPU, and device-mesh execution in a gloo world on the card to
``mode="sim"``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import telemetry  # noqa: E402
from repro_torch.apps import bmvm, ldpc  # noqa: E402
from repro_torch.apps import particle_filter as pf  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import flash_attention, gf2_bmvm, histogram, minsum, ops, ref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers as model_layers  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

pytestmark = pytest.mark.cuda

GF2_CASES = [(16, 4, 1), (32, 4, 3), (64, 8, 5), (128, 4, 2), (128, 8, 8), (1024, 8, 64)]
MINSUM_SHAPES = [(1, 3), (7, 3), (64, 6), (200, 4), (1000, 8), (100003, 3), (513, 32),
                 (100, 33), (50, 64), (20, 1000)]
HIST_CASES = [(1, 64, 8), (10, 300, 16), (33, 517, 12), (8, 1024, 32), (257, 4096, 16),
              (64, 4096, 33), (64, 4096, 64), (33, 517, 256), (5, 517, 1816)]
# the sweep of tests/test_kernels.py, ragged S/T at whisper's T, and head dims
# of each thread-group width (D <= 32, <= 64, <= 128, and not a multiple of 32)
FLASH_CASES = [(1, 4, 2, 64, 64, 32), (2, 2, 2, 37, 37, 16), (1, 8, 2, 16, 128, 32),
               (1, 2, 1, 128, 256, 64), (2, 4, 4, 100, 100, 8), (1, 2, 2, 37, 1500, 64),
               (2, 4, 2, 129, 65, 128), (1, 3, 1, 33, 70, 96), (1, 2, 1, 40, 50, 160),
               (1, 3, 1, 70, 129, 192), (1, 2, 2, 33, 70, 256)]
# the tensor-core kernel's DP = 256 instance (gemma-7b's head dim, and two
# that take it padded)
WIDE_HEAD_DIMS = [160, 192, 256]
WHISPER_FLASH = [(4, 20, 1500, 1500, 64), (4, 20, 32, 1500, 64)]
# the tensor-core kernel (bf16/fp16): head dims of both widths (DP = 64, 128),
# two that take the wrapper's padding to a multiple of 8 (40, 100), and query
# and key lengths from one row to whisper's 1500, ragged against the 128-row
# blocks and 64-key tiles; 4 query heads on 2 kv heads (GQA)
TC_HEAD_DIMS = [16, 40, 64, 100, 128]
TC_LENGTHS = [1, 37, 64, 1500]


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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape", [(1, 3), (100003, 3), (100, 33), (50, 64), (20, 1000)])
def test_minsum_kernel_half_types_bit_exact(dev, dtype, shape):
    """bf16/fp16 load, compare in float32 and store in their type: the two
    mins and the signs are exact in any float type, so bit for bit."""
    rng = np.random.default_rng(shape[1])
    u = torch.as_tensor((rng.normal(size=shape) * 4).astype(np.float32), device=dev).to(dtype)
    out = ops.minsum_check(u)
    assert out.dtype == dtype
    assert torch.equal(out, ops.minsum_check(u, use_kernel=False))


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


@pytest.mark.parametrize("n_bins", [1, 7, 16, 32])
@pytest.mark.parametrize("px", [1, 3, 517, 4096])
@pytest.mark.parametrize("N", [1, 5, 4096])
def test_histogram_kernel_edge_cases(dev, N, px, n_bins):
    """Rows that do not start on 16 bytes (px % 4 != 0), ragged tails, bins
    outside [0, n_bins), one particle to the main path's 4096: within 1e-5
    of the plain version and bit-for-bit repeatable."""
    rng = np.random.default_rng(N * 7919 + px * 31 + n_bins)
    bins = torch.as_tensor(rng.integers(-2, n_bins + 2, (N, px)).astype(np.int32), device=dev)
    w = torch.as_tensor(rng.uniform(0.1, 1, (px,)).astype(np.float32), device=dev)
    rh = torch.as_tensor(rng.uniform(0, 1, (n_bins,)).astype(np.float32), device=dev)
    rh = rh / rh.sum()
    h, bc = ops.particle_histogram(bins, w, rh)
    hp, bcp = ops.particle_histogram(bins, w, rh, use_kernel=False)
    assert torch.allclose(h, hp, atol=1e-5, rtol=0) and torch.allclose(bc, bcp, atol=1e-5, rtol=0)
    h2, bc2 = ops.particle_histogram(bins, w, rh)
    assert torch.equal(h, h2) and torch.equal(bc, bc2)


@pytest.mark.parametrize("N,px", [(5, 517), (64, 4096)])
def test_histogram_kernel_reads_unaligned_bases(dev, N, px):
    """bins and weights that start 4 bytes past a 16-byte boundary (views
    one element into their storage) are read correctly."""
    rng = np.random.default_rng(px)
    flat = torch.as_tensor(rng.integers(-1, 17, (N * px + 1,)).astype(np.int32), device=dev)
    bins = flat[1:].view(N, px)
    w = torch.as_tensor(rng.uniform(0.1, 1, (px + 1,)).astype(np.float32), device=dev)[1:]
    assert bins.data_ptr() % 16 and w.data_ptr() % 16
    rh = torch.full((16,), 1 / 16, device=dev)
    h, bc = ops.particle_histogram(bins, w, rh)
    hp, bcp = ops.particle_histogram(bins.clone(), w.clone(), rh, use_kernel=False)
    assert torch.allclose(h, hp, atol=1e-5, rtol=0) and torch.allclose(bc, bcp, atol=1e-5, rtol=0)


def test_histogram_kernel_with_weights_not_staged(dev):
    """A ROI too large for the weights to be staged in shared memory reads
    them from global memory."""
    N, px = 6, 224 * 224
    assert not histogram.launch_shape(N, px, 16, 132)[3]      # stage_w
    rng = np.random.default_rng(224)
    bins = torch.as_tensor(rng.integers(0, 16, (N, px)).astype(np.int32), device=dev)
    w = torch.as_tensor(rng.uniform(0.1, 1, (px,)).astype(np.float32), device=dev)
    rh = torch.full((16,), 1 / 16, device=dev)
    h, bc = ops.particle_histogram(bins, w, rh)
    hp, bcp = ops.particle_histogram(bins, w, rh, use_kernel=False)
    assert torch.allclose(h, hp, atol=1e-5, rtol=0) and torch.allclose(bc, bcp, atol=1e-5, rtol=0)


@pytest.mark.parametrize("R", [1, 3, 5, 512])
@pytest.mark.parametrize("C", [1, 37, 300, 1001])
@pytest.mark.parametrize("M", [1, 64])
def test_gf2_bmvm_kernel_random_luts(dev, M, C, R):
    """The kernel's contract is any int32 LUT (C, 2^k, R): random words, C
    not a multiple of the chunk, R not a multiple of 4; equal to the plain
    version, and a second launch repeats it."""
    k = 4
    rng = np.random.default_rng(M * 1000003 + C * 101 + R)
    lut = torch.as_tensor(rng.integers(-2 ** 31, 2 ** 31, (C, 2 ** k, R), dtype=np.int64)
                          .astype(np.int32), device=dev)
    vw = torch.as_tensor(rng.integers(0, 2 ** k, (M, C)).astype(np.int32), device=dev)
    chunk, n_chunks = gf2_bmvm.launch_shape(M, C, R, torch.cuda.get_device_properties(dev)
                                            .multi_processor_count)
    if C >= 300:
        assert C % chunk and n_chunks > 1
    out = ops.gf2_bmvm(lut, vw)
    assert torch.equal(out, ops.gf2_bmvm(lut, vw, use_kernel=False))
    assert torch.equal(out, ops.gf2_bmvm(lut, vw))


@pytest.mark.parametrize("R", [5, 512])
def test_gf2_bmvm_kernel_reads_an_unaligned_lut(dev, R):
    """A LUT that starts 4 bytes past a 16-byte boundary takes the 4-byte
    loads and is read correctly."""
    C, P, M = 300, 16, 64
    rng = np.random.default_rng(R)
    flat = torch.as_tensor(rng.integers(-2 ** 31, 2 ** 31, (C * P * R + 1,), dtype=np.int64)
                           .astype(np.int32), device=dev)
    lut = flat[1:].view(C, P, R)
    assert lut.data_ptr() % 16
    vw = torch.as_tensor(rng.integers(0, P, (M, C)).astype(np.int32), device=dev)
    assert torch.equal(ops.gf2_bmvm(lut, vw), ops.gf2_bmvm(lut.clone(), vw, use_kernel=False))


def test_gf2_bmvm_kernel_masks_indices_to_k_bits(dev):
    """Index words with bits above k select the row of their low k bits."""
    rng = np.random.default_rng(5)
    lut = torch.as_tensor(rng.integers(0, 2 ** 31, (40, 16, 64)).astype(np.int32), device=dev)
    vw = torch.as_tensor(rng.integers(0, 2 ** 20, (3, 40)).astype(np.int32), device=dev)
    assert torch.equal(ops.gf2_bmvm(lut, vw), ops.gf2_bmvm(lut, vw & 15, use_kernel=False))


def test_gf2_bmvm_kernel_takes_c_past_the_first_kernels_limit(dev):
    """C = 16384 words of v (64 KiB) exceeded the first kernel's 48 KiB
    shared-memory row; a block now stages its chunk 1024 columns at a time."""
    C, P, R, M = 16384, 2, 8, 3
    assert gf2_bmvm.launch_shape(M, C, R, 132)[0] > 1024
    rng = np.random.default_rng(16384)
    lut = torch.as_tensor(rng.integers(0, 2 ** 31, (C, P, R)).astype(np.int32), device=dev)
    vw = torch.as_tensor(rng.integers(0, P, (M, C)).astype(np.int32), device=dev)
    assert torch.equal(ops.gf2_bmvm(lut, vw), ops.gf2_bmvm(lut, vw, use_kernel=False))


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
            ops.minsum_check(torch.randn(4, minsum.max_degree(torch.float32) + 1, device=dev))
        elif case == "devices":
            ops.gf2_bmvm(lut, torch.zeros((2, 4), dtype=torch.int32))
        else:
            ops.particle_histogram(torch.zeros((2, 5), dtype=torch.int32, device=dev),
                                   torch.ones(5, device=dev),
                                   torch.ones(histogram.MAX_BINS + 1, device=dev))
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


@pytest.mark.parametrize("pods", [[0] * 4 + [1] * 4, [0, 0, 1, 1, 2, 2, 3, 3]])
@pytest.mark.parametrize("mode", ["sim", "sim_python"])
def test_partitioned_bmvm_on_gpu_matches_cpu(dev, pods, mode):
    """The BMVM NoC cut into pods: on the card, equal to the uncut run and to
    the CPU run in outputs and every NoCStats counter (bridges included)."""
    rng = np.random.default_rng(1)
    cfg = bmvm.BMVMConfig(n=64, k=8, fold=2)
    A = rng.integers(0, 2, (64, 64)).astype(np.uint8)
    v = rng.integers(0, 2, (64,)).astype(np.uint8)
    lut_g, lut_c = bmvm.preprocess(A, cfg, device=dev), bmvm.preprocess(A, cfg, device="cpu")
    out0, _ = bmvm.iterate_noc_sim(lut_g, v, cfg, 2, device=dev)
    out_g, st_g = bmvm.iterate_noc_sim(lut_g, v, cfg, 2, pods=pods, mode=mode, device=dev)
    out_c, st_c = bmvm.iterate_noc_sim(lut_c, v, cfg, 2, pods=pods, mode=mode, device="cpu")
    assert np.array_equal(out_g, out0) and np.array_equal(out_g, out_c)
    assert st_g.as_dict() == st_c.as_dict() and st_g.bridge_beats > 0


@pytest.mark.parametrize("pods", [None, [0] * 4 + [1] * 4])
def test_traced_buffered_bmvm_on_gpu_matches_cpu(dev, pods):
    """A traced buffered BMVM n=64 run on the card: the same event list as the
    CPU run, and trace_stats equal to its NoCStats."""
    rng = np.random.default_rng(2)
    cfg = bmvm.BMVMConfig(n=64, k=8, fold=2)
    A = rng.integers(0, 2, (64, 64)).astype(np.uint8)
    v = rng.integers(0, 2, (64,)).astype(np.uint8)
    runs = []
    for d in (dev, "cpu"):
        tr = telemetry.Tracer()
        _, st = bmvm.iterate_noc_sim(bmvm.preprocess(A, cfg, device=d), v, cfg, 2,
                                     mode="buffered", pods=pods, tracer=tr, device=d)
        runs.append((tr.events(), st.as_dict()))
        assert telemetry.trace_stats(tr).as_dict() == st.as_dict()
    assert runs[0] == runs[1] and runs[0][1]["switch_cycles"] > 0


def _qkv(dev, seed, B, Hq, Hkv, S, T, D, dtype=torch.float32):
    g = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn(shape, generator=g, device=dev).to(dtype)
                 for shape in ((B, Hq, S, D), (B, Hkv, T, D), (B, Hkv, T, D)))


@pytest.mark.parametrize("B,Hq,Hkv,S,T,D", FLASH_CASES)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_kernel_matches_plain(dev, B, Hq, Hkv, S, T, D, causal):
    q, k, v = _qkv(dev, S + T, B, Hq, Hkv, S, T, D)
    before = flash_attention.flash_attention.launches
    out = ops.flash_attention(q, k, v, causal, True)
    assert flash_attention.flash_attention.launches == before + 1
    plain = flash_attention.flash_attention_plain(q, k, v, causal)
    assert torch.allclose(out, plain, atol=3e-5, rtol=0)
    seen = max(S - T, 0) if causal else 0      # the first rows of causal S > T see no key
    assert torch.allclose(out[:, :, seen:], ref.mha(q, k, v, causal)[:, :, seen:], atol=3e-5,
                          rtol=0)


@pytest.mark.parametrize("shape", [(1, 2, 2, 32, 32, 16)] + [
    (B, H, H, S, T, D) for B, H, S, T, D in WHISPER_FLASH])
def test_flash_attention_kernel_bf16(dev, shape):
    q, k, v = _qkv(dev, 1, *shape, dtype=torch.bfloat16)
    causal = shape[3] == 32 and shape[4] == 32
    out = ops.flash_attention(q, k, v, causal, True)
    assert out.dtype == torch.bfloat16
    plain = flash_attention.flash_attention_plain(q, k, v, causal)
    assert torch.allclose(out.float(), plain.float(), atol=3e-2, rtol=0)


@pytest.mark.parametrize("D", TC_HEAD_DIMS)
@pytest.mark.parametrize("S", TC_LENGTHS)
@pytest.mark.parametrize("T", TC_LENGTHS)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_tensor_core_grid_bf16(dev, D, S, T, causal):
    """The tensor-core kernel over the grid, split or not as num_splits
    decides, within 3e-2 of the plain version; with causal S > T the rows
    that see no key are exactly zero."""
    q, k, v = _qkv(dev, S * T + D, 1, 4, 2, S, T, D, dtype=torch.bfloat16)
    before = flash_attention.flash_attention.launches
    out = ops.flash_attention(q, k, v, causal, True)
    assert flash_attention.flash_attention.launches == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    plain = flash_attention.flash_attention_plain(q, k, v, causal)
    assert torch.allclose(out.float(), plain.float(), atol=3e-2, rtol=0)
    blind = max(S - T, 0) if causal else 0
    assert torch.equal(out[:, :, :blind], torch.zeros_like(out[:, :, :blind]))


@pytest.mark.parametrize("D", WIDE_HEAD_DIMS)
@pytest.mark.parametrize("S,T", [(1, 1500), (37, 64), (130, 129), (1024, 1024)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_attention_wide_head_dims(dev, D, S, T, causal, dtype):
    """D in (128, 256]: the DP = 256 tensor-core instance, counted as such,
    within 3e-2 of the plain version; blind rows exactly zero."""
    q, k, v = _qkv(dev, D + S, 1, 4, 2, S, T, D, dtype)
    before = flash_attention.flash_attention.instance_launches.get("tc256", 0)
    out = ops.flash_attention(q, k, v, causal, True)
    assert flash_attention.flash_attention.instance_launches["tc256"] == before + 1
    plain = flash_attention.flash_attention_plain(q, k, v, causal)
    assert (out.float() - plain.float()).abs().max().item() <= 3e-2
    blind = max(S - T, 0) if causal else 0
    assert not out[:, :, :blind].any()


def test_flash_attention_fp16_matches_plain(dev):
    q, k, v = _qkv(dev, 5, 2, 8, 2, 150, 300, 64, dtype=torch.float16)
    for causal in (True, False):
        out = ops.flash_attention(q, k, v, causal, True)
        assert out.dtype == torch.float16
        plain = flash_attention.flash_attention_plain(q, k, v, causal)
        assert torch.allclose(out.float(), plain.float(), atol=3e-2, rtol=0)


def test_flash_attention_cross_shape_takes_the_split_path(dev):
    """Whisper's cross-attention at prompt 32 splits the keys: one combine
    launch per call; the combine kernel equals its plain version on the
    kernel's own partials, whose m and l match the plain partials."""
    B, H, S, T, D = WHISPER_FLASH[1]
    q, k, v = _qkv(dev, 11, B, H, H, S, T, D, dtype=torch.bfloat16)
    n = flash_attention.num_splits(B, H, S, T, torch.cuda.get_device_properties(dev)
                                   .multi_processor_count)
    assert n > 1
    before = flash_attention.flash_attention.combine_launches
    out = ops.flash_attention(q, k, v, False, True)
    assert flash_attention.flash_attention.combine_launches == before + 1
    plain = flash_attention.flash_attention_plain(q, k, v, False)
    assert torch.allclose(out.float(), plain.float(), atol=3e-2, rtol=0)
    m, l, acc = flash_attention.flash_attention_partials(q, k, v, False, n)
    got = flash_attention.flash_attention_combine(m, l, acc, torch.float32)
    assert torch.allclose(got, flash_attention.flash_attention_combine_plain(m, l, acc),
                          atol=1e-6, rtol=0)
    parts = [flash_attention.flash_attention_partial_plain(q, k, v, False, lo, hi)
             for lo, hi in flash_attention.key_ranges(T, n)]
    m_p, l_p = torch.stack([p[0] for p in parts]), torch.stack([p[1] for p in parts])
    assert torch.allclose(m, m_p, atol=1e-4, rtol=1e-5)
    assert torch.allclose(l, l_p, atol=0, rtol=1e-4)


def test_flash_attention_fully_masked_rows_pinned_to_zero(dev):
    """Causal with S > T: rows that see no key are exactly zero; the others
    match ref.mha (which is NaN on the blind rows)."""
    S, T = 150, 40
    q, k, v = _qkv(dev, 7, 2, 4, 2, S, T, 64)
    out = ops.flash_attention(q, k, v, True, True)
    assert torch.isfinite(out).all()
    blind = S - T
    assert torch.equal(out[:, :, :blind], torch.zeros_like(out[:, :, :blind]))
    assert torch.allclose(out[:, :, blind:], ref.mha(q, k, v, True)[:, :, blind:], atol=3e-5,
                          rtol=0)
    assert torch.allclose(out, flash_attention.flash_attention_plain(q, k, v, True), atol=3e-5,
                          rtol=0)


def test_flash_attention_gradient_through_the_kernel(dev):
    q, k, v = (t.requires_grad_() for t in _qkv(dev, 3, 1, 4, 2, 40, 70, 32))
    ops.flash_attention(q, k, v, True, True).square().sum().backward()
    q2, k2, v2 = (t.detach().clone().requires_grad_() for t in (q, k, v))
    ref.mha(q2, k2, v2, True).square().sum().backward()
    for a, b in ((q, q2), (k, k2), (v, v2)):
        assert torch.isfinite(a.grad).all()
        assert torch.allclose(a.grad, b.grad, atol=1e-4, rtol=0)


@pytest.mark.parametrize("case", ["dtype", "mixed_dtype", "head_dim", "heads", "kv_shape",
                                  "contiguity", "rank", "devices"])
def test_flash_attention_rejects_what_the_kernel_does_not_take(dev, case):
    q, k, v = _qkv(dev, 0, 1, 4, 2, 8, 8, 16)
    before = flash_attention.flash_attention.launches
    with pytest.raises((TypeError, ValueError)):
        if case == "dtype":
            flash_attention.flash_attention(q.double(), k.double(), v.double())
        elif case == "mixed_dtype":
            flash_attention.flash_attention(q, k.bfloat16(), v)
        elif case == "head_dim":
            flash_attention.flash_attention(*_qkv(dev, 0, 1, 2, 2, 4, 4, 264))
        elif case == "heads":
            flash_attention.flash_attention(*_qkv(dev, 0, 1, 3, 2, 4, 4, 16))
        elif case == "kv_shape":
            flash_attention.flash_attention(q, k, v[:, :, :5])
        elif case == "contiguity":
            flash_attention.flash_attention(q.transpose(2, 3), k, v)
        elif case == "rank":
            flash_attention.flash_attention(q[0], k[0], v[0])
        else:
            flash_attention.flash_attention(q, k.cpu(), v)
    assert flash_attention.flash_attention.launches == before
    torch.cuda.synchronize()


def _to(tree, device):
    """A copy on ``device`` (the train step updates its params in place)."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device, copy=True)
    return {k: _to(v, device) for k, v in tree.items()}


def test_whisper_serve_path_on_gpu_matches_cpu(dev):
    """Whisper SMOKE with the flash impl: the kernel launches once per encoder
    layer and once per decoder layer in a prefill and never in a decode step;
    prefill and decode logits equal the CPU run's (plain versions) to 1e-3 of
    their scale, and serve_batch gives the CPU's tokens."""
    cfg = get_config("whisper-large-v3", smoke=True).replace(attn_impl="flash")
    params = model_layers.init_params(T.abstract_params(cfg), torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (2, 10))
    frames = rng.normal(size=(2, cfg.enc_seq, cfg.d_frontend)).astype(np.float32)
    logits = {}
    for d in ("cpu", dev):
        p = _to(params, d)
        cache = T.init_cache(cfg, 2, 12, device=d)
        ops.reset_launch_counts()
        lg, cache = T.prefill(p, {"tokens": torch.as_tensor(toks, device=d),
                                  "frames": torch.as_tensor(frames, device=d)}, cfg, cache)
        n_prefill = ops.launch_counts()["flash_attention"]
        lg2, cache = T.decode_step(p, {"tokens": torch.as_tensor(toks[:, :1], device=d)}, cfg,
                                   cache)
        assert ops.launch_counts()["flash_attention"] == n_prefill
        expect = (cfg.n_enc_layers + cfg.n_layers) if d == dev else 0
        assert n_prefill == expect
        logits[str(d)] = (lg.cpu(), lg2.cpu())
    (a, b), (c, e) = logits["cpu"], logits[str(dev)]
    scale = max(a.abs().max().item(), 1.0)
    assert (a - c).abs().max().item() < 1e-3 * scale and (b - e).abs().max().item() < 1e-3 * scale
    prompts = toks[:, :6]
    assert np.array_equal(serve.serve_batch(_to(params, dev), cfg, prompts, 4, device=dev),
                          serve.serve_batch(params, cfg, prompts, 4, device="cpu"))



@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen3-moe-235b-a22b"])
def test_seeded_train_state_is_the_same_model_on_every_device(dev, arch):
    """``launch.train.build_state`` draws from a CPU generator: a seed gives the
    card the CPU's weights, as the reference's ``jax.random.key`` does."""
    from repro_torch._tree import leaves
    from repro_torch.launch.train import build_state
    cfg = get_config(arch, smoke=True)
    on_card, on_cpu = build_state(cfg, 0, dev), build_state(cfg, 0, "cpu")
    card, cpu = leaves(on_card["params"]), leaves(on_cpu["params"])
    assert len(card) == len(cpu) and all(a.is_cuda for a in card)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(card, cpu))


@pytest.mark.parametrize("arch", ["llama3.2-1b", "gemma-7b"])
def test_dense_train_steps_on_gpu_match_cpu(dev, arch):
    """Dense SMOKE with the flash impl and remat, three train steps: the
    kernel launches twice a layer a step (forward, and the remat forward in
    the backward); losses and grad norms equal the CPU run's (plain versions)
    to 1e-3 of their scale."""
    from repro_torch.data.pipeline import DataConfig, _synthesize
    from repro_torch.launch.train import device_batch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import AdamWConfig, adamw_init

    cfg = get_config(arch, smoke=True).replace(attn_impl="flash", remat=True)
    params = model_layers.init_params(T.abstract_params(cfg), torch.Generator().manual_seed(0))
    data = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4, seed=0)
    step = make_train_step(cfg, AdamWConfig(lr=2e-3), total_steps=10, warmup=1)
    mets = {}
    for d in ("cpu", dev):
        p = _to(params, d)
        state = {"params": p, "opt": adamw_init(p)}
        ops.reset_launch_counts()
        out = []
        for s in range(3):
            state, m = step(state, device_batch(_synthesize(data, s), cfg, d))
            out.append((float(m["loss"]), float(m["grad_norm"])))
        assert ops.launch_counts()["flash_attention"] == (3 * 2 * cfg.n_layers if d == dev else 0)
        mets[str(d)] = np.array(out)
    assert np.abs(mets["cpu"] - mets[str(dev)]).max() < 1e-3 * np.abs(mets["cpu"]).max()


@pytest.mark.parametrize("arch,kw", [
    ("phi3.5-moe-42b-a6.6b", dict(moe_impl="gather", moe_flit_buffer_depth=2)),
    ("qwen3-moe-235b-a22b", dict(moe_impl="gather", moe_flit_buffer_depth=2)),
    ("minicpm3-4b", {}), ("internvl2-1b", {}), ("jamba-v0.1-52b", {}), ("xlstm-350m", {})])
def test_family_smoke_on_gpu_matches_cpu(dev, arch, kw):
    """The MoE (one-rank gather engine, packets dropped at depth 2), MLA,
    vlm, hybrid and xlstm families at SMOKE with the flash impl and remat: forward logits
    within 1e-3 of their scale and the stack's drops and peak equal, greedy
    serve tokens equal, three train steps' loss and grad norm within 1e-3 of
    their scale and their MoE counters equal; flash launches twice an
    attention layer a step on the card (MLA takes no kernel)."""
    from repro_torch.data.pipeline import DataConfig, _synthesize
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import device_batch
    from repro_torch.optim import AdamWConfig, adamw_init

    cfg = get_config(arch, smoke=True).replace(attn_impl="flash", remat=True, **kw)
    params = model_layers.init_params(T.abstract_params(cfg), torch.Generator().manual_seed(0))
    data = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4, seed=0)
    step = make_train_step(cfg, AdamWConfig(lr=2e-3), total_steps=10, warmup=1)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (4, 8))
    n_attn = 3 * 2 * sum(m == "attn" for m, _ in cfg.pattern) * cfg.n_periods
    got = {}
    for d in ("cpu", dev):
        p = _to(params, d)
        state = {"params": p, "opt": adamw_init(p)}
        batches = [device_batch(_synthesize(data, s), cfg, d) for s in range(3)]
        with torch.no_grad():
            lg, _, _, st = T.forward(p, batches[0], cfg)
        tokens = serve.serve_batch(p, cfg, prompts, 4, device=d)
        ops.reset_launch_counts()
        mets = []
        for b in batches:
            state, m = step(state, b)
            mets.append([float(m[k]) for k in ("loss", "grad_norm", "moe_drops",
                                                "moe_peak_occupancy")])
        assert ops.launch_counts()["flash_attention"] == (n_attn if d == dev else 0)
        got[str(d)] = (lg.cpu(), {k: int(v) for k, v in st.items()}, tokens, np.array(mets))
    (lc, sc, tc, mc), (lg_, sg, tg, mg) = got["cpu"], got[str(dev)]
    assert (lc - lg_).abs().max() <= 1e-3 * max(lc.abs().max().item(), 1.0)
    assert sc == sg and np.array_equal(tc, tg)
    assert (np.abs(mc[:, :2] - mg[:, :2]) <= 1e-3 * np.abs(mc[:, :2]).max(0)).all()
    assert np.array_equal(mc[:, 2:], mg[:, 2:])
    if kw:
        assert (mc[:, 2] > 0).all()


@pytest.mark.parametrize("mixer", ["mamba", "mlstm", "slstm"])
def test_mixer_on_gpu_matches_cpu(dev, mixer):
    """Mamba, mLSTM and sLSTM on the card against the CPU: chunked over 21
    tokens at chunk 8 (a padded last chunk), then a prefill of 13 tokens and
    one decode step against a cache; outputs and states within 1e-4 of
    their scale."""
    from repro_torch.models import ssm, xlstm

    if mixer == "mamba":
        c = ssm.MambaConfig(64, d_state=16, chunk=8)
        specs, apply, init = ssm.mamba_specs(c), ssm.mamba_apply, ssm.init_mamba_cache
    else:
        c = xlstm.XLSTMConfig(64, 4, chunk=8)
        specs, apply = getattr(xlstm, f"{mixer}_specs")(c), getattr(xlstm, f"{mixer}_apply")
        init = xlstm.init_mlstm_cache if mixer == "mlstm" else xlstm.init_slstm_cache
    p = model_layers.init_params(specs, torch.Generator().manual_seed(0))
    x = torch.randn((2, 21, 64), generator=torch.Generator().manual_seed(1))

    def run(d):
        pd, xd = _to(p, d), x.to(d)
        out = [apply(pd, xd, c)[0]]
        cache = init(c, 2, device=d)
        for lo, hi in ((0, 13), (13, 14)):
            o, cache = apply(pd, xd[:, lo:hi], c, cache)
            out.append(o)
        return [t.cpu() for t in out + list(cache.values())]

    for a, b in zip(run("cpu"), run(dev)):
        assert (a - b).abs().max() <= 1e-4 * max(a.abs().max().item(), 1.0)


def test_spmd_on_gpu_matches_sim(dev, tmp_path):
    """A 4-rank gloo world whose ranks all compute on the card (cuda:0 on a
    one-card host; gloo's transfers staged through the host): the diamond on
    the 4-node mesh in mode="spmd" equals sim in outputs and NoCStats (run,
    run_batch, a 2-pod plan), and bmvm.iterate_spmd equals the direct product
    with the gf2_bmvm kernel launched in every rank."""
    import torch_spmd_worlds as W   # beside this file; pytest puts tests/ on sys.path

    diamond = W.World("noc_diamond", 4, tmp_path / "diamond", device="cuda")
    for key, (out, st, out_sim, st_sim) in W.one_result(diamond).items():
        assert out.keys() == out_sim.keys(), key
        assert all(np.array_equal(out[k], out_sim[k]) for k in out), key
        assert st == st_sim, key
    res = W.one_result(W.World("iterate_spmd", 4, tmp_path / "bmvm", device="cuda"))
    A, V = W.bmvm_spmd_inputs()
    want = bmvm.software_ref(A, V, 3, device="cpu")
    for name in W.TOPOLOGIES:
        assert np.array_equal(res[name], want), name
        assert res[("launches", name)] == 3, name
