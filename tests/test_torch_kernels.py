"""The port's kernels against the reference: the plain versions (what a CPU
tensor runs) held to the Pallas kernels in interpret mode and to the jnp
oracles over the shape sweeps of tests/test_kernels.py; the flash-attention
gradient; the wrappers' routing, checks and launch counters; and the CUDA
build.  The kernels themselves run in tests/test_torch_cuda.py, on a GPU
only."""
import ast
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro_torch.kernels import _build, flash_attention, gf2_bmvm, histogram, minsum  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
GF2_CASES = [(16, 4, 1), (32, 4, 3), (64, 8, 5), (128, 4, 2), (128, 8, 8)]
MINSUM_SHAPES = [(1, 3), (7, 3), (64, 6), (200, 4), (1000, 8), (5, 33), (40, 64)]
HIST_CASES = [(1, 64, 8), (10, 300, 16), (33, 517, 12), (8, 1024, 32), (6, 300, 33),
              (4, 517, 64), (3, 700, 256)]
FLASH_CASES = [(1, 4, 2, 64, 64, 32), (2, 2, 2, 37, 37, 16), (1, 8, 2, 16, 128, 32),
               (1, 2, 1, 128, 256, 64), (2, 4, 4, 100, 100, 8), (1, 2, 1, 40, 50, 160),
               (1, 2, 2, 33, 70, 256)]


# -- GF(2) BMVM ---------------------------------------------------------------

@pytest.mark.parametrize("n,k,m", GF2_CASES)
def test_gf2_bmvm_matches_pallas_and_oracle(n, k, m):
    rng = np.random.default_rng(n + k)
    A = rng.integers(0, 2, (n, n)).astype(np.uint8)
    V = rng.integers(0, 2, (m, n)).astype(np.uint8)
    lut_j = jref.gf2_preprocess(jnp.asarray(A), k)
    lut_t = tref.gf2_preprocess(torch.as_tensor(A), k)
    assert lut_t.dtype == torch.int32
    assert np.array_equal(lut_t.numpy().astype(np.uint32), np.asarray(lut_j))
    vw_j = jref.gf2_pack_vector(jnp.asarray(V), k).astype(jnp.uint32)
    vw_t = tref.gf2_pack_vector(torch.as_tensor(V), k)
    assert np.array_equal(vw_t.numpy().astype(np.uint32), np.asarray(vw_j))
    out_pallas = np.asarray(jops.gf2_bmvm(lut_j, vw_j, use_kernel=True))
    out_t = tops.gf2_bmvm(lut_t, vw_t)
    assert np.array_equal(out_t.numpy().astype(np.uint32), out_pallas)
    assert np.array_equal(tref.gf2_unpack_vector(out_t, k).numpy(),
                          np.asarray(jref.gf2_matmul_oracle(jnp.asarray(A), jnp.asarray(V))))
    assert np.array_equal(tref.gf2_matmul_oracle(torch.as_tensor(A), torch.as_tensor(V)).numpy(),
                          np.asarray(jref.gf2_matmul_oracle(jnp.asarray(A), jnp.asarray(V))))


@pytest.mark.parametrize("seed", range(5))
def test_gf2_linearity(seed):
    """A(u ⊕ v) == Au ⊕ Av through the port's LUT datapath."""
    rng = np.random.default_rng(seed)
    n, k = 32, 4
    A = torch.as_tensor(rng.integers(0, 2, (n, n)).astype(np.uint8))
    u = torch.as_tensor(rng.integers(0, 2, (1, n)).astype(np.uint8))
    v = torch.as_tensor(rng.integers(0, 2, (1, n)).astype(np.uint8))
    lut = tref.gf2_preprocess(A, k)

    def f(x):
        return tref.gf2_unpack_vector(tops.gf2_bmvm(lut, tref.gf2_pack_vector(x, k)), k)
    assert torch.equal(f(u ^ v), f(u) ^ f(v))


@pytest.mark.parametrize("k", [4, 8, 16])
def test_gf2_pack_unpack_roundtrip(k):
    rng = np.random.default_rng(7)
    v = rng.integers(0, 2, (3, 64)).astype(np.uint8)
    w = tref.gf2_pack_vector(torch.as_tensor(v), k)
    assert np.array_equal(w.numpy().astype(np.uint32),
                          np.asarray(jref.gf2_pack_vector(jnp.asarray(v), k)))
    assert np.array_equal(tref.gf2_unpack_vector(w, k).numpy(), v)
    # uint32 words (the NoC contract dtype) unpack to the same bits
    assert np.array_equal(tref.gf2_unpack_vector(w.view(torch.uint32), k).numpy(), v)


def test_gf2_preprocess_chunked_equals_unchunked(monkeypatch):
    A = torch.as_tensor(np.random.default_rng(3).integers(0, 2, (64, 64)).astype(np.uint8))
    whole = tref.gf2_preprocess(A, 8)
    monkeypatch.setattr(tref, "_PREPROCESS_CHUNK_ELEMS", 1)   # one LUT column per chunk
    assert torch.equal(tref.gf2_preprocess(A, 8), whole)


# -- LDPC min-sum -------------------------------------------------------------

@pytest.mark.parametrize("shape", MINSUM_SHAPES)
def test_minsum_matches_pallas(shape):
    rng = np.random.default_rng(shape[0])
    u = (rng.normal(size=shape) * 4).astype(np.float32)
    out_t = tops.minsum_check(torch.as_tensor(u)).numpy()
    assert np.allclose(out_t, np.asarray(jops.minsum_check(jnp.asarray(u), use_kernel=True)),
                       atol=1e-6)
    assert np.allclose(out_t, np.asarray(jref.minsum_check(jnp.asarray(u))), atol=1e-6)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("shape", [(9, 3), (50, 33), (7, 64)])
def test_minsum_half_types_bit_exact_to_pallas(dtype, shape):
    """The Pallas kernel works in u.dtype; the port's plain version (what the
    CUDA instances hold to bit for bit) gives the same bits in bf16/fp16."""
    rng = np.random.default_rng(shape[1])
    u = (rng.normal(size=shape) * 4).astype(np.float32)
    u_t = torch.as_tensor(u).to(getattr(torch, dtype))
    u_j = jnp.asarray(u_t.float().numpy()).astype(getattr(jnp, dtype))
    out_t = tops.minsum_check(u_t)
    out_j = jops.minsum_check(u_j, use_kernel=True)
    assert out_t.dtype == u_t.dtype and out_j.dtype == u_j.dtype
    assert np.array_equal(out_t.float().numpy(), np.asarray(out_j, np.float32))
    assert np.array_equal(out_t.float().numpy(), tref.minsum_check(u_t.float()).numpy())


@pytest.mark.parametrize("deg,dtype", [(3, torch.float32), (33, torch.float32),
                                       (64, torch.float32), (64, torch.bfloat16),
                                       (6, torch.float16), (1000, torch.float32),
                                       (58111, torch.float32), (116223, torch.float16)])
def test_minsum_launch_shape(deg, dtype):
    """128 check rows a block while they fit in a block's shared memory,
    fewer past that, at least one row up to max_degree, and rows placed so
    that a warp's 32 threads never share one bank (an odd number of 4-byte
    words apart, or rows that straddle words); the main path's deg = 3 rows
    stay packed."""
    rows, pitch, blocks, smem = minsum.launch_shape(1000, deg, dtype)
    assert 1 <= rows <= minsum.ROWS and blocks == -(-1000 // rows)
    assert pitch in (deg, deg + 1) and (pitch * dtype.itemsize) % 8 != 0
    assert smem == rows * pitch * dtype.itemsize <= minsum.SMEM_PER_BLOCK
    assert (rows == minsum.ROWS) == (minsum.ROWS * pitch * dtype.itemsize
                                     <= minsum.SMEM_PER_BLOCK)
    assert deg <= minsum.max_degree(dtype)
    if (deg, dtype) == (3, torch.float32):
        assert (rows, pitch, smem) == (128, 3, 1536)


def test_minsum_sign_and_tie_rules_match_reference():
    """sign(-0.0) = +1, first-index argmin on ties, infinities — bit for bit."""
    u = np.array([[-0.0, 1.0, 2.0], [1.0, 1.0, 3.0], [2.0, -2.0, 5.0],
                  [np.inf, np.inf, 5.0], [-3.0, -0.5, -0.5], [0.0, -0.0, 4.0]], np.float32)
    out_t = tref.minsum_check(torch.as_tensor(u)).numpy()
    out_j = np.asarray(jref.minsum_check(jnp.asarray(u)))
    assert np.array_equal(out_t, out_j)
    assert np.array_equal(np.signbit(out_t), np.signbit(out_j))


def test_bitnode_sum_matches_reference():
    rng = np.random.default_rng(4)
    u0 = rng.normal(size=(5,)).astype(np.float32)
    v = rng.normal(size=(5, 3)).astype(np.float32)
    tt, tu = tref.bitnode_sum(torch.as_tensor(u0), torch.as_tensor(v))
    jt, ju = jref.bitnode_sum(jnp.asarray(u0), jnp.asarray(v))
    assert np.allclose(tt.numpy(), np.asarray(jt), atol=1e-6)
    assert np.allclose(tu.numpy(), np.asarray(ju), atol=1e-6)


# -- particle filter histogram ------------------------------------------------

@pytest.mark.parametrize("N,px,B", HIST_CASES)
def test_histogram_matches_pallas(N, px, B):
    rng = np.random.default_rng(N + px)
    bins = rng.integers(0, B, (N, px)).astype(np.int32)
    w = rng.uniform(0.1, 1, (px,)).astype(np.float32)
    rh = rng.uniform(0, 1, (B,)).astype(np.float32)
    rh = rh / rh.sum()
    h_t, bc_t = tops.particle_histogram(torch.as_tensor(bins), torch.as_tensor(w),
                                        torch.as_tensor(rh))
    h_p, bc_p = jops.particle_histogram(jnp.asarray(bins), jnp.asarray(w), jnp.asarray(rh),
                                        use_kernel=True)
    h_r = jref.weighted_histogram(jnp.asarray(bins), jnp.asarray(w), B)
    for h, bc in ((h_p, bc_p), (h_r, jref.bhattacharyya(h_r, jnp.asarray(rh)))):
        assert np.allclose(h_t.numpy(), np.asarray(h), atol=1e-5)
        assert np.allclose(bc_t.numpy(), np.asarray(bc), atol=1e-5)


def test_histogram_out_of_range_bins_count_nowhere():
    bins = np.array([[0, 1, -1, 8, 3], [7, 7, 100, 2, -5]], np.int32)
    w = np.linspace(0.2, 1.0, 5).astype(np.float32)
    h_t = tref.weighted_histogram(torch.as_tensor(bins), torch.as_tensor(w), 8).numpy()
    h_j = np.asarray(jref.weighted_histogram(jnp.asarray(bins), jnp.asarray(w), 8))
    assert np.allclose(h_t, h_j, atol=1e-6)
    assert np.allclose(h_t.sum(-1), 1.0, atol=1e-6)


def test_particle_weights_matches_reference():
    rng = np.random.default_rng(5)
    bins = rng.integers(0, 8, (6, 40)).astype(np.int32)
    w = rng.uniform(0.1, 1, (40,)).astype(np.float32)
    rh = np.full(8, 1 / 8, np.float32)
    t = tref.particle_weights(torch.as_tensor(bins), torch.as_tensor(w), torch.as_tensor(rh))
    j = jref.particle_weights(jnp.asarray(bins), jnp.asarray(w), jnp.asarray(rh))
    assert np.allclose(t.numpy(), np.asarray(j), atol=1e-5)


# -- flash attention -------------------------------------------------------------

def _qkv(rng, B, Hq, Hkv, S, T, D, dtype=np.float32):
    return tuple(rng.normal(size=shape).astype(dtype)
                 for shape in ((B, Hq, S, D), (B, Hkv, T, D), (B, Hkv, T, D)))


@pytest.mark.parametrize("B,Hq,Hkv,S,T,D", FLASH_CASES)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_pallas_and_mha(B, Hq, Hkv, S, T, D, causal):
    q, k, v = _qkv(np.random.default_rng(S + T), B, Hq, Hkv, S, T, D)
    o_t = tops.flash_attention(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
                               causal, True).numpy()
    o_pallas = np.asarray(jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                               causal, True))
    o_mha = np.asarray(jref.mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    assert np.abs(o_t - o_pallas).max() <= 3e-5
    assert np.abs(o_t - o_mha).max() <= 3e-5
    o_tmha = tref.mha(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v), causal=causal)
    assert np.abs(o_tmha.numpy() - o_mha).max() <= 3e-5


def test_flash_attention_bf16_matches_pallas():
    rng = np.random.default_rng(1)
    q, k, v = _qkv(rng, 1, 2, 2, 32, 32, 16)
    to_t = [torch.as_tensor(x).bfloat16() for x in (q, k, v)]
    to_j = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    o_t = tops.flash_attention(*to_t, True, True)
    assert o_t.dtype == torch.bfloat16
    o_j = np.asarray(jops.flash_attention(*to_j, True, True), np.float32)
    assert np.abs(o_t.float().numpy() - o_j).max() <= 3e-2


def test_flash_attention_gradient_is_finite_and_matches_reference():
    """The backward recomputes through mha, as the reference's custom_vjp."""
    q, k, v = _qkv(np.random.default_rng(2), 1, 4, 2, 16, 24, 8)
    w = np.random.default_rng(3).normal(size=q.shape).astype(np.float32)
    ts = [torch.as_tensor(x).requires_grad_() for x in (q, k, v)]
    (tops.flash_attention(*ts, True, True) * torch.as_tensor(w)).sum().backward()
    grads_j = jax.grad(lambda a, b, c: jnp.sum(jops.flash_attention(a, b, c, True, True) * w),
                       argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for t, gj in zip(ts, grads_j):
        assert torch.isfinite(t.grad).all()
        assert np.abs(t.grad.numpy() - np.asarray(gj)).max() <= 1e-4


def test_flash_attention_fully_masked_rows_are_zero():
    """Causal with S > T: rows 0..S-T-1 see no key.  The port pins them to
    zeros (ref.mha gives NaN there, the Pallas kernel a padding-dependent
    value); every row that sees a key matches both references."""
    q, k, v = _qkv(np.random.default_rng(4), 1, 2, 1, 6, 2, 8)
    o_t = tops.flash_attention(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
                               True, True).numpy()
    o_mha = np.asarray(jref.mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True))
    o_pallas = np.asarray(jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                               True, True))
    blind = 6 - 2
    assert np.isnan(o_mha[:, :, :blind]).all()
    assert np.array_equal(o_t[:, :, :blind], np.zeros_like(o_t[:, :, :blind]))
    assert np.abs(o_t[:, :, blind:] - o_mha[:, :, blind:]).max() <= 3e-5
    assert np.abs(o_t[:, :, blind:] - o_pallas[:, :, blind:]).max() <= 3e-5
    o_tmha = tref.mha(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v), causal=True)
    assert torch.isnan(o_tmha[:, :, :blind]).all()


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 3e-2), (torch.float16, 3e-3)])
def test_flash_attention_half_types_match_pallas(dtype, tol):
    """bf16 and fp16 inputs: the port's wrapper takes both (the Pallas kernel
    casts any input type to float32); outputs in the input type agree within
    a step of that type."""
    q, k, v = _qkv(np.random.default_rng(6), 1, 4, 2, 40, 72, 16)
    jdt = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}[dtype]
    for causal in (True, False):
        o_t = tops.flash_attention(*(torch.as_tensor(x).to(dtype) for x in (q, k, v)), causal,
                                   True)
        assert o_t.dtype == dtype
        o_j = flash_attention_pallas(*(jnp.asarray(x, jdt) for x in (q, k, v)), causal=causal,
                                     interpret=True)
        assert o_j.dtype == jdt
        assert np.abs(o_t.float().numpy() - np.asarray(o_j, np.float32)).max() <= tol


# -- the split-keys path: partials and their combine -------------------------------

SPLIT_CASES = [(1, 8, 2, 37, 450, 16), (2, 8, 2, 130, 200, 24)]


def _split_plain(q, k, v, causal, n_split):
    parts = [flash_attention.flash_attention_partial_plain(q, k, v, causal, lo, hi)
             for lo, hi in flash_attention.key_ranges(k.shape[2], n_split)]
    return flash_attention.flash_attention_combine_plain(*(torch.stack(x) for x in zip(*parts)))


@pytest.mark.parametrize("B,Hq,Hkv,S,T,D", SPLIT_CASES)
@pytest.mark.parametrize("n_split", [1, 2, 3, 7])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_split_keys_match_plain_and_pallas(B, Hq, Hkv, S, T, D, n_split,
                                                           causal):
    """The combine of the key ranges' partials equals the whole-matrix plain
    version within 3e-5 (GQA 8:2, ragged S and T, empty splits when n_split
    exceeds the key tiles), and the Pallas kernel on rows that see a key."""
    q, k, v = _qkv(np.random.default_rng(S + T + n_split), B, Hq, Hkv, S, T, D)
    qt, kt, vt = (torch.as_tensor(x) for x in (q, k, v))
    out = _split_plain(qt, kt, vt, causal, n_split).numpy()
    assert np.abs(out - flash_attention.flash_attention_plain(qt, kt, vt, causal).numpy()
                  ).max() <= 3e-5
    o_pallas = np.asarray(flash_attention_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                                 causal=causal, interpret=True))
    seen = max(S - T, 0) if causal else 0
    assert np.abs(out[:, :, seen:] - o_pallas[:, :, seen:]).max() <= 3e-5


def test_flash_attention_blind_splits_add_nothing():
    """Causal with S > T: the third split is empty, the second is blind to
    the first 228 rows and every split is blind to the first S - T = 100; those
    rows come out exactly zero and the rest match the plain version."""
    q, k, v = (torch.as_tensor(x) for x in _qkv(np.random.default_rng(8), 1, 4, 2, 300, 200, 8))
    assert flash_attention.key_ranges(200, 3) == [(0, 128), (128, 200), (200, 200)]
    m, l, acc = flash_attention.flash_attention_partial_plain(q, k, v, True, 200, 200)
    assert (m == flash_attention.MASK_VALUE).all() and not l.any() and not acc.any()
    out = _split_plain(q, k, v, True, 3)
    assert torch.equal(out[:, :, :100], torch.zeros_like(out[:, :, :100]))
    assert (out[:, :, 100:].abs().sum(-1) > 0).all()
    assert torch.allclose(out, flash_attention.flash_attention_plain(q, k, v, True), atol=3e-5,
                          rtol=0)


@pytest.mark.parametrize("B,Hq,S,T", [(4, 20, 1500, 1500), (4, 20, 32, 1500), (1, 1, 37, 37),
                                      (1, 2, 5, 300), (1, 1, 1, 100000), (64, 64, 2048, 64)])
def test_num_splits(B, Hq, S, T):
    """One split where the blocks fill the card (whisper's encoder), more for
    whisper's cross-attention, never more than one wave of blocks or than the
    key tiles, and no split left empty."""
    n = flash_attention.num_splits(B, Hq, S, T, 132)
    tiles = -(-T // flash_attention.KEY_TILE)
    assert 1 <= n <= min(tiles, flash_attention.MAX_SPLITS)
    assert all(lo < hi for lo, hi in flash_attention.key_ranges(T, n))
    blocks = B * Hq * -(-S // flash_attention.ROWS_PER_BLOCK)
    assert n * blocks <= max(blocks, 2 * 132)          # one wave of two blocks per SM
    if (B, Hq, S, T) == (4, 20, 1500, 1500) or blocks >= 2 * 132:
        assert n == 1
    if (B, Hq, S, T) == (4, 20, 32, 1500):
        assert n == 3                                   # 80 blocks -> 240


# -- launch shapes of the case-study kernels --------------------------------------

BMVM_SHAPES = [(64, 512, 512), (1, 512, 512), (1, 1, 1), (64, 1, 5), (5, 37, 3), (1, 300, 512),
               (64, 300, 512), (64, 1000, 512), (4096, 512, 512), (1, 100000, 512),
               (64, 2048, 2048), (3, 20000, 7)]


@pytest.mark.parametrize("M,C,R", BMVM_SHAPES)
def test_bmvm_launch_shape_covers_c_and_r_once(M, C, R):
    """The chunks tile [0, C) and the R tiles [0, R) exactly once, no block
    is empty, and the chunks of one (m, R tile) make one portable cluster."""
    chunk, n_chunks = gf2_bmvm.launch_shape(M, C, R, 132)
    assert chunk >= gf2_bmvm.MIN_CHUNK and chunk % gf2_bmvm.MIN_CHUNK == 0
    assert 1 <= n_chunks <= gf2_bmvm.MAX_CHUNKS
    seen = np.zeros(C, np.int64)
    for i in range(n_chunks):
        lo, hi = i * chunk, min((i + 1) * chunk, C)
        assert lo < hi
        seen[lo:hi] += 1
    assert (seen == 1).all()
    r_tiles = -(-R // gf2_bmvm.R_TILE)
    words = np.zeros(R, np.int64)
    for z in range(r_tiles):
        for t in range(gf2_bmvm.THREADS):
            r = z * gf2_bmvm.R_TILE + 4 * t
            words[r:min(r + 4, R)] += 1
    assert (words == 1).all()


@pytest.mark.parametrize("sm_count", [114, 132])
def test_bmvm_launch_shape_fills_the_card_at_the_main_shape(sm_count):
    """BMVM n=4096, k=8, M=64 (LUT (512, 256, 512)): at least one block per
    SM, chunks of whole unrolled batches, no more blocks than the target."""
    chunk, n_chunks = gf2_bmvm.launch_shape(64, 512, 512, sm_count)
    blocks = 64 * n_chunks
    assert sm_count <= blocks <= gf2_bmvm.BLOCKS_PER_SM * sm_count
    assert chunk % gf2_bmvm.MIN_CHUNK == 0
    assert (chunk, n_chunks) == (64, 8)                  # 128 blocks of 256 -> 512 of 128


@pytest.mark.parametrize("M,C,R", [(1, 1, 1), (1, 1, 4), (1, 7, 1)])
def test_bmvm_launch_shape_degenerate_sizes(M, C, R):
    chunk, n_chunks = gf2_bmvm.launch_shape(M, C, R, 132)
    assert n_chunks == 1 and chunk >= C


HIST_SHAPES = [(4096, 4096, 16), (1, 1, 1), (1, 3, 7), (5, 517, 32), (4096, 517, 7),
               (100000, 4096, 32), (10, 50176, 16), (4096, 24576, 16), (4096, 24577, 16),
               (3, 0, 4), (4096, 4096, 33), (4096, 4096, 64), (100, 4096, 256),
               (7, 24577, 300), (5, 517, 1816)]


@pytest.mark.parametrize("N,px,n_bins", HIST_SHAPES)
def test_histogram_launch_shape_covers_each_particle_once(N, px, n_bins):
    """Warp (b, w) walks particles b * warps + w + k * blocks * warps: every
    particle once; the block's shared memory holds the per-lane columns of
    as many warps (up to WARPS) as fit and, when staged, w, and fits a block."""
    blocks, warps, smem, stage_w = histogram.launch_shape(N, px, n_bins, 132)
    assert 1 <= blocks <= 2 ** 31 - 1
    cols = warps * 32 * n_bins * 4
    assert warps == min(histogram.WARPS, histogram.SMEM_PER_BLOCK // (32 * n_bins * 4))
    stride = blocks * warps
    seen = np.zeros(N, np.int64)
    for n0 in range(min(stride, N)):
        seen[n0::stride] += 1
    assert (seen == 1).all()
    assert stage_w == (px * 4 <= histogram.MAX_STAGED_W
                       and cols + px * 4 <= histogram.SMEM_PER_BLOCK)
    assert smem == cols + (px * 4 if stage_w else 0)
    assert smem <= histogram.SMEM_PER_BLOCK
    assert smem + histogram.SMEM_PER_BLOCK_RESERVED <= histogram.SMEM_PER_SM


@pytest.mark.parametrize("sm_count", [114, 132])
def test_histogram_launch_shape_fills_the_card_at_the_main_shape(sm_count):
    """Particle filter 4096 particles of a 64x64 ROI, 16 bins: w staged, all
    blocks resident at once (by registers and shared memory), one warp per
    particle where the card holds 512 blocks (132 SMs), at most two where it
    does not (114)."""
    blocks, warps, smem, stage_w = histogram.launch_shape(4096, 4096, 16, sm_count)
    assert warps == histogram.WARPS and smem == 32 * 1024
    per_sm = min(histogram.MIN_BLOCKS_PER_SM,
                 histogram.SMEM_PER_SM // (smem + histogram.SMEM_PER_BLOCK_RESERVED))
    assert stage_w and sm_count <= blocks <= per_sm * sm_count
    assert -(-4096 // (blocks * histogram.WARPS)) == (1 if sm_count == 132 else 2)


@pytest.mark.parametrize("N", [1, 7, 8, 9])
def test_histogram_launch_shape_degenerate_sizes(N):
    blocks, warps, _, _ = histogram.launch_shape(N, 64, 8, 132)
    assert warps == histogram.WARPS and blocks == -(-N // histogram.WARPS)


# -- the limits that remain ----------------------------------------------------------

def _no_device_check(monkeypatch):
    monkeypatch.setattr(_build, "check_cuda_tensor", lambda *a, **k: None)


def test_histogram_refuses_more_bins_than_a_block_holds(monkeypatch):
    """Planned divergence: the reference takes any n_bins; the kernel takes
    up to MAX_BINS = 1816 (one warp's per-lane columns fill a block)."""
    _no_device_check(monkeypatch)
    assert histogram.MAX_BINS == 1816
    bins, w = torch.zeros((2, 8), dtype=torch.int32), torch.ones(8)
    histogram._check(bins, w, torch.ones(1816), 1816)
    with pytest.raises(ValueError, match="n_bins <= 1816"):
        histogram._check(bins, w, torch.ones(1817), 1817)


def test_minsum_refuses_a_row_larger_than_a_block(monkeypatch):
    """Planned divergence: one check row must fit a block's shared memory."""
    _no_device_check(monkeypatch)
    minsum._check(torch.zeros((2, 58111)))
    minsum._check(torch.zeros((2, 116223), dtype=torch.bfloat16))
    with pytest.raises(ValueError, match=r"\[1, 58111\]"):
        minsum._check(torch.zeros((2, 58112)))
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        minsum._check(torch.zeros((2, 3), dtype=torch.float64))


def test_flash_attention_refuses_head_dims_past_256(monkeypatch):
    """Planned divergence: no registered config has D > 256 (gemma-7b has 256)."""
    _no_device_check(monkeypatch)
    q = torch.zeros((1, 2, 4, 256))
    flash_attention._check(q, q, q)
    q = torch.zeros((1, 2, 4, 264))
    with pytest.raises(ValueError, match=r"\[1, 256\]"):
        flash_attention._check(q, q, q)


@pytest.mark.parametrize("D,f32,half", [(8, "f32_g1", "tc64"), (64, "f32_g2", "tc64"),
                                        (100, "f32_g4", "tc128"), (128, "f32_g4", "tc128"),
                                        (160, "f32_g8", "tc256"), (256, "f32_g8", "tc256")])
def test_flash_attention_instance_is_chosen_by_shape(D, f32, half):
    assert flash_attention.instance(torch.float32, D) == f32
    assert flash_attention.instance(torch.bfloat16, D) == flash_attention.instance(
        torch.float16, D) == half


def test_num_splits_at_wide_head_dims():
    """gemma-7b-like (1, 16, 1024, 1024) at D = 256: the 128 blocks, one an SM,
    already fill 132 SMs, so no split and no combine; at D = 64 two blocks fit
    an SM and the keys split in two."""
    assert flash_attention.num_splits(1, 16, 1024, 1024, 132, 256) == 1
    assert flash_attention.num_splits(1, 16, 1024, 1024, 132, 64) == 2
    assert flash_attention.num_splits(4, 20, 32, 1500, 132, 256) == 1


# -- wrappers: routing, checks, counters ----------------------------------------

def _sample_args():
    rng = np.random.default_rng(0)
    lut = tref.gf2_preprocess(torch.as_tensor(rng.integers(0, 2, (32, 32)).astype(np.uint8)), 4)
    vw = tref.gf2_pack_vector(torch.as_tensor(rng.integers(0, 2, (3, 32)).astype(np.uint8)), 4)
    u = torch.as_tensor(rng.normal(size=(9, 3)).astype(np.float32))
    bins = torch.as_tensor(rng.integers(0, 8, (4, 50)).astype(np.int32))
    w = torch.ones(50)
    rh = torch.full((8,), 1 / 8)
    q, k, v = (torch.as_tensor(x) for x in _qkv(rng, 1, 2, 1, 5, 7, 8))
    return lut, vw, u, bins, w, rh, q, k, v


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    lut, vw, u, bins, w, rh, q, k, v = _sample_args()
    tops.reset_launch_counts()
    assert torch.equal(tops.gf2_bmvm(lut, vw), gf2_bmvm.gf2_bmvm_plain(lut, vw))
    assert torch.equal(tops.minsum_check(u), minsum.minsum_check_plain(u))
    h, bc = tops.particle_histogram(bins, w, rh)
    hp, bcp = histogram.particle_histogram_plain(bins, w, rh, 8)
    assert torch.equal(h, hp) and torch.equal(bc, bcp)
    assert torch.equal(tops.flash_attention(q, k, v, True, True),
                       flash_attention.flash_attention_plain(q, k, v, True))
    assert tops.launch_counts() == {"gf2_bmvm": 0, "minsum_check": 0,
                                    "particle_histogram": 0, "flash_attention": 0}


def test_use_kernel_false_selects_the_plain_version():
    lut, vw, u, bins, w, rh, q, k, v = _sample_args()
    assert torch.equal(tops.gf2_bmvm(lut, vw, use_kernel=False), tref.gf2_bmvm(lut, vw))
    assert torch.equal(tops.minsum_check(u, use_kernel=False), tref.minsum_check(u))
    h, _ = tops.particle_histogram(bins, w, rh, use_kernel=False)
    assert torch.equal(h, tref.weighted_histogram(bins, w, 8))
    assert torch.equal(tops.flash_attention(q, k, v), tref.mha(q, k, v))


@pytest.mark.parametrize("call", ["gf2_bmvm", "minsum_check", "particle_histogram",
                                  "flash_attention"])
def test_wrappers_do_not_fall_back_off_the_cpu(call):
    """A tensor that is neither on the CPU nor on a GPU is refused, never
    quietly computed with the plain version."""
    lut, vw, u, bins, w, rh, q, k, v = (t.to("meta") for t in _sample_args())
    fn = {"gf2_bmvm": lambda: gf2_bmvm.gf2_bmvm(lut, vw),
          "minsum_check": lambda: minsum.minsum_check(u),
          "particle_histogram": lambda: histogram.particle_histogram(bins, w, rh, 8),
          "flash_attention": lambda: flash_attention.flash_attention(q, k, v)}[call]
    with pytest.raises(ValueError, match="CUDA tensor"):
        fn()


def test_check_cuda_tensor_rejects_cpu_tensor():
    with pytest.raises(ValueError, match="CUDA tensor"):
        _build.check_cuda_tensor("x", torch.zeros(3, 3), torch.float32, 2)


def test_check_cuda_tensor_rejects_non_tensor():
    with pytest.raises(TypeError):
        _build.check_cuda_tensor("x", np.zeros(3), torch.float32, 1)


def test_build_uses_nvcc_for_sm90a(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "nvcc", lambda: "nvcc")
    cmd = _build.build_command(tmp_path / "lib.so")
    assert cmd[0] == "nvcc" and "arch=compute_90a,code=sm_90a" in cmd
    assert {"-shared", "-O3"} <= set(cmd) and cmd[-1] == str(_build.SOURCE)
    assert _build.SOURCE.is_file()
    src = _build.SOURCE.read_text()
    for name in _build._SIGNATURES:
        assert f"int {name}(" in src


def test_missing_nvcc_raises(monkeypatch):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(_build.Path, "is_file", lambda self: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()


# -- import hygiene --------------------------------------------------------------

def _imports(path: pathlib.Path) -> set[str]:
    mods = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            mods.add(node.module.split(".")[0])
        elif isinstance(node, ast.ImportFrom) and node.level >= 3:
            mods.add("<outside the package>")   # from ...x climbs out of repro_torch
    return mods


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in
    list((REPO / "src" / "repro_torch").rglob("*.py")) + list((REPO / "scripts").glob("*.py"))
    + [REPO / "chip_smoke.py"]))
def test_port_imports_neither_jax_nor_repro(path):
    mods = _imports(REPO / path)
    assert not mods & {"jax", "jaxlib", "repro", "<outside the package>"}, (path, mods)
