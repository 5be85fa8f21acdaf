"""The three case studies on the port against the reference, on the CPU:
BMVM bit for bit (kernel datapath and NoC), LDPC posteriors within 1e-4
(vectorized and NoC), particle-filter tracks within 1e-3 given the reference's
own noise draws; the conversions of the reference's state; and the rule that
the entry points never fall back to the CPU when no GPU is present."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.apps import bmvm as jbmvm  # noqa: E402
from repro.apps import ldpc as jldpc  # noqa: E402
from repro.apps import particle_filter as jpf  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.apps import bmvm as tbmvm  # noqa: E402
from repro_torch.apps import ldpc as tldpc  # noqa: E402
from repro_torch.apps import particle_filter as tpf  # noqa: E402

CPU = "cpu"


def reference_noise(cfg, n_frames):
    """The reference tracker's motion draws (key → split → normal), per frame."""
    key = jax.random.key(cfg.seed)
    out = []
    for _ in range(1, n_frames):
        key, k = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(k, (cfg.n_particles, 2))))
    return out


# -- BMVM (§VI) ------------------------------------------------------------------

@pytest.mark.parametrize("n,k,f,r", [(32, 4, 1, 1), (32, 4, 2, 3), (64, 8, 2, 2),
                                     (64, 4, 4, 5), (128, 8, 1, 2)])
def test_bmvm_iterate_kernel_bit_equal_to_reference(n, k, f, r):
    rng = np.random.default_rng(n + r)
    A = rng.integers(0, 2, (n, n)).astype(np.uint8)
    V = rng.integers(0, 2, (3, n)).astype(np.uint8)
    tcfg, jcfg = tbmvm.BMVMConfig(n=n, k=k, fold=f), jbmvm.BMVMConfig(n=n, k=k, fold=f)
    lut_t = tbmvm.preprocess(A, tcfg, device=CPU)
    lut_j = jbmvm.preprocess(A, jcfg)
    assert np.array_equal(convert.lut_to_numpy(lut_t), np.asarray(lut_j))
    ref_out = np.asarray(jbmvm.iterate_kernel(lut_j, jnp.asarray(V), jcfg, r))
    for use_kernel in (True, False):
        out = tbmvm.iterate_kernel(lut_t, V, tcfg, r, use_kernel=use_kernel, device=CPU)
        assert np.array_equal(out.numpy(), ref_out)
    assert np.array_equal(tbmvm.software_ref(A, V, r, device=CPU), jbmvm.software_ref(A, V, r))


@pytest.mark.parametrize("topo", ["ring", "mesh", "torus", "fattree"])
def test_bmvm_noc_matches_reference(topo):
    rng = np.random.default_rng(0)
    A = rng.integers(0, 2, (64, 64)).astype(np.uint8)
    v = rng.integers(0, 2, (64,)).astype(np.uint8)
    tcfg, jcfg = tbmvm.BMVMConfig(n=64, k=8, fold=2), jbmvm.BMVMConfig(n=64, k=8, fold=2)
    out, st = tbmvm.iterate_noc_sim(tbmvm.preprocess(A, tcfg, device=CPU), v, tcfg, 3,
                                    topology=topo, device=CPU)
    out_j, st_j = jbmvm.iterate_noc_sim(jbmvm.preprocess(A, jcfg), v, jcfg, 3, topology=topo)
    assert np.array_equal(out, out_j)
    assert np.array_equal(out.reshape(1, -1), jbmvm.software_ref(A, v[None], 3))
    assert st.as_dict() == st_j.as_dict()


def test_bmvm_noc_greedy_placement_and_direct_mode():
    rng = np.random.default_rng(1)
    A = rng.integers(0, 2, (32, 32)).astype(np.uint8)
    v = rng.integers(0, 2, (32,)).astype(np.uint8)
    cfg = tbmvm.BMVMConfig(n=32, k=4, fold=2)
    lut = tbmvm.preprocess(A, cfg, device=CPU)
    expect = jbmvm.software_ref(A, v[None], 2)
    out_g, st_g = tbmvm.iterate_noc_sim(lut, v, cfg, 2, placement="greedy", device=CPU)
    out_d, st_d = tbmvm.iterate_noc_sim(lut, v, cfg, 2, mode="direct", device=CPU)
    jcfg = jbmvm.BMVMConfig(n=32, k=4, fold=2)
    _, st_gj = jbmvm.iterate_noc_sim(jbmvm.preprocess(A, jcfg), v, jcfg, 2, placement="greedy")
    assert np.array_equal(out_g.reshape(1, -1), expect)
    assert np.array_equal(out_d.reshape(1, -1), expect)
    assert st_g.as_dict() == st_gj.as_dict() and st_d.rounds == 0


# -- LDPC (§IV) -------------------------------------------------------------------

@pytest.mark.parametrize("copies,batch,iters", [(1, 1, 8), (1, 5, 10), (4, 6, 12), (8, 3, 5)])
def test_ldpc_decode_minsum_matches_reference(copies, batch, iters):
    rng = np.random.default_rng(copies * 10 + batch)
    H = tldpc.pg_ldpc_H(copies=copies)
    assert np.array_equal(H, jldpc.pg_ldpc_H(copies=copies))
    llr = np.stack([tldpc.awgn_llr(np.zeros(H.shape[1], np.int8), 3.0, rng)
                    for _ in range(batch)])
    idx_j = jldpc.build_edge_index(H)
    idx_t = convert.edge_index_to_torch(dataclasses.asdict(idx_j))
    bits_j, post_j = jldpc.decode_minsum(idx_j, jnp.asarray(llr), iters)
    for use_kernel in (True, False):
        bits_t, post_t = tldpc.decode_minsum(idx_t, llr, iters, use_kernel=use_kernel, device=CPU)
        assert np.allclose(post_t.numpy(), np.asarray(post_j), atol=1e-4)
        assert np.array_equal(bits_t.numpy(), np.asarray(bits_j))
    # a single codeword keeps its (N,) shape
    b1, p1 = tldpc.decode_minsum(idx_t, llr[0], iters, device=CPU)
    assert b1.shape == (H.shape[1],) and np.allclose(p1.numpy(), np.asarray(post_j)[0], atol=1e-4)


@pytest.mark.parametrize("topology,n_nodes,placement", [("mesh", 16, "rr"), ("torus", 16, "rr"),
                                                        ("ring", 8, "greedy")])
def test_ldpc_decode_on_noc_matches_reference(topology, n_nodes, placement):
    rng = np.random.default_rng(2)
    H = tldpc.fano_plane_H()
    llr = tldpc.awgn_llr(np.zeros(7, np.int8), 2.0, rng)
    bits, post, st = tldpc.decode_on_noc(H, llr, 8, topology=topology, n_nodes=n_nodes,
                                         placement=placement, device=CPU)
    bits_j, post_j, st_j = jldpc.decode_on_noc(H, llr, 8, topology=topology, n_nodes=n_nodes,
                                               placement=placement)
    assert np.allclose(post, post_j, atol=1e-4) and np.array_equal(bits, bits_j)
    assert st.as_dict() == st_j.as_dict()
    # and the vectorized datapath agrees with the NoC one
    _, post_vec = tldpc.decode_minsum(tldpc.build_edge_index(H), llr, 8, device=CPU)
    assert np.allclose(post_vec.numpy(), post, atol=1e-4)


def test_ldpc_corrects_errors():
    """Coded BER < uncoded BER over AWGN at moderate SNR."""
    rng = np.random.default_rng(0)
    H = tldpc.pg_ldpc_H(copies=8)
    idx = tldpc.build_edge_index(H)
    llr = np.stack([tldpc.awgn_llr(np.zeros(H.shape[1], np.int8), 3.0, rng) for _ in range(40)])
    dec, _ = tldpc.decode_minsum(idx, llr, 12, device=CPU)
    assert int(dec.sum()) < int((llr < 0).sum())


def test_ldpc_tables_and_channel_match_reference():
    H = tldpc.pg_ldpc_H(copies=3)
    it, ij = tldpc.build_edge_index(H), jldpc.build_edge_index(H)
    for f in ("H", "check_edges", "bit_edges", "edge_bit"):
        assert np.array_equal(getattr(it, f), getattr(ij, f))
    assert it.n_edges == ij.n_edges
    a = tldpc.awgn_llr(np.zeros(21, np.int8), 3.0, np.random.default_rng(9))
    b = jldpc.awgn_llr(np.zeros(21, np.int8), 3.0, np.random.default_rng(9))
    assert np.array_equal(a, b)


# -- particle filter (§V) ----------------------------------------------------------

def test_pf_building_blocks_match_reference():
    cfg_t = tpf.PFConfig(img=48, roi=12, n_particles=32, n_bins=12)
    cfg_j = jpf.PFConfig(img=48, roi=12, n_particles=32, n_bins=12)
    frames, centers = tpf.synth_video(cfg_t, 3, np.random.default_rng(4))
    frames_j, centers_j = jpf.synth_video(cfg_j, 3, np.random.default_rng(4))
    assert np.array_equal(frames, frames_j) and np.array_equal(centers, centers_j)
    assert np.array_equal(tpf.distance_weights(cfg_t, CPU).numpy(),
                          np.asarray(jpf.distance_weights(cfg_j)))
    parts = np.random.default_rng(5).uniform(0, 47.9, (32, 2)).astype(np.float32)
    bins_t = tpf._roi_bins(torch.as_tensor(frames[1]), torch.as_tensor(parts), cfg_t)
    bins_j = jpf._roi_bins(jnp.asarray(frames[1]), jnp.asarray(parts), cfg_j)
    assert np.array_equal(bins_t.numpy(), np.asarray(bins_j))
    c = np.array([20.7, 11.2], np.float32)
    h_t = tpf.reference_histogram(torch.as_tensor(frames[0]), torch.as_tensor(c), cfg_t)
    h_j = jpf.reference_histogram(jnp.asarray(frames[0]), jnp.asarray(c), cfg_j)
    assert np.allclose(h_t.numpy(), np.asarray(h_j), atol=1e-6)
    rh = convert.ref_hist_to_torch(np.asarray(h_j), device=CPU)
    assert np.array_equal(convert.ref_hist_to_numpy(rh), np.asarray(h_j))


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_pf_track_matches_reference_given_its_noise(use_kernel, seed):
    cfg_t = tpf.PFConfig(img=48, roi=12, n_particles=32, n_bins=12, seed=seed)
    cfg_j = jpf.PFConfig(img=48, roi=12, n_particles=32, n_bins=12, seed=seed)
    frames, _ = tpf.synth_video(cfg_t, 6, np.random.default_rng(seed))
    noise = reference_noise(cfg_j, len(frames))
    est = tpf.track(frames, cfg_t, use_kernel=use_kernel, noise=noise, device=CPU)
    est_j = jpf.track(frames, cfg_j, use_kernel=use_kernel)
    assert np.abs(est - est_j).max() < 1e-3


def test_pf_track_on_noc_matches_reference_given_its_noise():
    cfg_t = tpf.PFConfig(img=48, roi=12, n_particles=32, n_bins=12)
    cfg_j = jpf.PFConfig(img=48, roi=12, n_particles=32, n_bins=12)
    frames, _ = tpf.synth_video(cfg_t, 6, np.random.default_rng(0))
    noise = reference_noise(cfg_j, len(frames))
    est, st = tpf.track_on_noc(frames, cfg_t, n_pe=4, n_nodes=8, noise=noise, device=CPU)
    est_j, st_j = jpf.track_on_noc(frames, cfg_j, n_pe=4, n_nodes=8)
    assert np.abs(est - est_j).max() < 1e-3
    assert st.as_dict() == st_j.as_dict() and st.flits > 0


def test_pf_noc_matches_direct_with_default_noise():
    """Without given noise both trackers draw the same seeded stream."""
    cfg = tpf.PFConfig(img=48, roi=12, n_particles=32, n_bins=12)
    frames, truth = tpf.synth_video(cfg, 8, np.random.default_rng(0))
    est = tpf.track(frames, cfg, use_kernel=False, device=CPU)
    est_noc, _ = tpf.track_on_noc(frames, cfg, n_pe=4, n_nodes=8, device=CPU)
    assert np.abs(est - est_noc).max() < 1e-3
    assert np.linalg.norm(est - truth, axis=1).mean() < 6.0


def test_pf_noise_is_validated():
    cfg = tpf.PFConfig(img=32, roi=8, n_particles=8)
    frames = np.zeros((3, 32, 32), np.float32)
    with pytest.raises(ValueError, match="noise"):
        tpf.track(frames, cfg, noise=[np.zeros((8, 2))], device=CPU)


# -- conversions ---------------------------------------------------------------------

def test_convert_roundtrips():
    rng = np.random.default_rng(3)
    lut = np.asarray(jbmvm.preprocess(rng.integers(0, 2, (32, 32)).astype(np.uint8),
                                      jbmvm.BMVMConfig(n=32, k=4)))
    lt = convert.lut_to_torch(lut, device=CPU)
    assert lt.dtype == torch.int32 and np.array_equal(convert.lut_to_numpy(lt), lut)
    with pytest.raises(TypeError):
        convert.lut_to_torch(lut.astype(np.int64), device=CPU)
    idx = jldpc.build_edge_index(jldpc.pg_ldpc_H(copies=2))
    back = convert.edge_index_to_numpy(convert.edge_index_to_torch(dataclasses.asdict(idx)))
    for k, v in dataclasses.asdict(idx).items():
        assert np.array_equal(back[k], v)
    st = dict(jbmvm.iterate_noc_sim(jbmvm.preprocess(np.eye(16, dtype=np.uint8),
                                                     jbmvm.BMVMConfig(n=16, k=4, fold=1)),
                                    np.ones(16, np.uint8), jbmvm.BMVMConfig(n=16, k=4, fold=1),
                                    1)[1].as_dict())
    assert convert.stats_to_numpy(convert.stats_to_torch(st)) == st
    with pytest.raises(KeyError):
        convert.stats_to_torch({"waves": 1})


# -- no GPU: the default device raises, never falls back -----------------------------

def _default_device_calls():
    cfg = tbmvm.BMVMConfig(n=16, k=4, fold=1)
    eye = np.eye(16, dtype=np.uint8)
    lut = tbmvm.preprocess(eye, cfg, device=CPU)
    pcfg = tpf.PFConfig(img=32, roi=8, n_particles=8)
    frames = np.zeros((2, 32, 32), np.float32)
    g, _ = tldpc.build_ldpc_graph(tldpc.fano_plane_H())
    return {
        "bmvm.preprocess": lambda: tbmvm.preprocess(eye, cfg),
        "bmvm.software_ref": lambda: tbmvm.software_ref(eye, eye[:1], 1),
        "bmvm.iterate_kernel": lambda: tbmvm.iterate_kernel(lut, eye[:1], cfg, 1),
        "bmvm.iterate_noc_sim": lambda: tbmvm.iterate_noc_sim(lut, eye[0], cfg, 1),
        "ldpc.decode_minsum": lambda: tldpc.decode_minsum(
            tldpc.build_edge_index(tldpc.fano_plane_H()), np.ones(7, np.float32), 1),
        "ldpc.decode_on_noc": lambda: tldpc.decode_on_noc(tldpc.fano_plane_H(),
                                                          np.ones(7, np.float32), 1),
        "pf.track": lambda: tpf.track(frames, pcfg),
        "pf.track_on_noc": lambda: tpf.track_on_noc(frames, pcfg),
        "pf.distance_weights": lambda: tpf.distance_weights(pcfg),
        "NoCExecutor": lambda: tcore.NoCExecutor(g, tcore.make_topology("mesh", 16)),
        "convert.lut_to_torch": lambda: convert.lut_to_torch(convert.lut_to_numpy(lut)),
    }


DEFAULT_DEVICE_ENTRIES = [
    "bmvm.preprocess", "bmvm.software_ref", "bmvm.iterate_kernel", "bmvm.iterate_noc_sim",
    "ldpc.decode_minsum", "ldpc.decode_on_noc", "pf.track", "pf.track_on_noc",
    "pf.distance_weights", "NoCExecutor", "convert.lut_to_torch"]


def test_default_device_entries_cover_the_calls():
    assert sorted(_default_device_calls()) == sorted(DEFAULT_DEVICE_ENTRIES)


@pytest.mark.parametrize("entry", DEFAULT_DEVICE_ENTRIES)
def test_default_device_raises_without_gpu(entry):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _default_device_calls()[entry]()
