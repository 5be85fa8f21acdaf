"""Case study I (paper §IV): LDPC min-sum decoding on the NoC, on the
PyTorch/CUDA port.

    PYTHONPATH=src python examples/ldpc_decode_torch.py [--device cpu]

Reproduces the paper's setup: the N=7 projective-geometry (Fano plane) code,
bit/check node PEs wrapped and placed on a 4×4 mesh CONNECT-style NoC
(Fig. 9), including the 2-FPGA partition (the dotted arc) — and then the
scalable vectorized decoder with a BER-vs-SNR sweep, whose check-node updates
run the hand-written ``minsum_check`` CUDA kernel (4 SNRs × 12 iterations =
48 launches on the card).  Runs on the GPU unless ``--device cpu`` is given.
"""
import argparse

import numpy as np

from repro_torch import resolve_device
from repro_torch.apps import ldpc
from repro_torch.core import NoCConfig, wrapper_overhead


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rng = np.random.default_rng(0)
    H = ldpc.fano_plane_H()
    print("PG(2,2) Fano-plane H (paper's N=7, degree-3 code):")
    print(H)

    # --- Table I analog: per-node cost without/with the NoC wrapper -------------
    g, _ = ldpc.build_ldpc_graph(H)
    rows = wrapper_overhead(g, NoCConfig(flit_data_width=16, flit_buffer_depth=8))
    print("\nTable-I analog (bytes instead of LUTs/registers):")
    for r in rows[:4]:
        print(f"  {r['pe']:6s} raw={r['wo_wrapper_bytes']:4d}B "
              f"wrapped={r['with_wrapper_bytes']:4d}B overhead={r['overhead']:+.2f}x")

    # --- Fig. 9: decode on a 4x4 mesh NoC, then cut across 2 FPGAs --------------
    llr = ldpc.awgn_llr(np.zeros(7, np.int8), snr_db=2.0, rng=rng)
    bits, post, stats = ldpc.decode_on_noc(H, llr, n_iters=10, topology="mesh",
                                           n_nodes=16, device=dev)
    print(f"\nsingle-FPGA 4x4 mesh: decoded={bits} "
          f"(rounds={stats.rounds}, flits={stats.flits})")
    bits2, post2, st2 = ldpc.decode_on_noc(H, llr, 10, pods=[0] * 8 + [1] * 8, device=dev)
    assert np.array_equal(bits, bits2)
    print(f"2-FPGA partition (dotted arc): identical decode; "
          f"cross-chip msgs={st2.cross_pod_msgs}, wire bytes={st2.cross_pod_wire_bytes}")

    # --- scalable vectorized decoder + BER sweep ---------------------------------
    print("\nBER sweep (vectorized min-sum kernel, 56-bit code, 200 frames/SNR):")
    Hbig = ldpc.pg_ldpc_H(copies=8)
    idx = ldpc.build_edge_index(Hbig)
    for snr in (1.0, 2.0, 3.0, 4.0):
        errs_c = errs_u = 0
        n_frames = 200
        llrs = np.stack([ldpc.awgn_llr(np.zeros(56, np.int8), snr, rng)
                         for _ in range(n_frames)])
        dec, _ = ldpc.decode_minsum(idx, llrs, 12, device=dev)
        errs_c = int(dec.sum())
        errs_u = int((llrs < 0).sum())
        print(f"  SNR {snr:3.1f} dB: uncoded BER {errs_u / llrs.size:.4f}  "
              f"coded BER {errs_c / llrs.size:.4f}")


if __name__ == "__main__":
    main()
