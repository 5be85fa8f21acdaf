"""Case study III (paper §VI): Williams sub-quadratic GF(2) BMVM — the
topology study (Table V) and the iterated-product speedup (Table IV), on the
PyTorch/CUDA port.

    PYTHONPATH=src python examples/gf2_bmvm_topologies_torch.py [--device cpu]

Table IV's "hardware" column times ``bmvm.iterate_kernel`` — the hand-written
``gf2_bmvm`` CUDA kernel launched r times on the card (on ``--device cpu`` the
same call takes the kernel's plain version).  Its "software" column is the
paper's multithreaded-software baseline: ``bmvm.software_ref`` on the host
CPU, whatever ``--device`` says, as the reference computes it in numpy.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.apps import bmvm
from repro_torch.core import compare


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    rng = np.random.default_rng(0)

    # --- Table IV analog: speedup vs iterations (n=64, k=8, fold=2, 4 PEs) ------
    cfg = bmvm.BMVMConfig(n=64, k=8, fold=2)
    A = rng.integers(0, 2, (64, 64)).astype(np.uint8)
    V = rng.integers(0, 2, (4, 64)).astype(np.uint8)
    lut = bmvm.preprocess(A, cfg, device=dev)
    print(f"Table-IV analog: n=64 k=8 fold=2 ({cfg.n_pe} PEs), LUT "
          f"{tuple(lut.shape)} = {lut.numel() * lut.element_size() / 1024:.0f} KiB")
    V_dev = torch.as_tensor(V, device=dev)
    assert np.array_equal(bmvm.iterate_kernel(lut, V_dev, cfg, 3, device=dev).cpu().numpy(),
                          bmvm.software_ref(A, V, 3, device="cpu"))
    print(f"{'r':>6s} {'software(us)':>14s} {'kernel(us)':>12s} {'speedup':>8s}")
    for r in (1, 10, 100, 1000):
        # the software baseline runs on the host CPU by design (see the docstring)
        t0 = time.monotonic()
        sw = bmvm.software_ref(A, V, r, device="cpu")
        t_sw = (time.monotonic() - t0) * 1e6
        bmvm.iterate_kernel(lut, V_dev, cfg, r, device=dev)   # warm
        sync()
        t0 = time.monotonic()
        hw = bmvm.iterate_kernel(lut, V_dev, cfg, r, device=dev)
        sync()
        t_hw = (time.monotonic() - t0) * 1e6
        assert np.array_equal(sw, hw.cpu().numpy())
        print(f"{r:6d} {t_sw:14.1f} {t_hw:12.1f} {t_sw / t_hw:8.2f}")

    # --- Table V analog: topology comparison -------------------------------------
    print("\nTable-V analog: one BMVM iteration routed over each topology")
    print("(measured: round-by-round schedule simulation; model: alpha-beta)")
    cfg2 = bmvm.BMVMConfig(n=256, k=4, fold=4)
    A2 = rng.integers(0, 2, (256, 256)).astype(np.uint8)
    v2 = rng.integers(0, 2, (256,)).astype(np.uint8)
    lut2 = bmvm.preprocess(A2, cfg2, device=dev)
    print(f"{'topology':>9s} {'rounds':>7s} {'link_bytes':>11s} {'sim_ms':>8s} "
          f"{'model_us(64PE)':>15s}")
    model = {r["topology"]: r for r in compare(64, chunk_bytes=2 * cfg2.n_sub)}
    for topo in ("ring", "mesh", "torus", "fattree"):
        t0 = time.monotonic()
        out, stats = bmvm.iterate_noc_sim(lut2, v2, cfg2, 2, topology=topo, device=dev)
        dt = (time.monotonic() - t0) * 1e3
        assert np.array_equal(out.reshape(1, -1),
                              bmvm.software_ref(A2, v2[None], 2, device="cpu"))
        print(f"{topo:>9s} {stats.rounds:7d} {stats.link_bytes:11d} {dt:8.1f} "
              f"{model[topo]['model_time_us']:15.2f}")
    print("=> cost/performance ordering ring < mesh < torus < fat-tree, as in the paper")


if __name__ == "__main__":
    main()
