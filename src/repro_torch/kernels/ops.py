"""Public kernel entry points with the reference's ``use_kernel`` switch.

``use_kernel=True`` (the default, and what the apps' main path uses) goes
through each kernel's wrapper: the hand-written CUDA kernel for a CUDA tensor,
the plain version for a CPU tensor.  ``use_kernel=False`` selects the plain
PyTorch version explicitly on any device, as ``repro.kernels.ops`` selects its
jnp oracle.
"""
from __future__ import annotations

from . import ref
from .gf2_bmvm import gf2_bmvm as gf2_bmvm_kernel
from .histogram import particle_histogram as particle_histogram_kernel
from .histogram import particle_histogram_plain
from .minsum import minsum_check as minsum_check_kernel

# every kernel wrapper of the port, by kernel name; each carries ``.launches``
KERNELS = {
    "gf2_bmvm": gf2_bmvm_kernel,
    "minsum_check": minsum_check_kernel,
    "particle_histogram": particle_histogram_kernel,
}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


# -- GF(2) BMVM -------------------------------------------------------------

def gf2_preprocess(a_bits, k):
    return ref.gf2_preprocess(a_bits, k)


def gf2_bmvm(lut, v_words, *, use_kernel: bool = True):
    if use_kernel:
        return gf2_bmvm_kernel(lut, v_words)
    return ref.gf2_bmvm(lut, v_words)


# -- LDPC min-sum ------------------------------------------------------------

def minsum_check(u, *, use_kernel: bool = True):
    if use_kernel:
        return minsum_check_kernel(u)
    return ref.minsum_check(u)


# -- particle filter ----------------------------------------------------------

def particle_histogram(bins, weights, ref_hist, *, n_bins=None, use_kernel: bool = True):
    n_bins = n_bins or ref_hist.shape[-1]
    if use_kernel:
        return particle_histogram_kernel(bins, weights, ref_hist, n_bins)
    return particle_histogram_plain(bins, weights, ref_hist, n_bins)
