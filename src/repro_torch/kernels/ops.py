"""Public kernel entry points with the reference's ``use_kernel`` switch.

``use_kernel=True`` (what the apps' main path and ``models.attention`` pass)
goes through each kernel's wrapper: the hand-written CUDA kernel for a CUDA
tensor, the plain version for a CPU tensor.  ``use_kernel=False`` selects the
plain PyTorch version explicitly on any device, as ``repro.kernels.ops``
selects its jnp oracle.  The defaults are the reference's: True, except
``flash_attention``'s False.
"""
from __future__ import annotations

import torch

from . import ref
from .flash_attention import flash_attention as flash_attention_kernel
from .gf2_bmvm import gf2_bmvm as gf2_bmvm_kernel
from .histogram import particle_histogram as particle_histogram_kernel
from .histogram import particle_histogram_plain
from .minsum import minsum_check as minsum_check_kernel

# every kernel wrapper of the port, by kernel name; each carries ``.launches``
KERNELS = {
    "gf2_bmvm": gf2_bmvm_kernel,
    "minsum_check": minsum_check_kernel,
    "particle_histogram": particle_histogram_kernel,
    "flash_attention": flash_attention_kernel,
}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0
    flash_attention_kernel.combine_launches = 0
    flash_attention_kernel.instance_launches = {}


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


# -- flash attention -----------------------------------------------------------

class _FlashAttention(torch.autograd.Function):
    """Kernel forward; the backward recomputes through ``ref.mha`` (the
    reference's ``custom_vjp`` strategy: no backward kernel exists)."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.causal = causal
        ctx.save_for_backward(q, k, v)
        return flash_attention_kernel(q, k, v, causal)

    @staticmethod
    def backward(ctx, grad):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            q_, k_, v_ = (t.detach().requires_grad_() for t in (q, k, v))
            out = ref.mha(q_, k_, v_, causal=ctx.causal)
            dq, dk, dv = torch.autograd.grad(out, (q_, k_, v_), grad)
        return dq, dk, dv, None


def flash_attention(q, k, v, causal: bool = True, use_kernel: bool = False):
    """Differentiable attention: the kernel's forward with ``use_kernel``,
    else ``ref.mha``; the gradient is ``ref.mha``'s either way."""
    if use_kernel:
        return _FlashAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(), causal)
    return ref.mha(q, k, v, causal=causal)
