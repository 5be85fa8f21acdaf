"""Plain PyTorch versions of every kernel of the port (the ``ref.py`` contract).

Each function carries the name of its counterpart in ``repro.kernels.ref`` and
is the semantic ground truth the CUDA kernels are held to.  They run on any
device.  Two deliberate differences from the JAX oracles:

* GF(2) words are ``int32``, not ``uint32``: words are k-bit with k ≤ 16, so
  the bit patterns are identical, and torch's ``uint32`` has no shifts, no
  ``%`` and no use as an index.
* Integer matrix products do not exist on CUDA, so the GF(2) products run in
  float32 and reduce mod 2 — exact while a sum stays below 2^24.
"""
from __future__ import annotations

import torch

# elements of the (R, c, k, 2^k) float32 intermediate built per chunk of LUT
# columns in gf2_preprocess (1 GiB at 2^28); bounds memory at large n
_PREPROCESS_CHUNK_ELEMS = 1 << 28


def xor_reduce(x: torch.Tensor, dim: int) -> torch.Tensor:
    """XOR-reduce ``x`` over ``dim`` by a pairwise tree (order is irrelevant
    for XOR, so this equals the reference's left fold bit for bit)."""
    x = x.movedim(dim, 0)
    while x.shape[0] > 1:
        h = x.shape[0] // 2
        x = torch.cat([x[:h] ^ x[h:2 * h], x[2 * h:]])
    return x[0]


# ---------------------------------------------------------------------------
# GF(2) BMVM — Williams' sub-quadratic algorithm (paper §VI)
# ---------------------------------------------------------------------------

def gf2_preprocess(a_bits: torch.Tensor, k: int) -> torch.Tensor:
    """One-time preprocessing (paper Fig. 13): (n, n) bits → LUT (C, 2^k, R)
    int32 with LUT[c, p, r] = A_tile[r, c] @ b_p over GF(2), packed as a k-bit
    word (bit j = row j of the tile product)."""
    n = a_bits.shape[0]
    if a_bits.shape != (n, n) or n % k:
        raise ValueError(f"a_bits must be square with n % k == 0, got "
                         f"{tuple(a_bits.shape)} and k={k}")
    if not 1 <= k <= 16:
        raise ValueError(f"k must be in [1, 16], got {k}")
    nk, P, dev = n // k, 2 ** k, a_bits.device
    tiles = a_bits.reshape(nk, k, nk, k).permute(0, 2, 1, 3).to(torch.float32)  # (R, C, o, i)
    ar = torch.arange(k, device=dev)
    bvec = ((torch.arange(P, device=dev)[:, None] >> ar[None, :]) & 1).to(torch.float32)
    pow2 = (2.0 ** ar.to(torch.float32))[:, None]                      # (o, 1)
    out = torch.empty((nk, P, nk), dtype=torch.int32, device=dev)      # (C, P, R)
    step = max(1, _PREPROCESS_CHUNK_ELEMS // (nk * k * P))
    for c0 in range(0, nk, step):
        prod = torch.remainder(tiles[:, c0:c0 + step] @ bvec.T, 2)     # (R, c, o, P)
        words = (prod * pow2).sum(2)                                   # (R, c, P), < 2^16
        out[c0:c0 + step] = words.permute(1, 2, 0).to(torch.int32)
    return out


def gf2_pack_vector(v_bits: torch.Tensor, k: int) -> torch.Tensor:
    """(..., n) bits → (..., n//k) k-bit int32 words (LUT partition indices)."""
    *lead, n = v_bits.shape
    w = v_bits.reshape(*lead, n // k, k).to(torch.int32)
    shifts = torch.arange(k, dtype=torch.int32, device=v_bits.device)
    return (w << shifts).sum(-1, dtype=torch.int32)


def gf2_unpack_vector(words: torch.Tensor, k: int) -> torch.Tensor:
    """Inverse of gf2_pack_vector; takes int32, int64 or uint32 words."""
    if words.dtype == torch.uint32:
        words = words.view(torch.int32)
    shifts = torch.arange(k, dtype=words.dtype, device=words.device)
    bits = (words[..., None] >> shifts) & 1
    return bits.reshape(*words.shape[:-1], words.shape[-1] * k).to(torch.uint8)


def gf2_bmvm(lut: torch.Tensor, v_words: torch.Tensor) -> torch.Tensor:
    """A@v over GF(2) from the LUT: out[m, r] = XOR_c LUT[c, v_words[m, c], r].
    (C, P, R), (M, C) → (M, R)."""
    C = lut.shape[0]
    cols = torch.arange(C, device=lut.device)
    looked = lut[cols[None, :], v_words.to(torch.int64)]               # (M, C, R)
    return xor_reduce(looked, 1)


def gf2_matmul_oracle(a_bits: torch.Tensor, v_bits: torch.Tensor) -> torch.Tensor:
    """Direct O(n^2) GF(2) mat-vec: (n, n) x (M, n) → (M, n) uint8 bits,
    as a float32 product reduced mod 2 (exact for n < 2^24)."""
    prod = v_bits.to(torch.float32) @ a_bits.to(torch.float32).T
    return torch.remainder(prod, 2).to(torch.uint8)


# ---------------------------------------------------------------------------
# LDPC min-sum check-node update (paper §IV)
# ---------------------------------------------------------------------------

def minsum_check(u: torch.Tensor) -> torch.Tensor:
    """Check-node processing with the two-min trick.  u: (n_checks, deg);
    out[c, j] = prod_{i≠j} sign(u_i) * min_{i≠j} |u_i|, with sign(-0.0) = +1
    and the first index taken on ties, as in the reference."""
    mag = u.abs()
    sgn = torch.where(u < 0, -1.0, 1.0).to(u.dtype)
    total_sign = sgn.prod(-1, keepdim=True)
    min1 = mag.amin(-1, keepdim=True)
    amin = mag.argmin(-1)
    is_min = torch.arange(u.shape[-1], device=u.device) == amin[..., None]
    min2 = torch.where(is_min, torch.inf, mag).amin(-1, keepdim=True)
    mins = torch.where(is_min, min2, min1)
    return (total_sign * sgn) * mins


def bitnode_sum(u0: torch.Tensor, v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Bit-node processing (paper Listing 3): total = u0 + Σv;  u_j = total - v_j."""
    total = u0 + v.sum(-1)
    return total, total[..., None] - v


# ---------------------------------------------------------------------------
# Particle filter: weighted histogram + Bhattacharyya (paper §V)
# ---------------------------------------------------------------------------

def weighted_histogram(bins: torch.Tensor, weights: torch.Tensor, n_bins: int) -> torch.Tensor:
    """bins (N, px) int bin index per pixel, weights (px,) → (N, n_bins)
    normalized weighted histograms.  Bins outside [0, n_bins) count nowhere."""
    onehot = (bins[..., None] == torch.arange(n_bins, device=bins.device)).to(weights.dtype)
    hist = torch.einsum("npb,p->nb", onehot, weights)
    return hist / hist.sum(-1, keepdim=True).clamp_min(1e-12)


def bhattacharyya(hist: torch.Tensor, ref_hist: torch.Tensor) -> torch.Tensor:
    """(N, B), (B,) → (N,) Bhattacharyya coefficients."""
    return torch.sqrt(hist * ref_hist[None, :]).sum(-1)


def particle_weights(bins: torch.Tensor, weights: torch.Tensor, ref_hist: torch.Tensor,
                     sigma: float = 0.1) -> torch.Tensor:
    """Full PE of paper Fig. 11: histogram → BC → weight = exp((BC-1)/σ²)."""
    hist = weighted_histogram(bins, weights, ref_hist.shape[-1])
    bc = bhattacharyya(hist, ref_hist)
    w = torch.exp((bc - 1.0) / (sigma * sigma))
    return w / w.sum().clamp_min(1e-12)


# ---------------------------------------------------------------------------
# Flash attention (forward) — LM-stack hot spot
# ---------------------------------------------------------------------------

def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
        scale: float | None = None) -> torch.Tensor:
    """q: (B, Hq, S, D), k/v: (B, Hkv, T, D) with Hq % Hkv == 0 (GQA).  Float32
    math; causal masks with -inf, so a row with no visible key (S > T) is NaN,
    as in the reference."""
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    g = Hq // Hkv
    qg = q.reshape(B, Hkv, g, S, D)
    scale = scale if scale is not None else D ** -0.5
    logits = torch.einsum("bhgsd,bhtd->bhgst", qg.float(), k.float()) * scale
    if causal:
        S_, T_ = logits.shape[-2], logits.shape[-1]
        mask = torch.ones((S_, T_), dtype=torch.bool, device=q.device).tril(T_ - S_)
        logits = logits.masked_fill(~mask, -torch.inf)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgst,bhtd->bhgsd", p, v.float())
    return out.reshape(B, Hq, S, D).to(q.dtype)
