"""Plain float32 operations of the reference models (PyTorch, no kernel of
the program, TF32 off).

``mode`` "f32" is the reference.  ``mode`` "fp8" is the control: every
matrix product takes its operands rounded to float8 e4m3 with a scale for
each row or column, as an fp8 inference path would: a linear layer's
(projections, experts, router, head) activations by row and weights by
output column, and attention's q and k by row, its probabilities by row and
v by column; sums, norms and the softmax stay in float32.
"""
from __future__ import annotations

import math

import torch

FP8_MAX = 448.0


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def q8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale for each slice along ``dim``."""
    s = t.abs().amax(dim, keepdim=True).clamp_min(1e-12) / FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).float() * s


def linear(x: torch.Tensor, w: torch.Tensor, mode: str) -> torch.Tensor:
    """x (..., din) @ w (..., din, dout), in float32 or through fp8."""
    if mode == "fp8":
        x, w = q8(x, -1), q8(w, -2)
    return x @ w


def rms_norm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * g


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def sinusoidal(n: int, d: int, device) -> torch.Tensor:
    """(n, d): sin of position · 10000^(-i/half) in the first half, cos in the second."""
    half = d // 2
    freqs = 10000.0 ** (-torch.arange(half, dtype=torch.float32, device=device) / half)
    ang = torch.arange(n, dtype=torch.float32, device=device)[:, None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, n, H, D) at positions 0..n-1, the two halves of D rotated."""
    n, D = x.shape[1], x.shape[-1]
    half = D // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(n, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
           mode: str = "f32") -> torch.Tensor:
    """q (B, S, Hq, D), k and v (B, T, Hkv, D) -> (B, S, Hq, D); query head h
    reads kv head h // (Hq / Hkv); causal: query i sees keys up to i + T - S.
    In fp8, q and k (by row) and then the probabilities and v enter their
    products rounded to float8 e4m3."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    if mode == "fp8":
        q, k = q8(q, -1), q8(k, -1)
    qg = q.reshape(B, S, Hkv, g, D)
    s = torch.einsum("bshgd,bthd->bhgst", qg, k) / math.sqrt(D)
    if causal:
        keep = torch.arange(T, device=q.device)[None, :] <= (
            torch.arange(S, device=q.device)[:, None] + (T - S))
        s = s.masked_fill(~keep, float("-inf"))
    p = torch.softmax(s, -1)
    if mode == "fp8":
        p, v = q8(p, -1), q8(v, 1)
    return torch.einsum("bhgst,bthd->bshgd", p, v).reshape(B, S, Hq, D)
