"""The one traffic generator: a mix's parameters (``traffic/<name>.json``)
and the seed in, one batch of requests out, the same for the same seed.

A mix gives ``batch`` (requests served together: ``serve_batch`` runs a whole
batch to one ``gen``), ``gen`` (tokens generated for each request), and either
``prompt_tokens`` (one fixed prompt, such as Whisper's start-of-transcript
sequence) or ``prompt_len`` (prompts of that many token ids drawn uniformly
from the vocabulary).  An encoder-decoder configuration also takes
``clip_seconds`` of audio a request (or ``clip_frames``): its frame
embeddings (B, 50 a second, d_frontend) are drawn from a standard normal on
the device, in the served dtype.

Batch ``i`` depends on the seed and ``i`` alone, so a run can draw the
inputs of any batch again (the correctness check does, for the batches it
samples).  Every seed gives the same sizes; only the values differ.
"""
from __future__ import annotations

import dataclasses

import numpy as np

FRAMES_PER_SECOND = 50       # Whisper's encoder: 1500 frames for 30 s
WARM = 2 ** 32 - 1           # the batch index of the warm-up batch


def substream(seed: int, *tags: int) -> np.random.Generator:
    """A NumPy generator for ``tags`` under ``seed`` (any whole number)."""
    return np.random.default_rng([seed & (2 ** 64 - 1), *tags])


def torch_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed for a ``torch.Generator`` for ``tags`` under ``seed``."""
    return int(substream(seed, *tags).integers(0, 2 ** 63 - 1))


@dataclasses.dataclass(frozen=True)
class Mix:
    batch: int
    gen: int
    prompt_len: int
    prompt_tokens: tuple[int, ...] | None = None
    clip_frames: int = 0         # frames of audio a request (0: none)

    @classmethod
    def from_dict(cls, d: dict) -> "Mix":
        fixed = d.get("prompt_tokens")
        if (fixed is None) == ("prompt_len" not in d):
            raise ValueError("a mix gives either prompt_tokens or prompt_len")
        return cls(batch=int(d["batch"]), gen=int(d["gen"]),
                   prompt_len=len(fixed) if fixed is not None else int(d["prompt_len"]),
                   prompt_tokens=tuple(fixed) if fixed is not None else None,
                   clip_frames=int(d.get("clip_frames",
                                         d.get("clip_seconds", 0) * FRAMES_PER_SECOND)))


@dataclasses.dataclass
class Batch:
    index: int
    prompts: np.ndarray          # (B, S) int64 token ids
    frames: object = None        # (B, n_frames, d_frontend) tensor on the device, or None


class Traffic:
    """Batches of ``mix`` for a model of ``vocab`` ids (and, for audio,
    ``d_frontend`` frame channels), drawn from ``seed`` onto ``device``."""

    def __init__(self, mix: Mix, seed: int, *, vocab: int, d_frontend: int = 0,
                 n_frames: int = 0, device="cpu", dtype=None):
        if mix.prompt_tokens is not None and max(mix.prompt_tokens) >= vocab:
            raise ValueError(f"prompt token {max(mix.prompt_tokens)} outside the vocab {vocab}")
        if n_frames and mix.clip_frames != n_frames:
            raise ValueError(f"the mix's clips are {mix.clip_frames} frames; the model "
                             f"takes {n_frames}")
        self.mix, self.seed, self.vocab = mix, seed, vocab
        self.d_frontend, self.n_frames = d_frontend, n_frames
        self.device, self.dtype = device, dtype

    def batch(self, i: int) -> Batch:
        import torch

        m = self.mix
        if m.prompt_tokens is not None:
            prompts = np.tile(np.asarray(m.prompt_tokens, np.int64), (m.batch, 1))
        else:
            prompts = substream(self.seed, 1, i).integers(0, self.vocab, (m.batch, m.prompt_len),
                                                          dtype=np.int64)
        frames = None
        if self.n_frames:
            g = torch.Generator(device=self.device).manual_seed(torch_seed(self.seed, 2, i))
            frames = torch.randn((m.batch, self.n_frames, self.d_frontend), generator=g,
                                 device=self.device, dtype=self.dtype)
        return Batch(i, prompts, frames)
