"""The traffic generator repeats for a seed and gives every seed the same sizes."""
import numpy as np
import torch

from perfbench.traffic import Mix, Traffic

CHAT = Mix.from_dict({"batch": 4, "prompt_len": 7, "gen": 3})
AUDIO = Mix.from_dict({"batch": 2, "prompt_tokens": [5, 6], "gen": 3, "clip_seconds": 1})


def test_same_seed_same_batches():
    for seed in (0, 7, 2 ** 31 + 12345, 3 * 2 ** 40, -5):
        a = Traffic(CHAT, seed, vocab=100)
        b = Traffic(CHAT, seed, vocab=100)
        for i in (0, 1, 17, 2 ** 32 - 1):
            assert np.array_equal(a.batch(i).prompts, b.batch(i).prompts)


def test_seeds_and_batches_differ_but_not_their_sizes():
    a, b = Traffic(CHAT, 1, vocab=100), Traffic(CHAT, 2, vocab=100)
    assert not np.array_equal(a.batch(0).prompts, b.batch(0).prompts)
    assert not np.array_equal(a.batch(0).prompts, a.batch(1).prompts)
    for t in (a, b):
        p = t.batch(3).prompts
        assert p.shape == (4, 7) and p.dtype == np.int64
        assert p.min() >= 0 and p.max() < 100


def test_audio_frames_repeat_and_fixed_prompt():
    a = Traffic(AUDIO, 11, vocab=10, d_frontend=3, n_frames=50, dtype=torch.bfloat16)
    b = Traffic(AUDIO, 11, vocab=10, d_frontend=3, n_frames=50, dtype=torch.bfloat16)
    x, y = a.batch(4), b.batch(4)
    assert x.frames.shape == (2, 50, 3) and x.frames.dtype == torch.bfloat16
    assert torch.equal(x.frames, y.frames)
    assert not torch.equal(x.frames, a.batch(5).frames)
    assert np.array_equal(x.prompts, [[5, 6], [5, 6]])


def test_mix_must_match_the_model():
    import pytest

    with pytest.raises(ValueError):
        Traffic(AUDIO, 0, vocab=10, d_frontend=3, n_frames=1500)
    with pytest.raises(ValueError):
        Traffic(AUDIO, 0, vocab=6)
    with pytest.raises(ValueError):
        Mix.from_dict({"batch": 1, "gen": 1})
