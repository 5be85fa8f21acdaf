"""The plain float32 references equal the port's logits, at a small size on
the CPU: prefill and then decoding through the cache against the reference's
pass over the whole sequence, the MoE with its capacity rule dropping
tokens."""
import dataclasses
import json

import numpy as np
import pytest
import torch

from perfbench import weights
from perfbench.harness import port_config
from perfbench.reference import decoder, encdec

from .conftest import HERE


def cfg_file(name, **change):
    c = json.loads((HERE / "data" / "configs" / f"{name}.json").read_text())
    c["dtype"] = "float32"
    c["overrides"] = dict(c["overrides"], dtype="float32", **change.pop("overrides", {}))
    c.update(change)
    return c


def port_logits(params, cfg, prompts, served, frames=None):
    """The port's logits at each position that predicts a served token:
    prefill, then decode steps fed the served tokens."""
    from repro_torch.models import transformer as T

    B, S = prompts.shape
    G = served.shape[1]
    batch = {"tokens": prompts}
    if frames is not None:
        batch["frames"] = frames
    with torch.inference_mode():
        cache = T.init_cache(cfg, B, S + G, device="cpu")
        lg, cache = T.prefill(params, batch, cfg, cache)
        out = [lg[:, -1]]
        for j in range(G - 1):
            lg, cache = T.decode_step(params, {"tokens": served[:, j:j + 1]}, cfg, cache)
            out.append(lg)
    return torch.stack(out, 1).float()


def draw(cfg, seed, B, S, G, vocab):
    from repro_torch.models import transformer as T

    params = weights.make_params(T.abstract_params(cfg), torch.float32, seed, "cpu")
    rng = np.random.default_rng(seed)
    prompts = torch.as_tensor(rng.integers(0, vocab, (B, S)))
    served = torch.as_tensor(rng.integers(0, vocab, (B, G)))
    return params, prompts, served


@pytest.mark.parametrize("seed", [0, 1])
def test_encdec_reference_equals_the_port(seed):
    c = cfg_file("tiny-whisper")
    cfg = port_config(c)
    params, prompts, served = draw(cfg, seed, 3, 4, 6, cfg.vocab)
    frames = torch.randn((3, cfg.enc_seq, cfg.d_frontend), generator=torch.Generator().manual_seed(seed))
    want = port_logits(params, cfg, prompts, served, frames)
    got = encdec.logits(params, c, prompts, frames, served)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("factor", [1.25, 0.5])
def test_moe_decoder_reference_equals_the_port(factor):
    c = cfg_file("tiny-phi-moe", capacity_factor=factor,
                 overrides={"capacity_factor": factor})
    cfg = port_config(c)
    params, prompts, served = draw(cfg, 7, 4, 12, 6, cfg.vocab)
    want = port_logits(params, cfg, prompts, served)
    got = decoder.logits(params, c, prompts, None, served)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    if factor < 1:   # the rule dropped packets in this batch, in both
        h = torch.randn(4, 12 + 5, cfg.d_model)
        idx = torch.topk(torch.softmax(h @ params["blocks"]["0"]["moe"]["router"][0], -1),
                         2, -1).indices
        assert not decoder.keep_mask(idx, 12, cfg.n_experts, factor).all()


def test_keep_mask_by_hand():
    # 2 requests, 3 prompt positions, 2 decode positions, top-1 of 2 experts
    idx = torch.tensor([[[0], [0], [1], [0], [1]],
                        [[0], [1], [0], [0], [1]]])
    # prefill call: 6 tokens, cap = max(8, ...) clamped to T*k = 6: all kept
    assert decoder.keep_mask(idx, 3, 2, 1.0).all()
    assert decoder.capacity(6, 1, 2, 1.0) == 6
    first = decoder._first(torch.tensor([[0, 0, 1, 0, 1, 0]]), 2, 2)
    assert first.tolist() == [[True, True, True, False, True, False]]


def test_sizes_of_a_config_must_match_the_port():
    c = cfg_file("tiny-phi-moe")
    c["num_local_experts"] = 9
    with pytest.raises(ValueError, match="experts"):
        port_config(c)
    assert dataclasses.is_dataclass(port_config(cfg_file("tiny-whisper")))
