#!/usr/bin/env python3
"""How far implementations of whisper-large-v3 drift apart, layer by layer, on one GPU.

    python3 scripts/whisper_divergence.py

Builds the FULL config with random weights (the reference's init rules, seed
0) and seeded frames, runs the 32-layer encoder with ``attn_impl`` flash (the
CUDA kernel), naive and blocked (both plain PyTorch), in bf16 and in float32,
and prints one JSON line per (dtype, pair): the residual stream's max |diff| /
max |x| after each encoder layer, and the gap of the prefill logits.  A last
line gives the scale of the first layer's queries and scores, which is what
makes this random network amplify rounding differences.
"""
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    import torch

    if not torch.cuda.is_available():
        print("whisper_divergence: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.configs import get_config
    from repro_torch.models import attention as A
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    base = get_config("whisper-large-v3").replace(attn_impl="flash")
    gen = torch.Generator(device=dev).manual_seed(0)
    masters = init_params(T.abstract_params(base), gen)
    batch = {"tokens": torch.randint(0, base.vocab, (4, 32), generator=gen, device=dev),
             "frames": torch.randn((4, base.enc_seq, base.d_frontend), generator=gen,
                                   device=dev)}
    print(torch.cuda.get_device_name(0), f"torch {torch.__version__}")

    def encoder_stream(cfg, params):
        x = batch["frames"].to(cfg.cdtype) @ params["frontend"].to(cfg.cdtype)
        x = x + T._sinusoidal(torch.arange(x.shape[1], device=dev)[None], cfg.d_model, x.dtype)
        out = []
        for layer in range(cfg.n_enc_layers):
            p = T._at_period(params["enc_blocks"], layer)["0"]
            x, _ = T._apply_sublayer(p, x, cfg, "attn", "mlp", positions=None, cache=None,
                                     enc_out=None, causal=False)
            out.append(x.float())
        return out

    def gap(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    with torch.inference_mode():
        for dtype in ("bfloat16", "float32"):
            cfg = base.replace(dtype=dtype)
            params = T.cast_params(masters, cfg.cdtype)
            runs = {}
            for impl in ("flash", "naive", "blocked"):
                c = cfg.replace(attn_impl=impl)
                logits, _, _, _ = T.forward(params, batch, c)
                runs[impl] = logits.float(), encoder_stream(c, params)
            for a, b in (("flash", "naive"), ("blocked", "naive")):
                print(json.dumps(dict(
                    dtype=dtype, pair=f"{a} vs {b}",
                    encoder_layer_gap=[gap(x, y) for x, y in zip(runs[a][1], runs[b][1])],
                    logits_gap=gap(runs[a][0], runs[b][0]),
                    argmax_agreement=(runs[a][0].argmax(-1) == runs[b][0].argmax(-1))
                    .float().mean().item())))
            del params, runs
        params = T.cast_params(masters, base.cdtype)
        x = batch["frames"].to(base.cdtype) @ params["frontend"].to(base.cdtype)
        p = T._at_period(params["enc_blocks"], 0)["0"]
        q, k, _ = A._qkv(p["attn"], T._norm(x, p["norm1"], base), T._attn_cfg(base))
        s = torch.einsum("bhsd,bhtd->bhst", q.float(), k.float()) * base.hd ** -0.5
        top2 = s.topk(2, dim=-1).values
        print(json.dumps(dict(layer0_q_std=q.float().std().item(), score_std=s.std().item(),
                              median_top1_top2_gap=(top2[..., 0] - top2[..., 1]).median().item())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
