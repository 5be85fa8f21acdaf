#!/usr/bin/env python3
"""Time the tensor-core flash-attention kernel against its number of key
splits, on one GPU.

    python3 scripts/flash_splits.py

At whisper-large-v3's two attention shapes in bf16 (the encoder's
self-attention (4, 20, 1500, 1500, 64) and the decoder's cross-attention at
prompt 32, (4, 20, 32, 1500, 64)), and at the cross-attention of prompts 64
and 128, it runs the kernel with every split count from 1 to 16 (the split
kernel and the combine kernel, as the wrapper launches them) and prints the
median milliseconds of 25 runs, timed as ``chip_smoke.py`` times a kernel (CUDA
events, L2 overwritten and the card held in a spin before each start), beside
the count ``num_splits`` picks.  One JSON line per shape.
"""
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    import torch

    if not torch.cuda.is_available():
        print("flash_splits: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.kernels import flash_attention as fa

    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)

    def timed(fn, reps=25):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        events = []
        for _ in range(reps):
            flush.zero_()
            torch.cuda._sleep(2_000_000)
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            fn()
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in events)

    for B, H, S, T, D in [(4, 20, 1500, 1500, 64), (4, 20, 32, 1500, 64),
                          (4, 20, 64, 1500, 64), (4, 20, 128, 1500, 64)]:
        q, k, v = (torch.randn(shape, generator=g, device=dev).bfloat16()
                   for shape in ((B, H, S, D), (B, H, T, D), (B, H, T, D)))
        plain = fa.flash_attention_plain(q, k, v, False).float()
        out = torch.empty_like(q)
        ms = {}
        for n in range(1, fa.MAX_SPLITS + 1):
            if n > 1 and fa.key_ranges(T, n)[-1][0] >= T:
                continue                              # a split would be empty
            scratch = fa._scratch(q, n) if n > 1 else None
            fa._launch_tc(q, k, v, False, n, out, scratch)
            err = (out.float() - plain).abs().max().item()
            if err > 3e-2:
                raise AssertionError(f"n_split={n} differs by {err} at {(B, H, S, T, D)}")
            ms[n] = timed(lambda: fa._launch_tc(q, k, v, False, n, out, scratch))
        print(json.dumps(dict(shape=[B, H, S, T, D], dtype="bfloat16", sm_count=sm,
                              num_splits=fa.num_splits(B, H, S, T, sm), ms_by_n_split=ms)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
