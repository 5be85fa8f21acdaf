#!/usr/bin/env python3
"""Where the time goes on the port's main paths, on one GPU.

    python3 scripts/profile_main_path.py [--only PATH[,PATH...]]

At the sizes ``chip_smoke.py`` drives (BMVM n=4096 r=4; LDPC 7168 bits × 512
codewords × 10 iterations; particle filter 512² × 4096 particles × 16 frames;
whisper-large-v3 FULL with ``attn_impl="flash"`` at batch 4 and prompt 32: one
prefill, one decode step, and the prefill of the plain path,
``attn_impl="naive"``; the BMVM n=1024 NoC on the 8×8 mesh, r=2, uncut and cut
into 2 and 4 pods over quasi-SERDES bridges, and through the buffered wormhole
switch, ``mode="buffered"``, uncut and in 2 pods; llama3.2-1b FULL with
``attn_impl="flash"``: one training step at batch 8 × seq 128, the same step
through the plain path, ``attn_impl="naive"``, and one decode step of the
bf16 copy at batch 4 against 32 cached tokens; the MoE, MLA and vlm families
at full width as ``chip_smoke.py`` phase 10 sizes them: a training step at
batch 8 × seq 128 of phi3.5-moe (2 layers), minicpm3-4b (31 of 62 layers)
and internvl2-1b (uncut, 256 seeded patches), and a decode step at batch 4
against 32 cached tokens of the bf16 phi3.5-moe (16 of 32 layers), qwen3-moe
(4 of 94), minicpm3-4b and internvl2-1b (after its 256 patches); the hybrid
and xlstm families as phase 11 sizes them: a training step of jamba-v0.1-52b's
2-layer cut (one Mamba, one attention layer) and of xlstm-350m uncut, and a
decode step of the bf16 jamba (16 of 32 layers) and xlstm-350m; one family
arch is held on the card at a time) it times each path
on the host clock (median of 5 warm runs, each ending in ``torch.cuda.synchronize()``),
then traces one more run with
``torch.profiler`` and reports the device busy time (sum of the kernel, copy
and memset activities on the card), their count, the device idle share of
the traced window, the device activities that take the most time, and the
device time and launches of each of the port's own kernels.  One JSON line
per path.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the port's own kernels (csrc/kernels.cu), whose device time each path reports
PORT_KERNELS = ("gf2_bmvm_kernel", "minsum_check_kernel", "particle_histogram_kernel",
                "flash_attention_tc_kernel", "flash_attention_combine_kernel",
                "flash_attention_f32_kernel")


def main(argv=None):
    args = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    args.add_argument("--only", default="", help="comma-separated path names (default: all)")
    only = [p for p in args.parse_args(argv).only.split(",") if p]
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_main_path: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(HERE, "src"))
    sys.path.insert(0, HERE)
    from chip_smoke import draw_serving_params
    from repro_torch.apps import bmvm, ldpc
    from repro_torch.apps import particle_filter as pf
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, _synthesize
    from repro_torch.launch import train
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import init_params
    from repro_torch.optim import AdamWConfig, adamw_init

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(0)
    bcfg = bmvm.BMVMConfig(n=4096, k=8, fold=1)
    A = torch.randint(0, 2, (bcfg.n, bcfg.n), generator=g, device=dev, dtype=torch.uint8)
    V = torch.randint(0, 2, (64, bcfg.n), generator=g, device=dev, dtype=torch.uint8)
    lut = bmvm.preprocess(A, bcfg)
    H = ldpc.pg_ldpc_H(copies=1024)
    idx = ldpc.build_edge_index(H)
    llr = ldpc.awgn_llr(np.zeros((512, H.shape[1]), np.int8), 3.0, rng)
    pcfg = pf.PFConfig(img=512, roi=64, n_particles=4096, n_bins=16, seed=0)
    frames, _ = pf.synth_video(pcfg, 16, rng)

    wcfg = get_config("whisper-large-v3").replace(attn_impl="flash")
    wparams = T.cast_params(init_params(T.abstract_params(wcfg), g), wcfg.cdtype)
    wbatch = {"tokens": torch.randint(0, wcfg.vocab, (4, 32), generator=g, device=dev),
              "frames": torch.randn((4, wcfg.enc_seq, wcfg.d_frontend), generator=g,
                                    device=dev).to(wcfg.cdtype)}

    def whisper_prefill(cfg):
        with torch.inference_mode():
            return T.prefill(wparams, wbatch, cfg, T.init_cache(cfg, 4, 48, device=dev))

    state = {"cache": whisper_prefill(wcfg)[1]}     # 32 cached tokens; 16 steps of room

    def whisper_decode_step():
        with torch.inference_mode():
            _, state["cache"] = T.decode_step(wparams, {"tokens": wbatch["tokens"][:, :1]},
                                              wcfg, state["cache"])

    big = bmvm.BMVMConfig(n=1024, k=8, fold=4)
    lut_big = bmvm.preprocess(torch.randint(0, 2, (1024, 1024), generator=g, device=dev,
                                            dtype=torch.uint8), big)
    v_big = rng.integers(0, 2, (1024,)).astype(np.uint8)

    def bmvm_noc(pods, mode="sim"):
        return lambda: bmvm.iterate_noc_sim(lut_big, v_big, big, 2, topology="mesh",
                                            n_nodes=64, pods=pods, mode=mode)

    llama = {}

    def llama_setup():
        """llama3.2-1b FULL, built at first use (25 GB with its optimizer)."""
        if not llama:
            cfg = get_config("llama3.2-1b").replace(attn_impl="flash")
            masters = init_params(T.abstract_params(cfg), g)
            data = DataConfig(vocab=cfg.vocab, seq_len=128, global_batch=8, seed=0)
            params = T.cast_params(masters, cfg.cdtype)
            toks = torch.randint(0, cfg.vocab, (4, 32), generator=g, device=dev)
            with torch.inference_mode():
                _, cache = T.prefill(params, {"tokens": toks}, cfg,
                                     T.init_cache(cfg, 4, 48, device=dev))
            llama.update(cfg=cfg, state={"params": masters, "opt": adamw_init(masters)},
                         step=make_train_step(cfg, AdamWConfig(), total_steps=100, warmup=5),
                         plain_step=make_train_step(cfg.replace(attn_impl="naive"), AdamWConfig(),
                                                    total_steps=100, warmup=5),
                         batch=train.device_batch(_synthesize(data, 0), cfg, dev),
                         params=params, cache=cache, token=toks[:, :1])
        return llama

    def llama_train_step(which="step"):
        lm = llama_setup()
        lm["state"], _ = lm[which](lm["state"], lm["batch"])

    def llama_decode_step():
        lm = llama_setup()
        with torch.inference_mode():      # the cache stays at 32 tokens: the same step again
            T.decode_step(lm["params"], {"tokens": lm["token"]}, lm["cfg"], lm["cache"])

    family = {}

    def family_setup(kind, arch, **change):
        """One arch of phases 10 and 11 with ``change`` to its config, built at
        first use; building another frees it."""
        key = (kind, arch, tuple(sorted(change.items())))
        if family.get("key") != key:
            family.clear()
            torch.cuda.empty_cache()
            cfg = get_config(arch).replace(attn_impl="flash", **change)
            fg = torch.Generator(device=dev).manual_seed(0)
            if kind == "train":
                masters = init_params(T.abstract_params(cfg), fg)
                data = DataConfig(vocab=cfg.vocab, seq_len=128, global_batch=8, seed=0)
                batch = train.device_batch(_synthesize(data, 0), cfg, dev)
                if cfg.family == "vlm":     # seeded patches, as chip_smoke.py phase 10
                    batch["patches"] = torch.randn(batch["patches"].shape, generator=fg,
                                                   device=dev).to(cfg.cdtype)
                family.update(state={"params": masters, "opt": adamw_init(masters)},
                              step=make_train_step(cfg, AdamWConfig(), total_steps=100,
                                                   warmup=5), batch=batch)
            else:
                params = draw_serving_params(torch, cfg, fg, dev)
                b = {"tokens": torch.randint(0, cfg.vocab, (4, 32), generator=fg, device=dev)}
                n_pre = cfg.n_patches if cfg.family == "vlm" else 0
                if n_pre:
                    b["patches"] = torch.zeros((4, n_pre, cfg.d_frontend), dtype=cfg.cdtype,
                                               device=dev)
                with torch.inference_mode():
                    _, cache = T.prefill(params, b, cfg,
                                         T.init_cache(cfg, 4, n_pre + 48, device=dev))
                family.update(params=params, cache=cache, token=b["tokens"][:, :1])
            family.update(key=key, cfg=cfg)
        return family

    def family_train_step(arch, **change):
        def run():
            fam = family_setup("train", arch, **change)
            fam["state"], _ = fam["step"](fam["state"], fam["batch"])
        return run

    def family_decode_step(arch, **change):
        def run():
            fam = family_setup("serve", arch, **change)
            # the K/V caches stay put and the recurrent states move on: the
            # same work again
            with torch.inference_mode():
                T.decode_step(fam["params"], {"tokens": fam["token"]}, fam["cfg"], fam["cache"])
        return run

    paths = {
        "bmvm_iterate_kernel": lambda: bmvm.iterate_kernel(lut, V, bcfg, 4),
        "ldpc_decode_minsum": lambda: ldpc.decode_minsum(idx, llr, 10),
        "pf_track": lambda: pf.track(frames, pcfg),
        "whisper_prefill": lambda: whisper_prefill(wcfg),
        "whisper_decode_step": whisper_decode_step,
        "whisper_prefill_plain": lambda: whisper_prefill(wcfg.replace(attn_impl="naive")),
        "bmvm_noc_n1024_uncut": bmvm_noc(None),
        "bmvm_noc_n1024_2pods": bmvm_noc([0] * 32 + [1] * 32),
        "bmvm_noc_n1024_4pods": bmvm_noc([i // 16 for i in range(64)]),
        "bmvm_noc_n1024_buffered": bmvm_noc(None, "buffered"),
        "bmvm_noc_n1024_buffered_2pods": bmvm_noc([0] * 32 + [1] * 32, "buffered"),
        "llama_train_step": llama_train_step,
        "llama_train_step_plain": lambda: llama_train_step("plain_step"),
        "llama_decode_step": llama_decode_step,
        "phi_train_step": family_train_step("phi3.5-moe-42b-a6.6b", n_layers=2),
        "phi_decode_step": family_decode_step("phi3.5-moe-42b-a6.6b", n_layers=16),
        "qwen_decode_step": family_decode_step("qwen3-moe-235b-a22b", n_layers=4),
        "minicpm_train_step": family_train_step("minicpm3-4b", n_layers=31),
        "minicpm_decode_step": family_decode_step("minicpm3-4b"),
        "internvl_train_step": family_train_step("internvl2-1b"),
        "internvl_decode_step": family_decode_step("internvl2-1b"),
        "jamba_train_step": family_train_step("jamba-v0.1-52b", n_layers=2,
                                              pattern=(("mamba", "mlp"), ("attn", "mlp"))),
        "jamba_decode_step": family_decode_step("jamba-v0.1-52b", n_layers=16),
        "xlstm_train_step": family_train_step("xlstm-350m"),
        "xlstm_decode_step": family_decode_step("xlstm-350m"),
    }
    family_paths = {k for k in paths if k.split("_")[0] in ("phi", "qwen", "minicpm",
                                                             "internvl", "jamba", "xlstm")}
    unknown = set(only) - set(paths)
    if unknown:
        raise SystemExit(f"unknown paths {sorted(unknown)}; choose from {sorted(paths)}")
    paths = {k: v for k, v in paths.items() if not only or k in only}
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    print(torch.cuda.get_device_name(0), f"torch {torch.__version__}")
    # all host-clock timings first, so that no profiler session precedes a
    # timed run
    walls = {}
    for name, fn in paths.items():
        runs = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
        walls[name] = runs[1:]                 # the first run warms caches
    for name, fn in paths.items():
        if name in family_paths:
            fn()        # builds the arch again (one is held at a time) outside the trace
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            traced_s = time.perf_counter() - t0
        # device-side activities only (kernels, copies, memsets): the CPU
        # operators that launched them would count the same time again
        by_name: dict[str, list[float]] = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
        busy_us = sum(sum(v) for v in by_name.values())
        top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:14]
        ours = {}
        for k, v in by_name.items():
            kernel = next((n for n in PORT_KERNELS if n in k), None)
            if kernel:
                ms, calls = ours.get(kernel, (0.0, 0))
                ours[kernel] = (ms + sum(v) / 1e3, calls + len(v))
        w = walls[name]
        print(json.dumps(dict(
            path=name, wall_ms_median=statistics.median(w) * 1e3,
            wall_ms_min=min(w) * 1e3, wall_ms_max=max(w) * 1e3, runs=len(w),
            traced_wall_ms=traced_s * 1e3, device_busy_ms=busy_us / 1e3,
            device_activities=sum(len(v) for v in by_name.values()),
            device_idle_share=1 - busy_us / 1e6 / traced_s,
            top_device_activities=[dict(name=k[:100], device_ms=sum(v) / 1e3, calls=len(v))
                                   for k, v in top],
            port_kernels={k: dict(device_ms=ms, calls=n) for k, (ms, n) in ours.items()})))
    return 0


if __name__ == "__main__":
    sys.exit(main())
