"""End-to-end LM training driver example, on the PyTorch/CUDA port: train a
reduced MoE model (the paper-technique flagship) for a few hundred steps with
checkpoint/restart, then serve it with batched requests.

    PYTHONPATH=src python examples/train_lm_torch.py [--device cpu]

Runs on the GPU unless ``--device cpu`` is given (with no GPU it raises).
"""
import argparse
import tempfile

from repro_torch.launch.serve import run as serve
from repro_torch.launch.train import run as train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    device = ["--device", args.device]

    with tempfile.TemporaryDirectory() as ckpt:
        print("=== training reduced qwen3-moe (NoC token routing inside) ===")
        losses = train(["--arch", "qwen3-moe-235b-a22b", "--smoke",
                        "--steps", "150", "--batch", "8", "--seq", "64",
                        "--lr", "2e-3", "--ckpt", ckpt, "--ckpt-every", "50",
                        "--log-every", "25"] + device)
        print(f"\nloss {losses[0]:.3f} -> {losses[-1]:.3f}")

        print("\n=== simulated preemption: restart resumes from step 150 ===")
        train(["--arch", "qwen3-moe-235b-a22b", "--smoke",
               "--steps", "200", "--batch", "8", "--seq", "64",
               "--lr", "2e-3", "--ckpt", ckpt, "--ckpt-every", "50",
               "--log-every", "25"] + device)

    print("\n=== serving (batched requests, prefill + decode) ===")
    out = serve(["--arch", "qwen3-moe-235b-a22b", "--smoke", "--requests", "8",
                 "--batch", "4", "--prompt-len", "32", "--gen", "8"] + device)
    print("generated token matrix:", tuple(out.shape))


if __name__ == "__main__":
    main()
