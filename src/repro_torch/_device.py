"""Device selection shared by every entry point of the port."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` → ``torch.device``; a CUDA device with no GPU present raises.

    Entry points default to ``"cuda"`` and never carry on silently on the CPU:
    the CPU is used only when the caller asks for it."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' to "
                               "run on the CPU")
        if dev.index is None:   # name the card, so it compares equal to tensor.device
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def synchronize(dev: torch.device) -> None:
    """Wait for ``dev``'s queued work (a no-op on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
