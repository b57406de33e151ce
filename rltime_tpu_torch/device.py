"""Device resolution: an explicit device, never a silent CPU fallback."""
from __future__ import annotations

import torch


def resolve_device(name: str | torch.device) -> torch.device:
    """`"cuda"` / `"cuda:1"` / `"cpu"` -> torch.device.

    Raises when a CUDA device is asked for and CUDA is unavailable: a
    run that asked for the GPU never quietly runs on the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            "is False; pass --device cpu to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}")
    return dev
