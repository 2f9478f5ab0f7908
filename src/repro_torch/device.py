"""The device every entry point of the package resolves its ``device``
argument with: CUDA unless the caller names another."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """CUDA unless the caller names another device. Without a CUDA device an
    explicit ``device="cpu"`` is required — the port never falls back to the
    CPU quietly."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; repro_torch runs on the card "
                "unless the caller asks for the CPU with device='cpu'")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           f"available")
    return dev
