"""Device resolution for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another. There is no silent CPU fallback: with no card and no explicit
    device this raises."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU"
        )
    return torch.device("cuda")
