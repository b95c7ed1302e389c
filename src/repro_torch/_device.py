"""Device resolution shared by the port's entry points.

Entry points run on the card unless the caller asks for the CPU: with no
device given they take `cuda`, and raise when there is none, so a run that
meant to use the card never quietly falls back to the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """`None` -> `cuda`; raises if the resolved device is CUDA and none exists."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    return dev
