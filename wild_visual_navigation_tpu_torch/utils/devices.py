"""The device an entry point runs on: the card unless the caller asks for
the CPU, and an error, never a silent CPU run, when there is no card."""

from __future__ import annotations

import torch


def torch_device(device, who: str) -> torch.device:
    """`device` as a torch.device; raises when it names CUDA and no CUDA
    device is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: no CUDA device; pass device='cpu' to run on the CPU")
    return dev
