"""The device an entry point runs on: the card unless the caller asks for
the CPU, and an error, never a silent CPU run, when there is no card; and
the constants kept resident on a device."""

from __future__ import annotations

import torch

_RESIDENT: dict = {}  # key -> what `resident` built for it


def torch_device(device, who: str) -> torch.device:
    """`device` as a torch.device; raises when it names CUDA and no CUDA
    device is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: no CUDA device; pass device='cpu' to run on the CPU")
    return dev


def resident(key: tuple, build):
    """`build()`, made once per `key` (which names the device) and kept: on
    the card a host-to-device copy waits for the stream, and a CUDA graph's
    capture takes none, so a frame's constants are built on the first call
    of its shape and read from the device after that."""
    hit = _RESIDENT.get(key)
    if hit is None:
        hit = _RESIDENT.setdefault(key, build())
    return hit
