"""Device memory observability.

Port of wild_visual_navigation_tpu/utils/device_monitor.py's memory
statistics: per-device allocated and peak memory from
`torch.cuda.memory_stats` and the card's total from
`torch.cuda.mem_get_info` (`tools/soak.py` gates on them). A CPU device
has no such statistics and reads zeros, as the JAX package reads zeros
from a backend without them. The reference's per-method and system-level
monitors are not ported: the runtime's counters and spans
(`utils/timers.py`, `WVNRuntime.counters()`) are the port's observability.
"""

from __future__ import annotations

import torch


def _device(device) -> torch.device:
    if device is None:
        return torch.device("cuda", torch.cuda.current_device()) if torch.cuda.is_available() else torch.device("cpu")
    return torch.device(device)


def device_memory_stats(device=None) -> dict:
    """bytes_in_use / peak_bytes_in_use / bytes_limit of one device (the
    allocator's live and peak bytes and the card's total memory), and
    peak_bytes_reserved, the most the caching allocator has held. The
    default device is the current card, or the CPU without one: zeros."""
    dev = _device(device)
    if dev.type != "cuda":
        return {"bytes_in_use": 0, "peak_bytes_in_use": 0, "bytes_limit": 0, "peak_bytes_reserved": 0}
    stats = torch.cuda.memory_stats(dev)
    return {
        "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
        "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
        "bytes_limit": torch.cuda.mem_get_info(dev)[1],
        "peak_bytes_reserved": stats.get("reserved_bytes.all.peak", 0),
    }

