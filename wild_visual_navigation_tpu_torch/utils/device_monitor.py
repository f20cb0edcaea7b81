"""Device memory observability.

Port of wild_visual_navigation_tpu/utils/device_monitor.py, the
replacement for the reference's GPU-memory monitor suite: per-device
allocated and peak memory from `torch.cuda.memory_stats`, the card's total
from `torch.cuda.mem_get_info`, a decorator accumulating per-method deltas,
and a system-level monitor that samples on demand and stores CSVs per
mission. A CPU device has no such statistics and reads zeros, as the JAX
package reads zeros from a backend without them.
"""

from __future__ import annotations

import os
import time
from collections import defaultdict
from functools import wraps

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


def get_device_memory_usage_mb(device=None) -> float:
    return device_memory_stats(device)["bytes_in_use"] / 2**20


class DeviceMonitor:
    """Context manager printing the device-memory delta of a block (the
    reference's GpuMonitor context manager)."""

    def __init__(self, name: str = "", verbose: bool = True, device=None):
        self.name = name
        self.verbose = verbose
        self.device = device

    def __enter__(self):
        self._before = get_device_memory_usage_mb(self.device)
        return self

    def __exit__(self, *exc):
        after = get_device_memory_usage_mb(self.device)
        self.delta_mb = after - self._before
        if self.verbose:
            print(f"Memory {self.name}: {self.delta_mb:+.2f} MB (now {after:.1f} MB)")
        return False


def accumulate_memory(fn):
    """Method decorator storing per-call (time, delta-MB) samples on the
    instance, as the reference's accumulate_memory does."""

    @wraps(fn)
    def wrapper(self, *args, **kwargs):
        before = get_device_memory_usage_mb()
        t0 = time.perf_counter()
        out = fn(self, *args, **kwargs)
        dt = time.perf_counter() - t0
        after = get_device_memory_usage_mb()
        if not hasattr(self, "_memory_samples"):
            self._memory_samples = defaultdict(list)
        self._memory_samples[fn.__name__].append({"time_s": dt, "delta_mb": after - before, "total_mb": after})
        return out

    return wrapper


class SystemLevelDeviceMonitor:
    """Samples device memory for a set of tagged objects and dumps CSVs (the
    reference's SystemLevelGpuMonitor)."""

    def __init__(self, objects, names, enabled: bool = True, device=None):
        self._objects = objects
        self._names = names
        self._enabled = enabled
        self._device = device
        self._samples = []

    def update(self, step: int):
        if not self._enabled:
            return
        s = device_memory_stats(self._device)
        self._samples.append({"step": step, **s, "t": time.time()})

    def store(self, folder: str):
        os.makedirs(folder, exist_ok=True)
        path = os.path.join(folder, "device_memory.csv")
        with open(path, "w") as f:
            f.write("step,t,bytes_in_use,peak_bytes_in_use,bytes_limit\n")
            for s in self._samples:
                f.write(f"{s['step']},{s['t']},{s['bytes_in_use']},{s['peak_bytes_in_use']},{s['bytes_limit']}\n")
        # per-object accumulate_memory dumps
        for obj, name in zip(self._objects, self._names):
            samples = getattr(obj, "_memory_samples", None)
            if not samples:
                continue
            p = os.path.join(folder, f"memory_{name}.csv")
            with open(p, "w") as f:
                f.write("method,time_s,delta_mb,total_mb\n")
                for method, rows in samples.items():
                    for r in rows:
                        f.write(f"{method},{r['time_s']:.6f},{r['delta_mb']:.3f},{r['total_mb']:.3f}\n")
        return path
