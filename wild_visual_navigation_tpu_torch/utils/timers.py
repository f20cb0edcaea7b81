"""Timing and tracing utilities.

Port of wild_visual_navigation_tpu/utils/timers.py, the replacement for the
reference's `pytictac` usage, with the same surface:

  * `Timer`: a context manager printing the elapsed time;
  * `ClassContextTimer`: a context manager accumulating into an object;
  * `@accumulate_time`: a method decorator storing per-call times on the
    instance (`_timers`);
  * `ClassTimer`: aggregates and formats those statistics; `.store(folder)`
    writes them as CSV per mission, like the reference's timing dumps.

CUDA launches return before the card finishes, so `accumulate_time(block=True)`
synchronises the device of every CUDA tensor in the result before it reads
the clock, where the JAX package calls `block_until_ready`. `profile_trace`
records a torch.profiler trace of the host and the card and writes it as a
Chrome trace into `log_dir`.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from functools import wraps

import numpy as np
import torch


def _cuda_devices(out) -> set:
    """The CUDA devices of the tensors in a result (nested tuples, lists and
    dicts are searched)."""
    if isinstance(out, torch.Tensor):
        return {out.device} if out.is_cuda else set()
    if isinstance(out, dict):
        out = out.values()
    elif not isinstance(out, (tuple, list)):
        return set()
    devs = set()
    for o in out:
        devs |= _cuda_devices(o)
    return devs


def block_until_ready(out):
    """Wait for the card to finish the work that produces `out`; returns it."""
    for dev in _cuda_devices(out):
        torch.cuda.synchronize(dev)
    return out


class Timer:
    def __init__(self, name: str = "", verbose: bool = True):
        self.name = name
        self.verbose = verbose
        self.elapsed = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        if self.verbose:
            print(f"Time {self.name}: {self.elapsed * 1e3:.2f} ms")
        return False


def accumulate_time(method=None, *, block: bool = False):
    """Decorator: accumulate per-call wall time into `self._timers`."""

    def deco(fn):
        @wraps(fn)
        def wrapper(self, *args, **kwargs):
            t0 = time.perf_counter()
            out = fn(self, *args, **kwargs)
            if block:
                block_until_ready(out)
            dt = time.perf_counter() - t0
            if not hasattr(self, "_timers"):
                self._timers = defaultdict(list)
            self._timers[fn.__name__].append(dt)
            return out

        return wrapper

    if method is not None:
        return deco(method)
    return deco


class ClassTimer:
    """Aggregate the `_timers` of several objects."""

    def __init__(self, objects, names, enabled: bool = True):
        self._objects = objects
        self._names = names
        self._enabled = enabled

    def rows(self):
        out = []
        for obj, name in zip(self._objects, self._names):
            for method, samples in sorted(getattr(obj, "_timers", {}).items()):
                a = np.asarray(samples) * 1e3
                out.append(
                    {
                        "object": name,
                        "method": method,
                        "calls": len(a),
                        "mean_ms": float(a.mean()),
                        "p50_ms": float(np.percentile(a, 50)),
                        "p95_ms": float(np.percentile(a, 95)),
                        "total_s": float(a.sum() / 1e3),
                    }
                )
        return out

    def __str__(self):
        if not self._enabled:
            return ""
        lines = []
        for r in self.rows():
            lines.append(
                f"{r['object']}.{r['method']}: n={r['calls']} mean={r['mean_ms']:.2f}ms "
                f"p50={r['p50_ms']:.2f}ms p95={r['p95_ms']:.2f}ms total={r['total_s']:.2f}s"
            )
        return "\n".join(lines)

    def store(self, folder: str, filename: str = "timings.csv"):
        os.makedirs(folder, exist_ok=True)
        rows = self.rows()
        path = os.path.join(folder, filename)
        with open(path, "w") as f:
            f.write("object,method,calls,mean_ms,p50_ms,p95_ms,total_s\n")
            for r in rows:
                f.write(
                    f"{r['object']},{r['method']},{r['calls']},{r['mean_ms']:.4f},"
                    f"{r['p50_ms']:.4f},{r['p95_ms']:.4f},{r['total_s']:.4f}\n"
                )
        return path


class ClassContextTimer:
    """Context manager accumulating into an object's `_timers` under a
    given name (the reference's ClassContextTimer around the train step)."""

    def __init__(self, parent_obj, block_name: str, parent_method_name: str = ""):
        self._obj = parent_obj
        self._name = block_name

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        if not hasattr(self._obj, "_timers"):
            self._obj._timers = defaultdict(list)
        self._obj._timers[self._name].append(dt)
        return False


@contextlib.contextmanager
def profile_trace(log_dir: str = "traces", enabled: bool = True):
    """torch.profiler over the block, the card's kernels included when a card
    is present; the trace is written to `log_dir`/trace.json (open it in
    Perfetto or chrome://tracing). Yields the profiler (None when disabled)."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
