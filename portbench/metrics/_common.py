"""Shared arithmetic of the metric readers (not a metric: no entry of
BENCHMARK.json names it)."""

from __future__ import annotations

import numpy as np


def percentile_ms(lat_s: list, failed: int, window_s: float, q: float):
    """The q-th percentile (numpy's linear rule) of every attempt's latency in
    ms; a failed attempt counts as the whole window. None without attempts."""
    vals = [x * 1e3 for x in lat_s] + [window_s * 1e3] * failed
    return float(np.percentile(vals, q)) if vals else None


def frame_spans(tr, cameras: int):
    """The entry spans that carry camera frames, and frames per span."""
    if cameras > 1:
        return tr.spans_named("image_batch_callback"), cameras
    return tr.spans_named("image_callback"), 1


def kernel_share(tr, match, bound_s: float):
    """bound / mean duration of the matching kernels, in %; None without any."""
    ms = tr.op_ms(tr.all_ops(), match)
    if not ms:
        return None
    return 100.0 * bound_s * 1e3 / (sum(ms) / len(ms))


def median_span_ms(tr, name: str):
    d = [(s.end - s.start) / 1e6 for s in tr.spans_named(name)]
    return float(np.median(d)) if d else None


def unprofiled(lat_s: list, due_s: list, profiled, period_s: float) -> list:
    """The latencies of the calls that the profiler did not hold up: those
    due before it started, and those due after its stop returned once the
    loop has caught up (from the first call, in due order, that took less
    than a period). All of them where nothing was profiled or the dues are
    not recorded."""
    if profiled is None or len(due_s) != len(lat_s):
        return list(lat_s)
    start, stop = profiled
    order = sorted(range(len(lat_s)), key=lambda k: due_s[k])
    kept, caught_up = [], False
    for k in order:
        if due_s[k] < start:
            kept.append(lat_s[k])
        elif due_s[k] >= stop:
            caught_up = caught_up or lat_s[k] < period_s
            if caught_up:
                kept.append(lat_s[k])
    return kept
