"""The program's own spans for the readers whose source is program_span
(not a metric: no entry of BENCHMARK.json names it).

The port records its spans (`wild_visual_navigation_tpu_torch/utils/timers.py`)
while a torch.profiler session records, so a traced run's profiled part
fills its ring; the readers read the ring in the run's process after the
window, the spans that start inside the traced interval. A program without
that ring gives no spans, and the readers then return None."""

from __future__ import annotations

import numpy as np


def spans(ctx) -> list:
    """The program's SpanRecords that start inside the traced interval."""
    if ctx.trace is None or ctx.timings.trace_interval is None:
        return []
    try:
        from wild_visual_navigation_tpu_torch.utils import timers
    except ImportError:
        return []
    snapshot = getattr(timers, "snapshot", None)
    if snapshot is None:
        return []
    t0, t1 = ctx.timings.trace_interval
    return [r for r in snapshot()["spans"] if t0 <= r.start_ns <= t1]


def ms(r) -> float:
    return (r.end_ns - r.start_ns) / 1e6


def median_ms(recs: list, name: str, per: float = 1.0):
    d = [ms(r) / per for r in recs if r.name == name]
    return float(np.median(d)) if d else None


def descendants(recs: list, root, names) -> list:
    """The records among `recs` opened inside `root` (on its thread, through
    their parent links) whose name passes `names` (a predicate)."""
    by_id = {r.span_id: r for r in recs}
    out = []
    for r in recs:
        if not names(r.name) or r.request != root.request:
            continue
        p = by_id.get(r.parent)
        while p is not None and p is not root:
            p = by_id.get(p.parent)
        if p is root:
            out.append(r)
    return out


def inside_frame(recs: list, r) -> bool:
    """Whether the record was opened inside a camera call's `frame` span."""
    by_id = {x.span_id: x for x in recs}
    p = by_id.get(r.parent)
    while p is not None:
        if p.name == "frame":
            return True
        p = by_id.get(p.parent)
    return False
