"""The traced window, reduced: device operations, the harness's spans, and
which span launched which operation.

From torch.profiler's kineto events (CPU and CUDA activity, every thread):
  * device operations: CUDA events that are not user annotations
    (kernels, copies, sets), each with its start, duration and name;
  * launches: CPU runtime calls (cudaLaunchKernel, cuLaunchKernelEx,
    cudaMemcpyAsync, ...) matched to a device operation by correlation
    id, which give the thread and the time of the launch;
  * spans: the harness's `record_function` ranges (`portbench.*`), with
    their thread.
A device operation belongs to the span of its launching thread that
contains the launch. `busy_s` is the length of the union of the device
operations' intervals inside the traced interval.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np

SPAN_PREFIX = "portbench."


@dataclass
class Span:
    name: str  # without the prefix
    tid: int
    start: int  # ns
    end: int
    ops: list = field(default_factory=list)  # indices into Trace.ops


@dataclass
class Trace:
    t0: int  # traced interval, ns
    t1: int
    names: list  # device operation names
    start: np.ndarray  # (n,) ns
    end: np.ndarray
    spans: list

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def spans_named(self, name: str) -> list:
        """Spans of one entry that lie inside the traced interval."""
        return [s for s in self.spans if s.name == name and s.start >= self.t0 and s.end <= self.t1]

    def busy_s(self) -> float:
        a, b = np.clip(self.start, self.t0, self.t1), np.clip(self.end, self.t0, self.t1)
        return union_length(a, b) / 1e9

    def op_ms(self, ops, match) -> list:
        """Durations (ms) of the operations among `ops` whose name contains one of `match`."""
        return [(self.end[i] - self.start[i]) / 1e6 for i in ops if any(m in self.names[i] for m in match)]

    def all_ops(self) -> range:
        return range(len(self.names))


def union_length(a: np.ndarray, b: np.ndarray) -> float:
    order = np.argsort(a, kind="stable")
    total, cur_s, cur_e = 0, None, None
    for s, e in zip(a[order], b[order]):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
    if cur_e is not None:
        total += cur_e - cur_s
    return float(total)


def reduce(events, t0: int, t1: int) -> Trace:
    """Kineto events -> Trace over [t0, t1] (time.time_ns() clock)."""
    names, starts, ends, corrs = [], [], [], []
    launches = {}
    spans_by_tid = defaultdict(list)
    for e in events:
        dev = str(e.device_type())
        ua = e.is_user_annotation()
        if dev.endswith("CUDA"):
            if not ua:
                names.append(e.name())
                starts.append(e.start_ns())
                ends.append(e.start_ns() + e.duration_ns())
                corrs.append(e.correlation_id())
        elif ua:
            if e.name().startswith(SPAN_PREFIX):
                tid, start = e.start_thread_id(), e.start_ns()
                spans_by_tid[tid].append(Span(e.name()[len(SPAN_PREFIX):], tid, start, start + e.duration_ns()))
        elif e.correlation_id():
            launches[e.correlation_id()] = (e.start_thread_id(), e.start_ns())
    for v in spans_by_tid.values():
        v.sort(key=lambda s: s.start)
    starts_by_tid = {tid: [s.start for s in v] for tid, v in spans_by_tid.items()}
    for i, c in enumerate(corrs):
        hit = launches.get(c)
        if hit is None or hit[0] not in spans_by_tid:
            continue
        tid, ts = hit
        k = bisect.bisect_right(starts_by_tid[tid], ts) - 1
        if k >= 0 and spans_by_tid[tid][k].end >= ts:
            spans_by_tid[tid][k].ops.append(i)
    spans = sorted((s for v in spans_by_tid.values() for s in v), key=lambda s: s.start)
    return Trace(t0, t1, names, np.asarray(starts, dtype=np.int64), np.asarray(ends, dtype=np.int64), spans)


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the idle time
    between them by what the host was doing then (the harness span
    covering the gap's middle, on any thread)."""
    inside = [i for i in tr.all_ops() if tr.start[i] >= tr.t0 and tr.end[i] <= tr.t1]
    by_name = defaultdict(float)
    for i in inside:
        by_name[tr.names[i][:96]] += (tr.end[i] - tr.start[i]) / 1e9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    a = np.sort(np.clip(tr.start, tr.t0, tr.t1))
    order = np.argsort(np.clip(tr.start, tr.t0, tr.t1), kind="stable")
    b = np.clip(tr.end, tr.t0, tr.t1)[order]
    gaps, cur = [], tr.t0
    for s, e in zip(a, b):
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if tr.t1 > cur:
        gaps.append((cur, tr.t1))
    spans = tr.spans
    span_starts = [s.start for s in spans]
    idle = defaultdict(float)
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        label = "no harness call (waiting for a due time)"
        k = bisect.bisect_right(span_starts, mid) - 1
        for j in range(max(0, k - 8), k + 1):
            if spans[j].start <= mid <= spans[j].end:
                label = "host inside " + spans[j].name
        idle[label] += (g1 - g0) / 1e9
    gaps_out = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in gaps_out]}
