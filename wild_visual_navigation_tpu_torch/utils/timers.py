"""The port's tracing: spans and counters inside the program.

  * `span(name, cpu=False)`: a context manager around one stage of a request. Off by
    default: it then checks one module-level flag and returns a shared
    no-op context, entering nothing of torch.profiler and reading no clock.
    On, it opens a `torch.profiler.record_function("wvn.<name>")` range, so
    the stage sits in a profiler's trace on the device trace's clock, and
    appends a `SpanRecord` to a bounded ring (the oldest dropped first);
  * `new_request()`: called where a request enters the runtime (a camera
    call, a supervision callback, a learner tick); the spans a thread opens
    until its next request share the request's id;
  * `count(name, n=1)`: integer counters, always on;
  * `set_tracing(on)`, `snapshot()` (the ring's records and the counters)
    and `reset()`.

Spans are on between `set_tracing(True)` and `set_tracing(False)`, and
while a torch.profiler session records: each `new_request` looks at
torch's own flag for that (`torch.autograd.profiler._is_profiler_enabled`,
a module attribute that profiler sessions set and clear), so a profile of
the runtime holds the program's stages without a call into this module,
and pays their cost; after the session the spans stay on until the
thread's next request. This second switch is for a profiler whose owner
cannot call `set_tracing`; once every such owner calls it, it goes.

A record's start and end are `time.time_ns()`, the clock of the profiler's
events. A span opened with `cpu=True` (only `frame.dispatch`) also records
the thread's CPU time inside it (`time.thread_time_ns()`), so its wall time
minus its CPU time is the time the thread was runnable or blocked but not
running; the others record -1. The thread's CPU clock is read nowhere else:
on the H100 hosts it was measured on it ticks in 10 ms steps, and one read
inside a frame took 0.14-0.2 ms. The ring, the counters and the flag are
the process's: every runtime of a process shares them.

`profile_trace` records a torch.profiler trace of every thread, the
program's spans on, and writes it as a Chrome trace into `log_dir`.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from collections import defaultdict, deque
from typing import NamedTuple

import torch.autograd.profiler as _autograd_profiler
from torch.profiler import record_function

RING_CAPACITY = 16384  # records; a 10-s window at ~20 spans per 100-ms frame and tick fills an eighth of it
PREFIX = "wvn."


class SpanRecord(NamedTuple):
    name: str
    request: int  # shared by the spans of one request (0: opened before any request on this thread)
    span_id: int
    parent: int  # span_id of the span it was opened in on this thread, 0 at the request's root
    thread: int  # threading.get_native_id()
    start_ns: int  # time.time_ns()
    end_ns: int
    cpu_ns: int  # the thread's CPU time between start and end; -1 unless the span was opened with cpu=True


_forced = False  # set_tracing
_on = False  # what span() checks: _forced, or a profiler session recording at the last new_request
_ring: deque = deque(maxlen=RING_CAPACITY)
_counts: defaultdict = defaultdict(int)
_ids = itertools.count(1)
_tls = threading.local()
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "cpu", "rf", "span_id", "parent", "request", "stack", "thread", "t0", "c0")

    def __init__(self, name: str, cpu: bool):
        self.name, self.cpu = name, cpu

    def __enter__(self):
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
            _tls.thread = threading.get_native_id()  # a system call: once per thread
        self.stack, self.thread = stack, _tls.thread
        self.parent = stack[-1].span_id if stack else 0
        self.request = getattr(_tls, "request", 0)
        self.span_id = next(_ids)
        stack.append(self)
        self.rf = record_function(PREFIX + self.name)
        self.rf.__enter__()
        self.c0 = time.thread_time_ns() if self.cpu else 0
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        cpu = time.thread_time_ns() - self.c0 if self.cpu else -1
        self.rf.__exit__(*exc)
        self.stack.pop()
        _ring.append(SpanRecord(self.name, self.request, self.span_id, self.parent, self.thread, self.t0, t1, cpu))
        return False


def span(name: str, cpu: bool = False):
    """A span named `name` (recorded as "wvn.<name>") while tracing is on,
    with the thread's CPU time inside it when `cpu`; a shared no-op context
    otherwise."""
    if not _on:
        return _OFF
    return _Span(name, cpu)


def new_request() -> None:
    """A request enters the runtime on this thread: tracing follows
    `set_tracing` or a recording profiler session from here, and the spans
    this thread opens share a new request id."""
    global _on
    _on = _forced or getattr(_autograd_profiler, "_is_profiler_enabled", False)
    if _on:
        _tls.request = next(_ids)


def count(name: str, n: int = 1) -> None:
    """Add n to a counter. The update takes no lock of its own: a counter
    is exact where one lock serialises its sites (the estimator's counters
    under the estimator's lock, a journal's events under the journal's),
    and approximate where threads under different locks count one name at
    once (two runtimes in one process), since CPython does not promise
    that `+=` on a dict item is atomic."""
    _counts[name] += n


def set_tracing(on: bool) -> None:
    """Turn the spans on or off for every thread, from the next span on."""
    global _forced, _on
    _forced = _on = bool(on)


def snapshot() -> dict:
    """{"spans": the ring's SpanRecords, oldest first, "counters": {name: n}}."""
    return {"spans": list(_ring), "counters": dict(_counts)}


def reset() -> None:
    """Empty the ring and zero the counters (the flag stays as it is)."""
    _ring.clear()
    _counts.clear()


@contextlib.contextmanager
def profile_trace(log_dir: str = "traces", enabled: bool = True):
    """torch.profiler over the block on every thread (the learning thread's
    work included), the card's kernels included when a card is present, and
    the program's spans on; the trace is written to `log_dir`/trace.json
    (open it in Perfetto or chrome://tracing, where each stage is a "wvn."
    range on its thread). Yields the profiler (None when disabled)."""
    if not enabled:
        yield None
        return
    import torch
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    was = _forced
    set_tracing(True)
    try:
        with profile(activities=activities, experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
            yield prof
    finally:
        set_tracing(was)
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
