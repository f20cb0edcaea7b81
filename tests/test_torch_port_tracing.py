"""The port's tracing (utils/timers.py) and its estimator lock's
measurement (utils/locks.py), on the CPU: spans off cost no profiler call
and no clock read, spans on nest and share a request id, the ring stays
bounded, a span's record sits on the profiler's clock, a contended
TrackedRLock gives one lock_wait span and one contended count, and spans
follow a torch.profiler session. Imports no JAX."""

import statistics
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from wild_visual_navigation_tpu_torch.utils import timers
from wild_visual_navigation_tpu_torch.utils.locks import TrackedRLock

CLOCK_GAP_NS = 50_000  # a span's recorded start against its "wvn." event's start, median over spans


@pytest.fixture(autouse=True)
def clean_tracing():
    timers.set_tracing(False)
    timers.reset()
    yield
    timers.set_tracing(False)
    timers.reset()


class _Raises:
    def __getattr__(self, name):
        raise AssertionError(f"time.{name} read while tracing is off")


def test_span_off_records_nothing_and_enters_no_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered while tracing is off")

    monkeypatch.setattr(timers, "record_function", refuse)
    monkeypatch.setattr(timers, "time", _Raises())
    timers.new_request()
    with timers.span("frame"):
        with timers.span("frame.dispatch"):
            pass
    assert timers.span("a") is timers.span("b")  # one shared no-op context
    assert timers.snapshot()["spans"] == []


def test_span_on_nests_shares_the_request_and_stays_bounded(monkeypatch):
    timers.set_tracing(True)
    timers.new_request()
    with timers.span("frame") as outer:
        with timers.span("frame.dispatch", cpu=True) as inner:
            sum(range(20000))
        with timers.span("frame.insert"):
            pass
    timers.new_request()
    with timers.span("supervision"):
        pass
    recs = {r.name: r for r in timers.snapshot()["spans"]}
    assert list(recs) == ["frame.dispatch", "frame.insert", "frame", "supervision"]  # in the order they ended
    f, d, i, s = recs["frame"], recs["frame.dispatch"], recs["frame.insert"], recs["supervision"]
    assert f.parent == 0 and d.parent == i.parent == f.span_id == outer.span_id and d.span_id == inner.span_id
    assert f.request == d.request == i.request != s.request and s.parent == 0
    assert f.start_ns <= d.start_ns <= d.end_ns <= i.start_ns <= i.end_ns <= f.end_ns
    assert f.thread == d.thread == threading.get_native_id() and d.cpu_ns > 0 and f.cpu_ns == i.cpu_ns == -1
    monkeypatch.setattr(timers, "_ring", timers.deque(maxlen=8))
    for k in range(20):
        with timers.span(f"s{k}"):
            pass
    assert [r.name for r in timers.snapshot()["spans"]] == [f"s{k}" for k in range(12, 20)]  # oldest dropped
    assert timers.RING_CAPACITY >= 16384


def test_span_start_sits_on_the_profiler_clock():
    timers.set_tracing(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        timers.new_request()
        for k in range(40):
            with timers.span("probe"):
                torch.ones(8).sum()
    starts = sorted(e.start_ns() for e in prof.profiler.kineto_results.events() if e.name() == "wvn.probe")
    recs = sorted(r.start_ns for r in timers.snapshot()["spans"] if r.name == "probe")
    assert len(starts) == len(recs) == 40
    assert statistics.median(abs(a - b) for a, b in zip(starts, recs)) < CLOCK_GAP_NS


def test_spans_follow_a_profiler_session():
    """Off by default; on from the first request inside a profiler session;
    off again from the first request after it."""
    timers.new_request()
    with timers.span("before"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        timers.new_request()
        with timers.span("during"):
            pass
    timers.new_request()
    with timers.span("after"):
        pass
    assert [r.name for r in timers.snapshot()["spans"]] == ["during"]


def test_contended_lock_gives_one_wait_span_and_one_count():
    timers.set_tracing(True)
    lock = TrackedRLock()
    held, seen = threading.Event(), {}

    def holder():
        with lock:
            seen["holder_owns"] = lock.held_by_current_thread
            held.set()
            time.sleep(0.2)
        seen["holder_after"] = lock.held_by_current_thread

    t = threading.Thread(target=holder)
    t.start()
    assert held.wait(5.0)
    seen["waiter_before"] = lock.held_by_current_thread
    timers.new_request()
    with timers.span("frame.insert"):
        with lock:
            seen["waiter_inside"] = lock.held_by_current_thread
            with lock:  # re-entrant: no wait
                pass
    t.join(5.0)
    assert not t.is_alive()
    assert seen == {"holder_owns": True, "waiter_before": False, "waiter_inside": True, "holder_after": False}
    assert not lock.held_by_current_thread
    snap = timers.snapshot()
    waits = [r for r in snap["spans"] if r.name == "lock_wait"]
    insert = next(r for r in snap["spans"] if r.name == "frame.insert")
    assert len(waits) == 1 and waits[0].parent == insert.span_id and waits[0].thread == threading.get_native_id()
    assert waits[0].end_ns - waits[0].start_ns > 50e6  # it waited for the holder's sleep
    assert snap["counters"]["lock.contended"] == 1 and snap["counters"]["lock.acquired"] == 2  # re-entry not counted
    assert lock.acquire(blocking=False)  # a free lock: taken at once, uncontended
    lock.release()
    assert not lock.held_by_current_thread and timers.snapshot()["counters"]["lock.contended"] == 1
