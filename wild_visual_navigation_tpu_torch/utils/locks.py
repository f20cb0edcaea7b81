"""TrackedRLock — re-entrant lock with explicit, fail-safe ownership.

Port of wild_visual_navigation_tpu/utils/locks.py, kept in the port so
that it never imports the JAX package.

The online runtime's signal handler must decide whether the main
thread is inside an estimator critical section (if it is, shutdown is
deferred to the callback epilogue — running it inline would re-enter
the RLock and operate on a just-donated buffer pytree). The previous
implementation asked CPython's private ``RLock._is_owned``; when that
attribute is absent the fallback reported "not owned" and the handler
ran shutdown *inside* the critical section — failing UNSAFE.

This class tracks a per-thread entry depth explicitly, with the
ordering chosen so every race window reads as "owned":

  * the depth is incremented BEFORE the underlying acquire — a signal
    landing while the acquire is in flight (or blocked) sees depth > 0
    and defers;
  * the depth is decremented AFTER the underlying release — a signal
    landing mid-release still defers.

Deferring when not strictly necessary only delays shutdown to the next
callback epilogue; the reverse error corrupts the mission buffer.

The port's copy also measures the lock: `acquire` tries without blocking
first, and only an acquire that found the lock held by another thread
waits, inside a `lock_wait` span (utils/timers.py), a child of whatever
span the waiting thread is in. The counters `lock.acquired` and
`lock.contended` count the outermost acquisitions (a re-entrant one is
not counted) and those that waited; they are incremented while the lock
is held, and summed over every TrackedRLock of the process (the
estimator's lock is the port's only one, so one a runtime).
"""

from __future__ import annotations

import threading

from .timers import count, span


class TrackedRLock:
    """Drop-in ``threading.RLock`` replacement (context manager +
    acquire/release) with a ``held_by_current_thread`` property that
    never under-reports ownership."""

    def __init__(self):
        self._lock = threading.RLock()
        self._tls = threading.local()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        # Mark intent BEFORE acquiring: a signal handler interrupting
        # between these two lines must defer (fail safe).
        self._tls.depth = getattr(self._tls, "depth", 0) + 1
        ok = self._lock.acquire(False)
        if not ok and blocking:
            with span("lock_wait"):
                ok = self._lock.acquire(True, timeout)
            if ok:
                count("lock.contended")
        if not ok:
            self._tls.depth -= 1
            return False
        if self._tls.depth == 1:
            count("lock.acquired")
        return True

    def release(self) -> None:
        self._lock.release()
        # Decrement AFTER releasing: a signal mid-release still defers.
        self._tls.depth -= 1

    def __enter__(self) -> "TrackedRLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    @property
    def held_by_current_thread(self) -> bool:
        """True if this thread holds (or is entering / leaving) the
        lock. May briefly over-report around acquire/release — by
        design (the consumer defers shutdown on True)."""
        return getattr(self._tls, "depth", 0) > 0
