"""Status monitoring + system-events journal.

Port of wild_visual_navigation_tpu/runtime/status.py (it imports no JAX).
The journal also feeds the port's counters (utils/timers.py): each event
counts as `events.<name>`, a cancelled callback as
`events.<name>.<reason>` (`events.image_callback_canceled.rate`,
`.scheduler`).

Equivalents of the reference feature-extractor node's status thread
(wvn_feature_extractor_node.py:238-271) — a periodic table of input
freshness with staleness coloring — and the learning node's
`_system_events` journal (wvn_learning_node.py:446-457, 540-548,
681-688): each callback records received/canceled/failed markers so a
stalled pipeline is diagnosable after the fact; exceptions are kept in
a bounded ring.
"""

from __future__ import annotations

import threading
import time
import traceback
from collections import deque
from typing import Callable, Dict, List, Optional

from ..utils.timers import count

_CANCELED = "canceled due to "


class SystemEvents:
    """Per-callback event journal (reference `_system_events`). Each
    event name holds its latest {time, value}; exceptions additionally
    land in a bounded ring for post-mortem dumps."""

    def __init__(self, max_errors: int = 64):
        self._events: Dict[str, dict] = {}
        self._errors: deque = deque(maxlen=max_errors)
        self._lock = threading.Lock()

    def record(self, name: str, value: str = "message received"):
        with self._lock:
            self._events[name] = {"time": time.time(), "value": value}
            count(f"events.{name}.{value[len(_CANCELED):]}" if value.startswith(_CANCELED) else f"events.{name}")

    def record_error(self, name: str, exc: BaseException):
        tb = "".join(traceback.format_exception(type(exc), exc, exc.__traceback__))
        with self._lock:
            self._events[name] = {"time": time.time(), "value": f"failed: {exc!r}"}
            self._errors.append({"time": time.time(), "name": name, "error": repr(exc), "traceback": tb})

    def snapshot(self) -> dict:
        with self._lock:
            return {"events": dict(self._events), "errors": list(self._errors)}

    def dump(self, path: str) -> str:
        import json
        import os

        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=2, default=str)
        return path


class StatusMonitor:
    def __init__(self, rate_hz: float = 0.5, stale_after: float = 1.0, printer: Optional[Callable] = print):
        self._rate = rate_hz
        self._stale_after = stale_after
        self._printer = printer
        self._last_seen: Dict[str, float] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def tick(self, name: str, stamp: Optional[float] = None):
        """Record activity on a monitored input."""
        with self._lock:
            self._last_seen[name] = stamp if stamp is not None else time.time()

    def rows(self, now: Optional[float] = None) -> List[dict]:
        now = now if now is not None else time.time()
        with self._lock:
            items = sorted(self._last_seen.items())
        out = []
        for name, t in items:
            age = now - t
            state = "ok" if age < self._stale_after else ("stale" if age < 5 * self._stale_after else "dead")
            out.append({"input": name, "age_s": round(age, 3), "state": state})
        return out

    def render(self, now: Optional[float] = None) -> str:
        rows = self.rows(now)
        if not rows:
            return "(no inputs seen yet)"
        w = max(len(r["input"]) for r in rows)
        lines = [f"{'input'.ljust(w)}  age_s   state"]
        for r in rows:
            lines.append(f"{r['input'].ljust(w)}  {r['age_s']:<6} {r['state']}")
        return "\n".join(lines)

    def start(self):
        def loop():
            period = 1.0 / self._rate
            while not self._stop.is_set():
                if self._printer is not None:
                    self._printer(self.render())
                self._stop.wait(period)

        self._stop.clear()
        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
