"""Weighted round-robin camera scheduler.

A copy of wild_visual_navigation_tpu/runtime/scheduler.py (it imports no JAX).

Same algorithm and API as the reference
(the reference repository's wild_visual_navigation_ros/src/wild_visual_navigation_ros/scheduler.py:6-66):
interleave processes proportionally to integer weights; `get()` returns
the current slot, `step()` advances. Used by the runtime to arbitrate
which camera's frame is processed each tick (multi-camera time-sharing,
SURVEY.md §2.4).
"""

from __future__ import annotations

from typing import Dict, List, Optional


class Scheduler:
    def __init__(self):
        self._processes: Dict[str, int] = {}
        self._schedule: List[str] = []
        self._idx = 0

    def add_process(self, name: str, weight: int = 1) -> None:
        self._processes[name] = weight
        self._make_schedule()

    def step(self) -> None:
        if self._schedule:
            self._idx = (self._idx + 1) % len(self._schedule)

    def get(self) -> Optional[str]:
        if not self._schedule:
            return None
        return self._schedule[self._idx]

    @property
    def schedule(self) -> List[str]:
        return self._schedule

    def _make_schedule(self) -> None:
        # Interleave: at round w, every process with weight > w emits one
        # slot (the reference's queue-popping construction, scheduler.py:44-64).
        self._schedule = []
        weights = list(self._processes.values())
        processes = list(self._processes.keys())
        for w in range(sum(weights)):
            for p, pw in zip(processes, weights):
                if pw > w:
                    self._schedule.append(p)
