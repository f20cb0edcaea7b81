"""The loops that drive the system under test.

The system is the port's WVNRuntime that the cell's pipeline builds from
a configuration file with the benchmark's seeded weights
(`pipelines/<name>.py::build_runtime`). The loops call its entries as a
robot would: `image_callback` or `image_batch_callback` for the cameras,
then `InferenceResult.to_numpy` (the maps on the host, as the planner
takes them), and the learner tick, `robot_state_callback` followed by
`learning_step`, ended by an event recorded after it and synchronized.
Each call sits in a `torch.profiler.record_function` span named
`portbench.<entry>`, which the traced run reads.

`Recorder` keeps, for calls drawn from the seed, what the check compares:
the maps a frame put on the host, the segment features and ids it wrote
to the mission buffer, and the head it read; a flush's fan-out rows
before and after it; a train step's head, Adam moments, confidence state,
batch rows and loss. It wraps the estimator's `_reproject_update` and
`_train_step` on the instance to copy those rows; unsampled calls pass
straight through. It also wraps the runtime's `hot_swap`, to keep the
learner's parameters and confidence state as each publish found them
(the last few), so that a frame's head is checked against the learner's.
"""

from __future__ import annotations

import os
import sys
import threading
import time
import traceback
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch
from torch.profiler import record_function


@dataclass
class Recorder:
    """Sampled calls' outputs and state, kept for the check."""

    frames: list = field(default_factory=list)
    flushes: list = field(default_factory=list)
    steps: list = field(default_factory=list)
    skipped: dict = field(default_factory=lambda: {"frame_head_swapped": 0})
    # what a sampled call asked for and has not had yet: a flush, a train
    # step, a frame that wrote a buffer row; the next such call supplies it
    want_flush: bool = False
    want_step: bool = False
    want_row: bool = False
    # the learner's state at the last publishes: {"head": the published module, "params", "cg": (mean, std)}
    published: deque = field(default_factory=lambda: deque(maxlen=8))
    lock: threading.Lock = field(default_factory=threading.Lock)

    def install(self, rt, first: tuple) -> None:
        """`first`: (head state dict, (mean, std)) that the runtime was
        built with, which it has published."""
        est = rt.estimator
        reproject, train_step, hot_swap = est._reproject_update, est._train_step, rt.hot_swap
        self.published.append({"head": rt.inference_head[0], "params": first[0], "cg": first[1]})

        def recorded_hot_swap():
            cg = est.confidence_state
            pub = {"params": {k: v.detach().clone() for k, v in est.model.state_dict().items()},
                   "cg": (cg.mean.clone(), cg.std.clone())}
            hot_swap()
            pub["head"] = rt.inference_head[0]
            with self.lock:
                self.published.append(pub)

        def sampled_reproject(idx, footprint, trav):
            if not self.want_flush:
                return reproject(idx, footprint, trav)
            self.want_flush = False
            buf = est.buffer
            cap = buf.capacity
            sel = torch.as_tensor(np.clip(idx, 0, cap - 1), dtype=torch.long, device=buf.features.device)
            before = {"mask": buf.supervision_mask[sel].clone(), "K": buf.K[sel].clone(),
                      "pose": buf.pose_cam_in_world[sel].clone(), "seg": buf.seg[sel].clone()}
            out = reproject(idx, footprint, trav)
            rows = np.flatnonzero(np.asarray(idx) < cap)
            s = torch.as_tensor(np.asarray(idx)[rows], dtype=torch.long, device=sel.device)
            after = {"mask": buf.supervision_mask[s].clone(), "signal": buf.signal[s].clone(),
                     "signal_valid": buf.signal_valid[s].clone()}
            self.flushes.append({"idx": np.array(idx), "rows": rows, "footprint": np.array(footprint),
                                 "trav": float(trav), "before": before, "after": after})
            return out

        def sampled_train_step(idx):
            if not self.want_step:
                return train_step(idx)
            self.want_step = False
            model, opt, buf = est.model, est.optimizer, est.buffer
            named = list(model.named_parameters())
            adam = {}
            for n, p in named:
                st = opt.state.get(p)
                adam[n] = ((st["exp_avg"].clone(), st["exp_avg_sq"].clone(), float(st["step"])) if st else
                           (torch.zeros_like(p.detach()), torch.zeros_like(p.detach()), 0.0))
            i = torch.as_tensor(np.asarray(idx), dtype=torch.long, device=buf.features.device)
            rec = {"idx": np.array(idx), "before": {n: p.detach().clone() for n, p in named}, "adam": adam,
                   "cg": (est.confidence_state.mean.clone(), est.confidence_state.std.clone()),
                   "rows": {"features": buf.features[i].clone(), "signal": buf.signal[i].clone(),
                            "signal_valid": buf.signal_valid[i].clone(), "feat_valid": buf.feat_valid[i].clone(),
                            "valid": buf.valid[i].clone()}}
            loss, aux = train_step(idx)
            cg = est.confidence_state
            rec.update(loss=loss.detach().clone(), after={n: p.detach().clone() for n, p in named},
                       cg_after=(cg.mean.clone(), cg.std.clone()))
            self.steps.append(rec)
            return loss, aux

        est._reproject_update = sampled_reproject
        est._train_step = sampled_train_step
        rt.hot_swap = recorded_hot_swap

    def frame(self, rt, event_index: int, camera: int, stamp: float, head_before, maps, sampled: bool) -> None:
        """Keep a sampled frame: its maps on the host and the buffer row it
        wrote (None when the mission graph gated the frame's node). A
        sampled frame without a row asks for the next frame that writes
        one, which is kept too."""
        if not (sampled or self.want_row):
            return
        head_after = rt.inference_head
        if head_after[0] is not head_before[0]:
            self.skipped["frame_head_swapped"] += 1
            self.want_row = True
            return
        est = rt.estimator
        row = None
        with est.lock:
            for slot, node in est._slot_to_node.items():
                if node.timestamp == float(stamp):
                    buf = est.buffer
                    row = {"slot": slot, "features": buf.features[slot].clone(),
                           "feat_valid": buf.feat_valid[slot].clone(), "seg": buf.seg[slot].clone()}
                    break
        if row is not None:
            self.want_row = False
        elif not sampled:
            return
        else:
            self.want_row = True
        head, cg = head_before
        with self.lock:
            pub = next((p for p in reversed(self.published) if p["head"] is head), None)
        self.frames.append({"event": event_index, "camera": camera, "head": head, "cg": (cg.mean, cg.std),
                            "pub": pub, "trav": maps[0], "conf": maps[1], "row": row})


@dataclass
class Timings:
    """Host-clock samples of one window, in seconds."""

    frame_lat: list = field(default_factory=list)  # per camera frame whose maps reached the host
    frames_failed: int = 0
    frames_attempted: int = 0
    tick_lat: list = field(default_factory=list)
    ticks_failed: int = 0
    ticks_attempted: int = 0
    window_s: float = 0.0
    frame_at: list = field(default_factory=list)  # when each frame's maps reached the host, from the window's start
    lateness: list = field(default_factory=list)  # how late the open loop's camera started each frame
    trace_interval: tuple | None = None  # (start_ns, end_ns) of the traced part, time.time_ns()
    frame_due: list = field(default_factory=list)  # each frame_lat's due time, from the window's start (open loop)
    tick_due: list = field(default_factory=list)  # each tick_lat's due time (closed loop: start), from the window's start
    profiled: tuple | None = None  # (profiler started, its stop returned), from the window's start
    host: list = field(default_factory=list)  # host_sample() at the window's start and every BLOCK_S of it


BLOCK_S = 5.0


def host_sample(t0: float) -> tuple:
    """(seconds from t0, this process's CPU seconds, the machine's busy CPU
    seconds summed over its CPUs, its steal seconds, its 1-minute load
    average), from os.times and /proc; the machine's figures 0 where
    /proc is unreadable."""
    t = os.times()
    busy = steal = load = 0.0
    try:
        with open("/proc/stat") as f:
            j = [int(x) for x in f.readline().split()[1:9]]
        tick = os.sysconf("SC_CLK_TCK")
        busy, steal = (j[0] + j[1] + j[2] + j[5] + j[6]) / tick, j[7] / tick
        load = os.getloadavg()[0]
    except (OSError, IndexError, ValueError):
        pass
    return time.perf_counter() - t0, t.user + t.system, busy, steal, load


class _HostBlocks:
    """Takes a host_sample at each BLOCK_S boundary that a loop passes."""

    def __init__(self, timings: Timings, t0: float):
        self.timings, self.t0, self.next = timings, t0, BLOCK_S
        timings.host.append(host_sample(t0))

    def tick(self) -> None:
        if time.perf_counter() - self.t0 >= self.next:
            self.timings.host.append(host_sample(self.t0))
            self.next += BLOCK_S

    def close(self) -> None:
        self.timings.host.append(host_sample(self.t0))


class Sampler:
    """Calls drawn from the seed by time: the first call that starts at or
    after each of the drawn instants of the window (seconds from its start)
    is sampled, so the sample covers the window whatever the call rate."""

    def __init__(self, times):
        self.times, self.next = list(times), 0

    def take(self, elapsed: float) -> bool:
        hit = False
        while self.next < len(self.times) and self.times[self.next] <= elapsed:
            self.next += 1
            hit = True
        return hit


def _sleep_until(t: float) -> None:
    while True:
        left = t - time.perf_counter()
        if left <= 0:
            return
        time.sleep(left if left > 2e-3 else 0)


def _sync() -> None:
    if torch.cuda.is_available():
        ev = torch.cuda.Event()
        ev.record()
        ev.synchronize()


class Caller:
    """Calls into the runtime for one traffic mix; `warm` runs the
    pre-roll at virtual time, `window` the measured loop."""

    def __init__(self, rt, traffic, mix: dict, recorder: Recorder):
        self.rt, self.traffic, self.mix, self.rec = rt, traffic, mix, recorder
        self.cams = [f"cam{c}" for c in range(traffic.cameras)]
        self.next_event = 0

    # --- the calls
    def _frame(self, i: int, sample: bool):
        """Camera frame(s) of event i to the host. Returns the seconds at
        which each camera's maps reached the host (None: gated)."""
        ev, rt, tr = self.traffic.event(i), self.rt, self.traffic
        watch = sample or self.rec.want_row
        head = rt.inference_head if watch else None
        done = []
        if tr.cameras == 1:
            with record_function("portbench.image_callback"):
                res = rt.image_callback(ev.images[0], ev.stamp, self.cams[0], tr.K, tr.size, tr.size, ev.pose_base,
                                        tr.cam_in_base[0])
            if res is None:
                return [None]
            with record_function("portbench.to_numpy"):
                maps = res.to_numpy()
            done.append(time.perf_counter())
            if watch:
                self.rec.frame(rt, i, 0, ev.stamp, head, maps, sample)
            return done
        B = tr.cameras
        stamps = [ev.stamp + 0.001 * c for c in range(B)]
        with record_function("portbench.image_batch_callback"):
            res = rt.image_batch_callback(tr.batch(i), stamps, self.cams, tr.Ks, tr.size, tr.size,
                                          np.stack([ev.pose_base] * B), np.stack(tr.cam_in_base))
        if len(res) != B:
            return [None] * B
        for c, r in enumerate(res):
            with record_function("portbench.to_numpy"):
                maps = r.to_numpy()
            done.append(time.perf_counter())
            if watch:
                self.rec.frame(rt, i, c, stamps[c], head, maps, sample)
        return done

    def _tick(self, j: int, sample: bool) -> None:
        ev, rt = self.traffic.event(j), self.rt
        if sample:
            self.rec.want_flush = self.rec.want_step = True
        with record_function("portbench.robot_state_callback"):
            rt.robot_state_callback(ev.state_stamp, ev.pose_base, ev.current_twist, ev.desired_twist)
        with record_function("portbench.learning_step"):
            rt.learning_step()
        _sync()

    # --- set-up
    def warm(self) -> int:
        """The pre-roll: events at virtual time through the same calls
        until the learner has taken `preroll_train_steps` steps (with the
        learner) or `warm_events` events have run. Returns events run."""
        learner = self.mix.get("learner", False)
        steps = int(self.mix.get("preroll_train_steps", 0))
        n_min, n_max = int(self.mix.get("warm_events", 20)), int(self.mix.get("preroll_max_events", 400))
        i = 0
        while i < n_max:
            self._frame(self.next_event + i, False)
            if learner:
                self._tick(self.next_event + i, False)
            i += 1
            if i >= n_min and (not learner or self.rt.estimator.step >= steps):
                break
        if learner and self.rt.estimator.step < steps:
            raise RuntimeError(f"pre-roll: {self.rt.estimator.step} train steps after {i} events, {steps} needed")
        _sync()
        self.next_event += i
        return i

    # --- the window
    def window(self, seconds: float, rng: np.random.RandomState, profiler=None) -> Timings:
        if self.mix["loop"] == "open":
            return self._open(seconds, rng, profiler)
        return self._closed(seconds, rng, profiler)

    def _samples(self, rng, seconds: float, key: str) -> "Sampler":
        return Sampler(np.sort(rng.uniform(0.0, 0.95 * seconds, int(self.mix.get(key, 0)))))

    def _open(self, seconds, rng, profiler) -> Timings:
        """Two threads: the camera at `period_s` and the learner at
        `learner_period_s`, each from its due times."""
        mix, T = self.mix, Timings()
        period, lperiod = float(mix["period_s"]), float(mix.get("learner_period_s", mix["period_s"]))
        n = int(round(seconds / period))
        m = int((seconds - float(mix.get("learner_phase_s", 0.0))) / lperiod)
        frame_samples = self._samples(rng, seconds, "sample_frames")
        tick_samples = self._samples(rng, seconds, "sample_ticks")
        base = self.next_event
        self.traffic.prepare(base, base + max(n, m) + 1)
        t0 = time.perf_counter() + 0.05
        trace_from = int(float(mix.get("trace_after_s", 1.0)) / period)
        trace_to = trace_from + int(float(mix.get("trace_seconds", 5.0)) / period)
        errors = []

        def learner():
            for j in range(m):
                due = t0 + float(mix.get("learner_phase_s", 0.0)) + j * lperiod
                _sleep_until(due)
                T.ticks_attempted += 1
                try:
                    self._tick(base + j, tick_samples.take(due - t0))
                    T.tick_lat.append(time.perf_counter() - due)
                    T.tick_due.append(due - t0)
                except Exception:  # a tick that raises counts as failed; the loop goes on
                    T.ticks_failed += 1
                    errors.append(traceback.format_exc())

        th = threading.Thread(target=learner, name="portbench-learner")
        blocks = _HostBlocks(T, t0)
        th.start()
        try:
            for i in range(n):
                due = t0 + i * period
                _sleep_until(due)
                blocks.tick()
                if profiler is not None and i == trace_from:
                    p0 = time.perf_counter() - t0
                    profiler.start()
                    t_trace0 = time.time_ns()
                T.lateness.append(time.perf_counter() - due)
                T.frames_attempted += self.traffic.cameras
                done = self._frame(base + i, frame_samples.take(due - t0))
                for d in done:
                    if d is None:
                        T.frames_failed += 1
                    else:
                        T.frame_lat.append(d - due)
                        T.frame_at.append(d - t0)
                        T.frame_due.append(due - t0)
                if profiler is not None and i == trace_to - 1:
                    _sync()
                    T.trace_interval = (t_trace0, time.time_ns())
                    profiler.stop()
                    T.profiled = (p0, time.perf_counter() - t0)
        finally:
            th.join()
        T.window_s = time.perf_counter() - t0
        blocks.close()
        self.next_event = base + max(n, m)
        for e in errors[:3]:
            print(e, file=sys.stderr)
        return T

    def _closed(self, seconds, rng, profiler) -> Timings:
        """One caller: each event's frame(s), then (with the learner) its tick."""
        mix, T = self.mix, Timings()
        learner = mix.get("learner", False)
        frame_samples = self._samples(rng, seconds, "sample_frames")
        tick_samples = self._samples(rng, seconds, "sample_ticks")
        trace_after = float(mix.get("trace_after_s", 1.0))
        trace_len = float(mix.get("trace_seconds", 3.0))
        tracing = None
        base = self.next_event
        t0 = time.perf_counter()
        blocks = _HostBlocks(T, t0)
        i = 0
        while time.perf_counter() - t0 < seconds:
            blocks.tick()
            if i >= self.traffic.n - base:
                raise RuntimeError(f"traffic exhausted after {i} events; raise the mix's max_rate_hz")
            if profiler is not None:
                el = time.perf_counter() - t0
                if tracing is None and el >= trace_after:
                    _sync()
                    p0 = time.perf_counter() - t0
                    profiler.start()
                    tracing = time.time_ns()
                elif tracing and el >= trace_after + trace_len:
                    _sync()
                    T.trace_interval = (tracing, time.time_ns())
                    profiler.stop()
                    T.profiled = (p0, time.perf_counter() - t0)
                    tracing = False
            ts = time.perf_counter()
            T.frames_attempted += self.traffic.cameras
            for d in self._frame(base + i, frame_samples.take(ts - t0)):
                if d is None:
                    T.frames_failed += 1
                else:
                    T.frame_lat.append(d - ts)
                    T.frame_at.append(d - t0)
            if learner:
                ts = time.perf_counter()
                T.ticks_attempted += 1
                try:
                    self._tick(base + i, tick_samples.take(ts - t0))
                    T.tick_lat.append(time.perf_counter() - ts)
                    T.tick_due.append(ts - t0)
                except Exception:
                    T.ticks_failed += 1
                    print(traceback.format_exc(), file=sys.stderr)
            i += 1
        T.window_s = time.perf_counter() - t0
        blocks.close()
        if tracing:
            _sync()
            T.trace_interval = (tracing, time.time_ns())
            profiler.stop()
            T.profiled = (p0, time.perf_counter() - t0)
        self.next_event = base + i
        return T
