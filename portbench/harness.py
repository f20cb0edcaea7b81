"""One run of one cell: set-up, the measured window, the metrics, the check.

The configuration's pipeline (`pipelines/<pipeline>.py`, "dino" where
the configuration names none) makes the weights, the runtime, the plain
reference's frame and the counts; the rest is shared by every pipeline.

Set-up (timed as `setup_s`, from the process's start) makes the weights
on the device from the seed, the traffic from the seed, the runtime, and
runs the mix's pre-roll through the same calls the window makes, so every
shape the window uses is built and warm. The window then runs for
`seconds`; with `trace`, a part of it (`trace_after_s`, `trace_seconds`
in the mix) runs under torch.profiler. After the window the device's
memory peak is read, the runtime is freed, and the reference checks the
sampled calls.
"""

from __future__ import annotations

import gc
import importlib.util
import os
import sys
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from . import check, reference as ref, trace as trace_mod
from .system import Caller, Recorder, Timings
from .traffic import Traffic

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "wild_visual_navigation_tpu")
PIPELINE_FUNCTIONS = ("make_weights", "build_runtime", "frame", "num_segments", "frame_flops", "kernel_shapes")


@dataclass
class Ctx:
    """What a metric's reader sees."""

    cfg: dict
    mix: dict
    timings: Timings
    trace: object  # trace.Trace or None
    setup_s: float
    pipeline: object  # the configuration's pipeline module (load_pipeline)


def load_metric(name: str, root: Path = HERE):
    path = root / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_pipeline(cfg: dict, root: Path = HERE):
    """The configuration's pipeline module, `pipelines/<cfg["pipeline"]>.py`
    ("dino" where the key is absent); SystemExit, naming the file, where it
    is missing or lacks a function of PIPELINE_FUNCTIONS."""
    name = cfg.get("pipeline", "dino")
    path = root / "pipelines" / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"portbench: configuration {cfg.get('name')!r} names the pipeline {name!r}, "
                         f"and there is no {path}")
    spec = importlib.util.spec_from_file_location(f"portbench_pipeline_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    missing = [f for f in PIPELINE_FUNCTIONS if not callable(getattr(mod, f, None))]
    if missing:
        raise SystemExit(f"portbench: the pipeline {path} lacks {', '.join(missing)}")
    return mod


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def _profiler():
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    # every thread: the online cell's learner launches its work from a thread of its own
    return profile(activities=acts, experimental_config=_ExperimentalConfig(profile_all_threads=True))


def _print_blocks(timings) -> None:
    """Per 5-s block of the window, on stderr: the median frame latency,
    this process's CPU time per frame, the CPU time of everything else on
    the machine, its steal time and load average; so a slow host shows in
    the record, and whether other work on the machine came with it."""
    at, lat = np.asarray(timings.frame_at), np.asarray(timings.frame_lat) * 1e3
    h = timings.host
    cells = []
    for a, b in zip(h[:-1], h[1:]):
        inside = (at >= a[0]) & (at < b[0])
        if not inside.any():
            continue
        cpu = b[1] - a[1]
        cells.append(f"[{max(a[0], 0.0):.0f}-{b[0]:.0f} s: {np.median(lat[inside]):.2f} ms, "
                     f"{cpu / inside.sum() * 1e3:.2f} ms CPU per frame, "
                     f"others {max(b[2] - a[2] - cpu, 0.0):.2f} s CPU, steal {b[3] - a[3]:.2f} s, load {b[4]:.2f}]")
    late = f"; the camera started up to {max(timings.lateness) * 1e3:.2f} ms late" if timings.lateness else ""
    print(f"[portbench] by block (frame median, this process's CPU per frame, the machine's other CPU time, steal, "
          f"load average; {os.cpu_count()} CPUs): " + " ".join(cells) + late, file=sys.stderr)


def run(cfg: dict, mix: dict, limits: dict, e2e: list, per_layer: list, seed: int, seconds: float, trace: bool,
        device, t_start: float, control: bool = False) -> tuple[dict, list]:
    """Returns (the result line's object, the lines of compared numbers).
    `e2e` and `per_layer` are BENCHMARK.json's metric entries for the cell."""
    device = torch.device(device)
    learner = bool(mix.get("learner", False))
    pipe = load_pipeline(cfg)
    stamps = [("imports", time.perf_counter())]
    weights = pipe.make_weights(cfg, seed, device)
    stamps.append(("weights", time.perf_counter()))
    n_events = int(mix.get("preroll_max_events", 400)) + int(seconds * float(mix.get("max_rate_hz", 12.0))) + 64
    traffic = Traffic(mix, cfg["image_size"], seed, n_events)
    stamps.append(("traffic", time.perf_counter()))
    first = ({k: v.clone() for k, v in weights["head"].items()}, ref.confidence_init(device))
    rt = pipe.build_runtime(cfg, mix, weights, device, quant=cfg.get("control_quant") if control else None)
    stamps.append(("runtime", time.perf_counter()))
    rec = Recorder()
    rec.install(rt, first)
    caller = Caller(rt, traffic, mix, rec)
    events = caller.warm()
    gc.collect()
    stamps.append(("pre-roll", time.perf_counter()))
    setup_s = time.perf_counter() - t_start
    prev = t_start
    parts = []
    for name, t in stamps:
        parts.append(f"{name} {t - prev:.2f} s")
        prev = t
    print(f"[portbench] set-up {setup_s:.2f} s: " + ", ".join(parts) + f" ({events} pre-roll events)", file=sys.stderr)
    rng = np.random.RandomState(np.random.SeedSequence([seed, 23]).generate_state(1)[0])
    prof = _profiler() if trace else None
    timings = caller.window(seconds, rng, prof)
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.synchronize()
    dev_info = {"platform": "gpu" if on_card else "cpu",
                "kind": torch.cuda.get_device_name(device) if on_card else "cpu", "count": 1,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device)) if on_card else 0}
    tr = None
    if prof is not None and timings.trace_interval is not None:
        tr = trace_mod.reduce(prof.profiler.kineto_results.events(), *timings.trace_interval)
        dev_info.update(busy_s=tr.busy_s(), window_s=tr.window_s)
    del caller, rt, prof
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    if timings.frame_at:
        _print_blocks(timings)
    ctx = Ctx(cfg, mix, timings, tr, setup_s, pipe)
    metrics = {}
    for m in (per_layer if trace else e2e):
        value = load_metric(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"portbench: modules of JAX or of the JAX package are loaded: {bad}")

    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            nums, counts, ctl = check.compare(rec, cfg, pipe, weights, traffic, control=control)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    active = {k: v for k, v in limits.items() if learner or k in check.FRAME_NUMBERS}
    correct = check.verdict(nums, counts, active, learner)
    lines = ["readings " + " ".join(f"{k} {v:.6g}" for k, v in nums.items()),
             "samples " + " ".join(f"{k} {v}" for k, v in {**counts, **rec.skipped}.items())]
    lines += [f"{k} {nums.get(k, float('nan')):.6g} limit {v:g}" for k, v in active.items()]
    result = {"correct": bool(correct),
              "attempted": timings.frames_attempted + timings.ticks_attempted,
              "failed": timings.frames_failed + timings.ticks_failed,
              "metrics": metrics, "device": dev_info}
    if tr is not None:
        result["breakdown"] = trace_mod.breakdown(tr)
    if control:
        # the control run is correct only where both controls pass: the program's own int8 path (the readings
        # above) and the reference one precision below put in the program's place
        result["correct"] = bool(correct and check.verdict(ctl, counts, active, learner))
        result["control"] = {"program_int8": nums, "reference_low": ctl,
                             "reference_low_fails": [k for k, v in active.items() if ctl.get(k, 0.0) > v]}
        lines.insert(0, "control reference_low " + " ".join(f"{k} {v:.6g}" for k, v in ctl.items()))
    result["checks"] = {k: {"value": nums.get(k), "limit": v} for k, v in active.items()}
    return result, lines
