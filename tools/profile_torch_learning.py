#!/usr/bin/env python3
"""Where the time of the port's online learning loop goes, on one GPU.

    python3 tools/profile_torch_learning.py [--out results/torch_profile_learning.json]

Replays assets/sequences/demo_mission.npz through the learning loop at
the product's settings, as chip_smoke.py's learning phase does (the same
`replay_learning`), then measures:

  * the host-clock latency of each kind of replay event (frame, mission
    intake, supervision intake with its flush, train call), each ending in
    a synchronize, over a second replay;
  * the stages of one supervision flush (projection, K4 running the hull
    and the fill in one launch, fusion + segment means, write-back), each
    on the host clock ending in a synchronize, medians over the replay's
    recorded footprint updates;
  * a torch.profiler trace of 10 recorded flushes and 10 train steps:
    device kernel time by name, and the device's busy share of the wall
    time.

Needs a CUDA device; prints the card's name and power limit beside every
number and writes the numbers as JSON to --out.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
PROFILED = 10  # flushes and train steps under the profiler


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "results" / "torch_profile_learning.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_learning: no CUDA device", file=sys.stderr)
        return 2
    report = profile_learning(torch.device("cuda"), 224, 100)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(report, indent=1))
    return 0


def profile_learning(dev, size: int, S: int) -> dict:
    """The three measurements of the module docstring, on `dev`, at
    `size` px with S segments; returns them as a dict."""
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from wild_visual_navigation_tpu_torch.cfg.node_params import FeatureExtractorNodeParams
    from wild_visual_navigation_tpu_torch.feature_extractor.dino import DinoInterface
    from wild_visual_navigation_tpu_torch.models.registry import get_model
    from wild_visual_navigation_tpu_torch.ops.projection import Camera, project_points
    from wild_visual_navigation_tpu_torch.ops.rasterize import rasterize_points_hull
    from wild_visual_navigation_tpu_torch.ops.segment_ops import segment_masked_mean
    from wild_visual_navigation_tpu_torch.runtime.fused import build_fused_frame_fn
    from wild_visual_navigation_tpu_torch.traversability.estimator import TraversabilityEstimator
    from wild_visual_navigation_tpu_torch.utils.confidence_generator import ConfidenceConfig
    from wild_visual_navigation_tpu_torch.utils.params import confidence_state_from_jax, load_head_npz, mlp_state_from_jax

    card = cs.card_line()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    node = FeatureExtractorNodeParams()
    D = 384
    head, head_cg, _ = load_head_npz(ROOT / "assets/checkpoints/replay_demo_head_torch.npz")
    mlp = get_model({"name": "SimpleMLP", "simple_mlp_cfg": {"input_size": D, "hidden_sizes": [256, 32, 1],
                                                             "reconstruction": True}}, device=dev)
    mlp.load_state_dict(mlp_state_from_jax(head))
    mlp.eval().requires_grad_(False)
    cg = confidence_state_from_jax(head_cg, dev)
    dino = DinoInterface(input_size=size, device=dev, seed=0)
    frame = build_fused_frame_fn(dino.vit, mlp, ConfidenceConfig(std_factor=node.confidence_std_factor), size,
                                 num_segments=S)
    seq = dict(np.load(ROOT / "assets/sequences/demo_mission.npz"))

    # 1. the replay, twice: the first warms up, the second is timed per event
    cs.replay_learning(dev, frame, cg, seq, size, S, D)
    event_ms: dict[str, list] = {"frame": [], "add_mission_node": [], "add_supervision_node (with its flush)": [],
                                 "train": []}
    originals = {name: getattr(TraversabilityEstimator, name) for name in ("add_mission_node", "add_supervision_node",
                                                                          "train")}

    def timed(name, key):
        def run(self, *a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = originals[name](self, *a, **k)
            torch.cuda.synchronize()
            event_ms[key].append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    def timed_frame(*a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = frame(*a)
        torch.cuda.synchronize()
        event_ms["frame"].append((time.perf_counter() - t0) * 1e3)
        return out

    TraversabilityEstimator.add_mission_node = timed("add_mission_node", "add_mission_node")
    TraversabilityEstimator.add_supervision_node = timed("add_supervision_node", "add_supervision_node (with its flush)")
    TraversabilityEstimator.train = timed("train", "train")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    est, rep = cs.replay_learning(dev, timed_frame, cg, seq, size, S, D)
    replay_s = time.perf_counter() - t0
    for name, fn in originals.items():
        setattr(TraversabilityEstimator, name, fn)
    report = {"card": card, "replay_s": replay_s, "events": {}}
    print(f"[replay] {replay_s:.3f} s for {len(seq['frame_stamps'])} frames and {len(seq['state_stamps'])} states | {card}")
    for key, ms in event_ms.items():
        report["events"][key] = {"count": len(ms), "total_ms": sum(ms), "median_ms": statistics.median(ms)}
        print(f"[event] {key}: {len(ms)} calls, total {sum(ms):.1f} ms, median {statistics.median(ms):.3f} ms | {card}")

    # 2. the stages of one flush, over the recorded footprint updates
    buf = est.buffer
    stages: dict[str, list] = {k: [] for k in ("gather + project", "K4 hull + fill (one launch)",
                                               "fuse + segment means", "write-back")}

    def stage(key, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[key].append((time.perf_counter() - t0) * 1e3)
        return out

    for idx, fp, trav in rep["updates"]:
        sel = torch.as_tensor(np.clip(idx, 0, buf.capacity - 1), device=dev)
        pts = torch.as_tensor(fp, device=dev)[None].expand(len(idx), -1, 3)
        p2d, _, vz = stage("gather + project", lambda: project_points(Camera(buf.K[sel], size, size),
                                                                      buf.pose_cam_in_world[sel], pts))
        inside = stage("K4 hull + fill (one launch)", lambda: rasterize_points_hull(p2d, vz, size, size, max_hull=32))

        def fuse():
            fused = torch.minimum(buf.supervision_mask[sel], torch.where(inside, trav, torch.inf))
            return fused, segment_masked_mean(fused, torch.isfinite(fused), buf.seg[sel], S)

        fused, (sig, sv) = stage("fuse + segment means", fuse)
        rows = np.flatnonzero(idx < buf.capacity)

        def write():
            r, s = torch.as_tensor(rows, device=dev), torch.as_tensor(idx[rows], device=dev)
            buf.supervision_mask[s], buf.signal[s], buf.signal_valid[s] = fused[r], sig[r], sv[r]

        stage("write-back", write)
    report["flush_stages_ms"] = {k: statistics.median(v) for k, v in stages.items()}
    for k, v in report["flush_stages_ms"].items():
        print(f"[flush stage] {k}: median {v:.3f} ms over {len(stages[k])} updates | {card}")

    # 3. a profile of the recorded flushes and train steps
    from torch.profiler import ProfilerActivity, profile

    updates, samples = rep["updates"][:PROFILED], rep["samples"][:PROFILED]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for u in updates:
            est._reproject_update(*u)
        for idx in samples:
            est._train_step(idx)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [r for r in prof.key_averages() if str(r.device_type).endswith("CUDA") and r.device_time_total > 0]
    rows.sort(key=lambda r: r.device_time_total, reverse=True)
    busy_ms = sum(r.device_time_total for r in rows) / 1e3
    report["profile"] = {"flushes": len(updates), "train_steps": len(samples), "wall_ms": wall_ms,
                         "device_kernel_ms": busy_ms, "busy_share": busy_ms / wall_ms,
                         "top_kernels": [{"name": r.key, "calls": r.count, "device_ms": r.device_time_total / 1e3}
                                         for r in rows[:12]]}
    print(f"[profile] {len(updates)} flushes + {len(samples)} train steps: wall {wall_ms:.1f} ms, device "
          f"kernels {busy_ms:.2f} ms, busy share {busy_ms / wall_ms:.3f} | {card}")
    for r in rows[:12]:
        print(f"[profile]   {r.device_time_total / 1e3:8.3f} ms  {r.count:6d} calls  {r.key[:90]}")
    return report


if __name__ == "__main__":
    sys.exit(main())
