"""Long-horizon soak of the full online loop.

Port of the repository's tools/soak.py. Runs the runtime (per-camera image
callbacks through the scheduler, supervision reprojection, learning steps,
the hot-swap cadence) for N frames at production resolution across 2+
cameras, in windows, and checks the properties an hours-long mission needs:

  * ok_no_rebuild: ops/_cuda.py builds no kernel after warmup;
  * ok_launches_steady: every window's K1 / K2 / K3 / K4 launches per frame
    equal the first post-warmup window's; a shape or path leak shows here
    (each window closes with its queued footprints applied, so a window's K4
    launches are its own footprint updates);
  * ok_device_bounded: growth of the allocator's live CUDA memory after
    warmup stays under --device-budget-mb (peak reserved memory is reported
    beside it); utils/device_monitor.py reads it;
  * ok_host_bounded: raw RSS growth after warmup stays under --rss-budget-mb
    (the graph's FIFO eviction is what bounds it);
  * ok_rate_stable: the last window's frame rate is at least --rate-floor of
    the post-warmup median;
  * ok_graph_semantics: after thousands of FIFO recycles the mission graph's
    parallel arrays, its radius and timespan queries and the save_graph
    export still agree with brute force over the retained nodes
    (check_graph_semantics).

Frames come from a pre-rendered SimWorld pool (poses keep advancing, so
graph gating and eviction churn as on a mission; image content does not
change control flow). Supervision alternates corridor tracking and obstacle
braking every 100 ticks, so both label classes and the confidence
generator stay exercised.

Writes --out (default results/soak_torch.json) with the per-window curves
and the verdicts; exits non-zero if any gate fails.

Usage:
  python -m wild_visual_navigation_tpu_torch.tools.soak                   # 10k frames @448, 2 cameras
  python -m wild_visual_navigation_tpu_torch.tools.soak --frames 400 --size 64 --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from .. import launch_counts
from ..cfg.experiment import ExperimentParams
from ..cfg.node_params import FeatureExtractorNodeParams, LearningNodeParams
from ..ops import _cuda
from ..runtime import WVNRuntime
from ..runtime.replay import SimWorld
from ..utils.device_monitor import device_memory_stats
from ..utils.devices import torch_device


def _rss_mb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return float(line.split()[1]) / 1024.0
    return 0.0


def check_graph_semantics(est, radius: float) -> dict:
    """Post-run eviction audit: the online mission graph's parallel
    pose / stamp arrays, its radius and timespan queries and the save_graph
    export must agree with per-node ground truth, checked by brute force over
    the retained nodes. Returns ok flags and counts."""
    g = est._mission_graph
    with g._lock:
        raw_nodes = list(g._nodes)
        poses = g._poses[: len(raw_nodes)].copy()
        stamps = g._stamps[: len(raw_nodes)].copy()
    ok_arrays = all(
        np.allclose(poses[i], np.asarray(raw_nodes[i].pose_base_in_world)) and stamps[i] == raw_nodes[i].timestamp
        for i in range(len(raw_nodes))
    )

    nodes = g.get_nodes()
    last = g.get_last_node()
    got = g.get_nodes_within_radius_range(last, 0.0, radius)
    want = []
    for nd in nodes:
        d = last.distance_to(nd)
        if d == d and 0.0 <= d <= radius:  # NaN-safe, like the vectorised path
            want.append(nd)
    ok_radius = [id(x) for x in got] == [id(x) for x in sorted(want)]

    t_lo = float(np.percentile(stamps, 40)) if len(stamps) else 0.0
    t_hi = float(np.percentile(stamps, 90)) if len(stamps) else 0.0
    got_t = g.get_nodes_within_timespan(t_lo, t_hi)
    want_t = sorted(nd for nd in nodes if t_lo <= nd.timestamp <= t_hi)
    ok_timespan = [id(x) for x in got_t] == [id(x) for x in want_t]

    # save_graph resolves pending supervision first, which flips more slot
    # holders valid: resolve here too, so the count matches the export's
    est._resolve_pending_supervision()
    slot_holders = [nd for nd in g.get_valid_nodes() if nd.buffer_slot >= 0]
    with tempfile.TemporaryDirectory() as td:
        est.save_graph(td)
        files = sorted(os.listdir(td))
        ok_export = len(files) == len(slot_holders) and len(files) > 0
        if files:
            rec = np.load(os.path.join(td, files[0]))
            ok_export = ok_export and {"features", "signal", "signal_valid", "segments", "feat_valid"} <= set(rec.files)

    return {
        "graph_nodes": len(nodes),
        "graph_evictions_total": int(g.evictions_total),
        "export_files": len(files),
        "radius_query_hits": len(got),
        "ok_arrays_in_sync": bool(ok_arrays),
        "ok_radius_query": bool(ok_radius),
        "ok_timespan_query": bool(ok_timespan),
        "ok_export": bool(ok_export),
    }


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=10000, help="total frames across all cameras")
    ap.add_argument("--size", type=int, default=448)
    ap.add_argument("--cameras", type=int, default=2)
    ap.add_argument("--seg", type=str, default="slic")
    ap.add_argument("--feature", type=str, default="dinov2")
    ap.add_argument("--backbone", type=str, default="vit_small")
    ap.add_argument("--product", action="store_true",
                    help="the batched multi-camera product path (image_batch_callback, grid x dinov2)")
    ap.add_argument("--pixelwise", action="store_true",
                    help="(--product) score per pixel instead of at patch resolution")
    ap.add_argument("--buffer_capacity", type=int, default=128)
    ap.add_argument("--pool", type=int, default=32, help="pre-rendered frame pool size")
    ap.add_argument("--window", type=int, default=500, help="frames per stats window")
    ap.add_argument("--warmup_windows", type=int, default=2)
    ap.add_argument("--rss-budget-mb", type=float, default=300.0)
    ap.add_argument("--device-pool", type=str, default="off", choices=["on", "off"],
                    help="upload the frame pool once and feed frames already on the device")
    ap.add_argument("--device-budget-mb", type=float, default=64.0)
    ap.add_argument("--rate-floor", type=float, default=0.7)
    ap.add_argument("--out", type=str, default="results/soak_torch.json")
    ap.add_argument("--device", type=str, default="cuda")
    return ap


def run_soak(args) -> dict:
    dev = torch_device(args.device, "soak")
    size = args.size
    if args.product:
        size = (size // 14) * 14  # the frame side must divide the DINOv2 patch
    cams = [f"cam{i}" for i in range(args.cameras)]
    cam_topics = {c: {"use_for_training": True, "scheduler_weight": 1} for c in cams}
    fe = FeatureExtractorNodeParams(
        network_input_image_height=size, network_input_image_width=size,
        segmentation_type="grid" if args.product else args.seg,
        feature_type="dinov2" if args.product else args.feature,
        dino_backbone=args.backbone,
        dino_patch_size=14 if (args.product or args.feature == "dinov2") else 8,
        slic_num_components=64, grid_cell_size=max(8, size // 10),
        prediction_per_pixel=True, image_callback_rate=1e9,
        camera_topics=cam_topics,
    )
    ln = LearningNodeParams(
        network_input_image_height=size, network_input_image_width=size,
        image_graph_dist_thr=0.1, supervision_graph_dist_thr=0.05,
        min_samples_for_training=4, supervision_callback_rate=1e9,
        camera_topics=cam_topics, traversability_radius=4.0,
        robot_width=0.6, robot_length=1.0,
    )
    rt = WVNRuntime(
        fe_params=fe, ln_params=ln, exp_params=ExperimentParams(), seed=0,
        buffer_capacity=args.buffer_capacity, reprojection_fanout=16,
        supervision_flush_every=4 if not args.product else 1,
        supervision_resolve_every=8,
        # the product path's two scoring modes: patch resolution by default,
        # --pixelwise scores every pixel
        score_at_patch_res=args.product and not args.pixelwise,
        device=dev,
    )

    # --- frame pool (rendered once; poses advance every frame)
    world = SimWorld(image_size=size, seed=0, obstacle_xy=None)
    pool = []
    rng = np.random.RandomState(0)
    for i in range(args.pool):
        T = np.eye(4)
        T[0, 3] = i * 0.8
        th = rng.rand() * 6.28
        c, s = np.cos(th), np.sin(th)
        T[:2, :2] = [[c, -s], [s, c]]
        pool.append(np.clip(world.render(pose=T) * 255, 0, 255).astype(np.uint8))
    if args.product:
        # the batched product path takes (B, 3, H, W) stacks: one pool entry
        # per tick, distinct frames per camera
        pool = [np.stack([pool[(i + 4 * ci) % len(pool)] for ci in range(args.cameras)]) for i in range(len(pool))]
    device_pool = args.device_pool == "on"
    if device_pool:
        pool = [torch.from_numpy(p).to(dev) for p in pool]
    print(f"rendered pool of {len(pool)} {size}px frames (device_pool={device_pool}, product={args.product})",
          flush=True)

    K = np.array([[0.6 * size, 0, size / 2], [0, 0.6 * size, size / 2], [0, 0, 1.0]])
    down = np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1]], np.float64)
    cam_in_base = {}
    for ci, c in enumerate(cams):
        T = np.eye(4)
        T[:3, :3] = down
        T[:3, 3] = [0.2 * ci, 0.1 * ci, 1.5]
        cam_in_base[c] = T

    R = 8.0  # m; a circle: the robot keeps revisiting space, so gating admits nodes and eviction churns

    def pose_at(t: float):
        th = t * 1.0 / R
        T = np.eye(4)
        T[0, 3] = R * np.cos(th)
        T[1, 3] = R * np.sin(th)
        c, s = np.cos(th + np.pi / 2), np.sin(th + np.pi / 2)
        T[:2, :2] = [[c, -s], [s, c]]
        return T

    windows = []
    t_sim, dt_frame = 0.0, 0.1
    frames_done = supervision_done = gated = 0
    if args.product:
        Ks_b = np.tile(K[None], (args.cameras, 1, 1))
        cam_in_base_b = np.stack([cam_in_base[c] for c in cams])
    launches0, frames0 = launch_counts(), 0
    t_window0 = time.time()
    while frames_done < args.frames:
        i = frames_done
        t_sim += dt_frame
        pb = pose_at(t_sim)
        if args.product:
            # the deployed multi-camera path: all cameras' frames in one call
            imgs = pool[(i * 7) % len(pool)]
            stamps = [t_sim + 1e-4 * ci for ci in range(args.cameras)]
            results = rt.image_batch_callback(imgs, stamps, cams, Ks_b, size, size,
                                              np.tile(pb[None], (args.cameras, 1, 1)), cam_in_base_b)
            gated += args.cameras - len(results)
            frames_done += args.cameras
        else:
            for ci, c in enumerate(cams):
                img = pool[(i * 7 + ci * 5) % len(pool)]
                if rt.image_callback(img, t_sim, c, K, size, size, pb, cam_in_base[c]) is None:
                    gated += 1
                frames_done += 1
        # supervision and learning at the same tick
        phase = (i // 100) % 2  # alternate good tracking and braking
        desired = np.array([1.0, 0, 0, 0, 0, 1.0 / R])
        current = desired + rng.randn(6) * 0.02
        if phase:
            current = desired * 0.3 + rng.randn(6) * 0.05  # obstacle grind
        if rt.robot_state_callback(t_sim + 0.01, pb, current, desired):
            supervision_done += 1
        rt.learning_step()

        if frames_done // args.window > len(windows):
            rt.estimator.flush_supervision()  # this window's footprints launch in this window
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            dt = time.time() - t_window0
            counts = launch_counts()
            n = frames_done - frames0
            mem = device_memory_stats(dev)
            windows.append({
                "frames": frames_done,
                "fps": round(n / dt, 2),
                "launches_per_frame": {k: (counts[k] - launches0[k]) / n for k in counts},
                "rss_mb": round(_rss_mb(), 1),
                "device_mb": round(mem["bytes_in_use"] / 2**20, 1),
                "device_reserved_peak_mb": round(mem["peak_bytes_reserved"] / 2**20, 1),
                "builds": _cuda.builds,
                "estimator_step": rt.estimator.step,
                "graph_nodes": rt.estimator._mission_graph.get_num_nodes(),
                "graph_evictions": int(rt.estimator._mission_graph.evictions_total),
                "wall_s": round(dt, 2),
            })
            print(json.dumps(windows[-1]), flush=True)
            launches0, frames0 = counts, frames_done
            t_window0 = time.time()

    # ---- eviction audit (after the churn, before the verdicts)
    gsem = check_graph_semantics(rt.estimator, radius=4.0)
    print("graph semantics:", json.dumps(gsem), flush=True)

    # ---- verdicts
    post = windows[args.warmup_windows:]
    assert len(post) >= 2, "soak too short for post-warmup verdicts; raise --frames"
    rebuilds = post[-1]["builds"] - post[0]["builds"]
    rss_growth = post[-1]["rss_mb"] - post[0]["rss_mb"]
    dev_growth = post[-1]["device_mb"] - post[0]["device_mb"]
    rates = [w["fps"] for w in post]
    rate_floor = args.rate_floor * float(np.median(rates))
    steady = post[0]["launches_per_frame"]
    result = {
        "config": {
            "frames": args.frames, "size": size, "cameras": args.cameras,
            "seg": "grid" if args.product else args.seg, "feature": "dinov2" if args.product else args.feature,
            "backbone": args.backbone, "product": args.product, "pixelwise": args.pixelwise,
            "buffer_capacity": args.buffer_capacity, "window": args.window, "device_pool": device_pool,
        },
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "frames_done": frames_done,
        "frames_gated": gated,
        "supervision_updates": supervision_done,
        "train_steps": rt.estimator.step,
        "graph_nodes_final": rt.estimator._mission_graph.get_num_nodes(),
        "graph_semantics": gsem,
        "windows": windows,
        "post_warmup_rebuilds": rebuilds,
        "launches_per_frame": steady,
        "rss_growth_mb": round(rss_growth, 1),
        "device_growth_mb": round(dev_growth, 1),
        "device_reserved_peak_mb": post[-1]["device_reserved_peak_mb"],
        "fps_median": round(float(np.median(rates)), 2),
        "fps_last": rates[-1],
        "ok_no_rebuild": rebuilds == 0,
        "ok_launches_steady": all(w["launches_per_frame"] == steady for w in post),
        "ok_graph_semantics": all(v for k, v in gsem.items() if k.startswith("ok_")),
        "ok_host_bounded": rss_growth < args.rss_budget_mb,
        "ok_device_bounded": abs(dev_growth) < args.device_budget_mb,
        "ok_rate_stable": rates[-1] >= rate_floor,
    }
    result["ok"] = all(v for k, v in result.items() if k.startswith("ok_"))
    return result


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    t0 = time.time()
    result = run_soak(args)
    result["total_wall_s"] = round(time.time() - t0, 1)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(f"\nwrote {args.out}")
    print(json.dumps({k: v for k, v in result.items() if k != "windows"}, indent=1))
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
