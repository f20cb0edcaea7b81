#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        (from the root of the repository)

Builds the port's four CUDA kernels from wild_visual_navigation_tpu_torch/
csrc/ (one nvcc per source, in parallel), holds each against its plain
PyTorch version at the main path's shapes, and drives these paths:

  * the per-frame path (DINO ViT-S/8 at 224 px with seeded weights, SLIC
    with 100 segments, the converted demo head, per-pixel prediction)
    through DinoInterface and build_fused_frame_fn;
  * the online learning loop at the product's settings: the recorded
    mission assets/sequences/demo_mission.npz replayed in stamp order,
    each frame through the frame function into the estimator's mission
    buffer, each robot state through the supervision generator into a
    footprint reprojection (K4: the hull and the fill in one launch) and a
    train step; then the learnt head hot-swapped into the frame function,
    and the same replay on the CPU for comparison;
  * the runtime, through the entry points a robot stack calls: the same
    mission through `run_replay` and WVNRuntime's callbacks on the card
    (K1 12, K2 1, K3 11 launches per accepted frame, K4 1 per flush, the
    same counts as the learning phase), its first 20 frames on the card and
    on the CPU, image_batch_callback
    at B=4 against single callbacks, the learning thread at 10 Hz while
    frames arrive, and the two-process topology (a LearningNode spawned on
    the same card, fed by a FeatureExtractorNode over a Unix socket, its
    hot-swap file reloaded); then the callbacks' latencies beside the bare
    frame's;
  * SLIC at 448 px: the card's 10 iterations against the plain whole-image
    loop, and what the other order does to a ViT-S/8 frame at 448;
  * the STEGO path (BASELINE config 3): K2 with the 90-d STEGO head, the
    fused STEGO frame at 448 (DINO ViT-B/8, the STEGO head, 20 k-means
    clusters) scored per pixel and per segment against the same frame on
    the CPU, and WVNRuntime in the Jackal robot's profile
    (configs/robots/jackal.yaml: stego x stego at 224) replaying the same
    mission (K1 12, K2 1, K3 0 per accepted frame, K4 1 per flush), its
    first 20 frames also on the CPU, and the frame's latency at 224 and 448;
  * dense SIFT, the colour histogram and pyramidal LK on the card against
    the CPU, and the facade's sift and histogram modes with SLIC (K3);
  * the anomaly frame (LinearRnvp at the experiment's defaults, scored per
    pixel in row bands) and the graph frame (SimpleGCN [256, 128, 1], per
    segment over the SLIC adjacency) at 224 (K1 12, K3 11, K2 0 per frame)
    against the CPU tail on the card's features; WVNRuntime in anomaly mode
    replaying the mission (K4 1 per flush), its first 20 frames also on the
    CPU; and the demo golden replay (sift on a 64-px grid) on the card held
    to assets/goldens/demo_mission_replay.npz's own limits;
  * the torchvision path: the ResNet-18, ResNet-50 and EfficientNet-B4
    pyramids at 448 in bf16 against fp32 (TF32 off), each through the
    facade in torchvision x slic mode and the fused torchvision frame at B=1
    and B=4 (K3 11 launches a call, nothing else), its tail against the CPU;
    WVNRuntime in torchvision x slic mode at the product's settings (ResNet-18
    at 224) with a 128 x 0.15 m grid map replaying the mission (K3 11 per
    accepted frame, K4 1 per flush, K1 and K2 never) and asking for a carrot
    every second frame, its first 20 frames also on the CPU (grid maps
    compared cell by cell), image_batch_callback at B=4; the closed-loop
    obstacle scenario of the JAX package's closed-loop test on the card with
    that test's checks; and the torchvision frame's, the pyramids', the
    grid-map update's, image_callback's with and without the grid map, and
    get_carrot's times;
  * the offline tools through their entry points: generate_dataset at its
    defaults (448 px, DINOv2 ViT-S/14 x SLIC 100, STEGO labels) on 8 demo
    frames (K1 12 per extraction and 12 per STEGO inference, K3 11 per
    frame), its first 2 frames again on the card and on the CPU with fp32
    backbones; the ablation sweep (slic:sift, grid:dinov2 at 64 px) and
    slic:sift again on the CPU; the parameter search's population of 64
    (trial 0 against OfflineTrainer on the card); the soak at 448 on 2
    cameras (DINOv2 x SLIC 64, per pixel, 600 frames) with its gates; then
    K1 at (1, 6, 1025, 64), K2 with a 384-d head at 32^2 -> 448^2, K3 at
    448^2 with K = 64 and 100 and K4 from points at 16 x 448^2 against their
    plain versions, timed;
  * the parallel layer ([parallel] lines): WVNRuntime(mesh=) on 4 Gloo
    ranks sharing the card as (dp, tp) = (2, 2) at the product's
    configuration, on the mesh scenario of the JAX package's
    tests/_mesh_runtime_check.py, against the unmeshed runtime at that
    check's tolerances, with every rank's checksum and launches (K1 on
    (2, 3, 785, 64), K4 on 16 hulls); the DistributedTrainer on 2 ranks, each
    fed every other demo frame (rank 1 starved on the first step), at tp = 1
    and tp = 2 against a single-process twin stepping on the concatenated
    rows; a (1, 1) mesh over NCCL against no mesh; the callbacks' and the
    trainer's times, and K1 and K4 at the ranks' shapes; and image_callback
    one frame at a time on the (2, 2) mesh (K1 on (1, 3, 785, 64)) against
    the unmeshed runtime; then the same product runtime with
    dino_quant="int8_static" (calibrated on every rank with the scenario's
    frames) and "int8" on the (2, 2) mesh against the unmeshed runtimes on
    the same weights at the int8 limits, its amax buffers equal to the
    unmeshed calibration's, its all_reduces per ViT forward counted (24
    int32 sums; 48 maxima for "int8", 36 more with "xla_int8" attention),
    and image_batch_callback B=4 per rank in turns with the meshed bf16
    runtime;
  * the int8 backbones ([quant] lines): WVNRuntime at the product's
    settings with dino_quant="int8_static", calibrated on the first 2 demo
    frames, replaying the mission in turns with the bf16 runtime on the
    same weights (K1 12, K2 1, K3 11 per frame, K4 per flush), its first 6
    frames against the CPU twin, both frames profiled; BASELINE config 5
    (DINOv2 ViT-B/14 at 644, 4 cameras, grid, patch-resolution scoring)
    through image_batch_callback as int8_static, int8 and bf16 on the same
    weights, in turns, with the device time split into the int8 products,
    K1, the fp products and the rest; torch._int_mm exact at every Linear of
    ViT-S/8, ViT-S/14 and ViT-B/14 and the shapes its raw call refuses; and
    attention_scores_int8 within JAX's band;
  * the compiled engine ([engine] lines): `python -m
    wild_visual_navigation_tpu_torch.tools.export_engine` at its defaults
    (DINOv2 ViT-S/14 at 224) and an int8_static engine built through the
    API, each compiled by AOTInductor and loaded in a fresh process (this
    script with --engine-child) that builds and compiles nothing, each call
    launching K1 12 times and no library attention, held to the eager
    pipeline (bf16 within ENGINE_BF16_ATOL, int8_static within the int8
    limits), refusing another shape, its flops against the analytic count,
    its memory, its host time per call in turns with the eager pipeline and
    the exported program; and K1's operator against the direct call, per
    call and in the
    frame;
  * the JAX package's implementation switches ([switches] lines, this
    slice's path, its launch counts set to 0 just before it): bench.py's
    backbone profile (DINOv2 ViT-S/14 at 448, "flash", ln_dtype bf16, layer
    scales 1) in bf16 and int8_static through build_fused_batch_fn against
    its CPU twin, the same ViT under "flash:<bq>:<bk>" for each other tile
    K1 holds, "auto" at the main path's (1, 6, 785) and config 5's
    (4, 12, 2117), and flash_attention at head dims 32, 80, 128, 200 and 256
    with each tile each takes; then every K1 variant against the plain
    version at bf16_atol, timed beside the plain version and SDPA at the
    ViT shapes, with its bound.

Each phase ends with a `[phase] ... done at N s` line (wall time since the
start). It checks each path's outputs and that each went through its kernels, and
times the kernels, the frame, a supervision flush and a train step. It
also prints each kernel body's registers, shared memory and spills
(ptxas's report of the build), the tensor-core instructions in the SASS by
function (HGMMA in K1's bf16 body, HMMA in K2: each must be above 0), K1
at ten ViT shapes beside SDPA (ViT-S/8, ViT-S/14, ViT-B/14 and ViT-B/8),
K1 on strided views of a qkv buffer, K2 at B=1, B=4 and a ragged output and
with the STEGO head at 224 and 448, K3 with the bound of the (pixel, candidate)
pairs it searched, `slic_batch` at B=1 and B=4, K4 from points (hulls
bitwise equal to `convex_hull`) and the fill alone, and a torch.profiler
breakdown of 10 frames. Every phase raises on failure.

The last line is {"ok": true, "device": {...}}; the line before it lists
the kernels with their launches in the runtime's replay of the mission
(counts set to 0 just before it, read just after), errors, times and
bounds (K4's of the fill alone, as the TPU kernel it replaces; its launch
from points under from_points_* keys), and `stego_launches`,
`anomaly_launches`, `graph_launches`, `golden_launches`,
`features_launches`, `torchvision_launches`, `closed_loop_launches`,
`offline_launches`, `parallel_launches`, `quant_mesh_launches`,
`quant_launches`, `engine_launches` and `fused_batch_launches`, each
kernel's launches in the
Jackal runtime's STEGO replay, the anomaly runtime's replay, the ten graph
frames, the golden replay, the facade's sift and histogram extractions, the
torchvision runtime's replay, the closed-loop scenario, the offline tools'
runs, rank 0's mesh scenario, rank 0's int8_static mesh scenario, the
int8_static runtime's replay, one call of the reloaded engine and one call
of build_fused_batch_fn (each counted the same way); K1's entry also has
`parallel_tp_rank` (its times at a tp rank's shapes) and
`operator_overhead_us`, and K4's `parallel_dp_rank_16_hulls`. K1's other
instantiations follow the four kernels as entries of their own, named by
head dim and tile ("flash_attention bf16 d128 64x128"), with their launches
on the [switches] path, their times at their first shape and under
`at_shapes` at every shape timed. Without a CUDA device, or outside
the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
N_TIMED = 25  # timed runs, each on its own inputs, after WARMUP runs
WARMUP = 3
# Published peaks of one H100 SXM at 700 W (NVIDIA's data sheet, dense;
# packed bf16x2 outside the tensor cores, twice the fp32 rate, from NVIDIA's
# H100 whitepaper, 133.8 TFLOP/s): the least time a kernel's work can take
# is the larger of its bytes over the memory rate and, for each type of
# operation, its operations over that type's rate.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16_tensor": 989e12, "bf16x2": 133.8e12, "fp32": 67e12}
# K1's shapes: the main path's, then the ViT configurations with longer sequences
ATTN_SHAPES = {
    (1, 6, 785, 64): "ViT-S/8 at 224, the main path",
    (4, 6, 785, 64): "ViT-S/8 at 224, frames_batch B=4",
    (1, 6, 1025, 64): "ViT-S/14 at 448",
    (1, 6, 3137, 64): "ViT-S/8 at 448",
    (1, 12, 2117, 64): "ViT-B/14 at 644",
    (1, 12, 785, 64): "ViT-B/8 at 224, the Jackal runtime's STEGO frame",
    (4, 12, 785, 64): "ViT-B/8 at 224, the STEGO frames_batch B=4",
    (1, 12, 3137, 64): "ViT-B/8 at 448, StegoInterface's default",
    (4, 12, 2117, 64): "ViT-B/14 at 644, BASELINE config 5's 4 cameras",
    (1, 6, 257, 64): "ViT-S/14 at 224, the exported engine's default",
}
# SLIC at 448: the least label agreement of the card's 10 iterations with the plain whole-image loop (the
# card's first reading: 0.9998 on a random image, 0.9998 to 1.0 on four demo frames, NVIDIA H100 80GB HBM3)
SLIC_448_MIN = 0.99
# the STEGO frame at 448 against the CPU: the whole frame (bf16 backbones that round differently, then
# k-means on codes that differ by that much) and the CPU tail fed the card's codes (K2 against its plain
# version, k-means in another summation order)
STEGO_CPU_TOL = {"agree": 0.95, "mae": 1e-2, "feat": 0.5}  # first reading: 0.9904, 7.2e-4 and 3.0e-3, 0.130
STEGO_SAME_CODES_TOL = {"agree": 0.99, "mae": 1e-3, "feat": 1e-3}
STEGO_LOSS_RTOL = 5e-2  # the STEGO runtime's per-step losses, card against CPU


def k1_bf16_check(out, ref, q, k, v, plain, atol_of) -> tuple[float, float, float]:
    """K1's bf16 error against the plain version, its limit (bf16_atol:
    2**-6 of the largest |output|, 2 to 4 bf16 units there) and the error of
    the plain version without the last kv tile of 64 rows, which the limit
    must fail: the check would catch a kernel that skipped that tile."""
    keep = (q.shape[2] - 1) // 64 * 64
    tail = float((plain(q, k[:, :, :keep], v[:, :, :keep], 0.125).float() - ref).abs().max())
    return float((out.float() - ref).abs().max()), atol_of(ref), tail


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0].strip()


def device_ms(fn, inputs) -> float:
    """Median device time of fn(*x) over the timed inputs, from CUDA
    events. A sleep kernel ahead of each run keeps the host's enqueue
    off the clock."""
    import torch

    for x in inputs[:WARMUP]:
        fn(*x)
    torch.cuda.synchronize()
    times = []
    for x in inputs[WARMUP:]:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn(*x)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def wall_ms(fn, inputs) -> float:
    """Median host latency of fn(*x) ending in a synchronize: what a caller
    of the frame function waits."""
    import torch

    for x in inputs[:WARMUP]:
        fn(*x)
    torch.cuda.synchronize()
    times = []
    for x in inputs[WARMUP:]:
        t0 = time.perf_counter()
        fn(*x)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def kernel_resources(report: str) -> list[str]:
    """Each kernel body's registers, static shared memory and spills from
    ptxas's report of the build (-Xptxas -v), with its dynamic shared memory
    at the main path's shapes."""
    from wild_visual_navigation_tpu_torch.ops import _cuda

    lib = _cuda.library()
    # name in the report -> (label, dynamic shared memory in bytes, at which shape); K1's bodies are templates on
    # the head dim and (bf16) the tile, one entry per instantiation
    kernels = {}
    for m in re.finditer(r"flash_fwd_(bf16|f32)_kernelILi(\d+)E(?:Li(\d+)ELi(\d+)E)?", report):
        D = int(m.group(2))
        if m.group(1) == "bf16":
            bq, bk = int(m.group(3)), int(m.group(4))
            kernels[m.group(0)] = (f"K1 flash_fwd_bf16_kernel<D={D}, BQ={bq}, BK={bk}>",
                                   lib.wvn_flash_attention_smem_bytes(D, 1, bq, bk), "")
        else:
            kernels[m.group(0)] = (f"K1 flash_fwd_f32_kernel<D={D}>", lib.wvn_flash_attention_smem_bytes(D, 0, 0, 0),
                                   "")
    kernels |= {"pixelwise_score_kernel": ("K2 pixelwise_score_kernel", lib.wvn_pixelwise_score_smem_bytes(256),
                                           " at K1=256"),
                # K3's bodies: templates on the rows and columns a lane takes (8, 4, 2 or 1 warps a tile);
                # dynamic shared memory at a layout each takes (ops/slic_fused.py::step_layout on an H100)
                "slic_step_kernelILi1ELi1E": ("K3 slic_step_kernel<1, 1> (8 warps a tile)",
                                              lib.wvn_slic_step_smem_bytes(100, 16, 16, 2),
                                              " at K=100, 224x224: 7 clusters of 16 CTAs of 2 tiles"),
                "slic_step_kernelILi1ELi2E": ("K3 slic_step_kernel<1, 2> (4 warps a tile)",
                                              lib.wvn_slic_step_smem_bytes(512, 8, 16, 2),
                                              " at K=512, 224x224: 7 clusters of 16 CTAs of 2 tiles"),
                "slic_step_kernelILi2ELi2E": ("K3 slic_step_kernel<2, 2> (2 warps a tile)",
                                              lib.wvn_slic_step_smem_bytes(100, 14, 16, 7),
                                              " at K=100, 448x448: 7 clusters of 16 CTAs of 7 tiles"),
                "slic_step_kernelILi4ELi2E": ("K3 slic_step_kernel<4, 2> (1 warp a tile)",
                                              lib.wvn_slic_step_smem_bytes(100, 16, 16, 16),
                                              " at K=100, 644x644: 7 clusters of 16 CTAs of 16 tiles"),
                "hull_fill_kernelILb1E": ("K4 hull_fill_kernel<march> (points to masks)", 0, ""),
                "hull_fill_kernelILb0E": ("K4 hull_fill_kernel<fill alone>", 0, "")}
    lines, key, spills = [], None, ""
    for line in report.splitlines():
        if "Function properties for" in line:
            key = next((k for k in kernels if k in line), None)
        elif key and "spill" in line:
            spills = line.strip()
        elif key and "Used" in line:
            label, dyn, at = kernels[key]
            lines.append(f"{label}: {line.split(':', 1)[1].strip()}; {spills}; dynamic smem {dyn} bytes{at}")
            key = None
    return lines


def tensor_core_counts(lib_path) -> dict[str, dict[str, int]]:
    """HMMA (mma.sync) and HGMMA (wgmma) instructions in the library's SASS,
    by kernel function (cuobjdump -sass names each function)."""
    import os

    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass", str(lib_path)], capture_output=True, text=True, check=True, timeout=300)
    counts, fn = {}, None
    for line in out.stdout.splitlines():
        if "Function : " in line:
            fn = line.split("Function : ", 1)[1].strip()
            counts[fn] = {"HMMA": 0, "HGMMA": 0}
        elif fn is not None:
            for op in ("HGMMA", "HMMA"):
                if op in line:
                    counts[fn][op] += 1
    return counts


def count_in(counts: dict, name: str, op: str) -> int:
    return sum(c[op] for fn, c in counts.items() if name in fn)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def bound(nbytes: float, flops: dict) -> dict:
    """bound_ms and what sets it, from the bytes a kernel must move (inputs
    read once, outputs written once) and its operations by type."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = max(n / PEAK_FLOPS[kind] for kind, n in flops.items())
    return {"bound_ms": max(t_bytes, t_ops) * 1e3, "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def slic_work(centers, H: int, W: int, ws: float, win2: float) -> tuple[int, int]:
    """The work K3 does on these centres: (pixel, candidate) pairs over the
    tiles' candidate lists, and the orphan pixels (no centre in the
    window), which scan all K."""
    import torch

    from wild_visual_navigation_tpu_torch.ops.slic_fused import TILE, tile_candidates_plain

    n_cand = tile_candidates_plain(centers, H, W, ws, win2)[0].sum(1)  # (tiles,)
    ys, xs = torch.arange(0, H, TILE), torch.arange(0, W, TILE)
    pix = ((H - ys).clamp(max=TILE)[:, None] * (W - xs).clamp(max=TILE)[None, :]).reshape(-1).to(n_cand.device)
    cy, cx = centers[0, :, 3] / ws, centers[0, :, 4] / ws
    p = torch.arange(H * W, device=centers.device)
    d2s = ((p // W)[:, None] - cy[None]) ** 2 + ((p % W)[:, None] - cx[None]) ** 2
    return int((n_cand * pix).sum()), int((d2s.min(1).values > win2).sum())


def profile_frames(frame, cg_state, demo, dev, card: str, n: int = 10, tag: str = "profile") -> None:
    """torch.profiler over n frames: device kernel time per frame by
    kernel, and the device's busy share of the wall time, on lines
    starting with [tag]."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    frames = [torch.from_numpy(demo[i : i + 1]).to(dev) for i in range(n)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for x in frames:
            frame(cg_state, x)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = [r for r in prof.key_averages() if str(r.device_type).endswith("CUDA") and r.device_time_total > 0]
    rows.sort(key=lambda r: r.device_time_total, reverse=True)
    busy = sum(r.device_time_total for r in rows) / 1e3
    print(f"[{tag}] {n} frames B=1: wall {wall:.2f} ms under the profiler, device kernels {busy:.3f} ms "
          f"({busy / n:.3f} ms per frame), busy share {busy / wall:.3f}; {sum(r.count for r in rows) / n:.0f} kernel "
          f"launches per frame | {card}")
    for r in rows[:14]:
        print(f"[{tag}]   {r.device_time_total / 1e3 / n:8.4f} ms/frame  {r.count / n:6.1f} calls/frame  "
              f"{r.key[:90]}")


def footprint_scene(rng, B: int, K: np.ndarray):
    """B robot footprints (1.0 x 0.6 m, between two poses up to 0.6 m
    apart, padded to 64 points as the estimator pads them) below B cameras
    looking down from 1.5-3 m with random yaw and offset. Returns numpy
    (K (B, 3, 3), camera poses (B, 4, 4), footprints (B, 64, 3))."""
    from wild_visual_navigation_tpu_torch.traversability.nodes import SupervisionNode

    def rot_z(a):
        return np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])

    cams, fps = [], []
    for _ in range(B):
        yaw = rng.uniform(-np.pi, np.pi)
        nodes = []
        for s in (0.0, rng.uniform(0.1, 0.6)):
            T = np.eye(4)
            T[:3, :3] = rot_z(yaw)
            T[:2, 3] = s * np.array([np.cos(yaw), np.sin(yaw)])
            nodes.append(SupervisionNode(timestamp=s, pose_base_in_world=T, width=0.6, length=1.0, height=0.3,
                                         twist_in_base=np.ones(3)))
        fp = nodes[1].make_footprint_with_node(nodes[0])
        fps.append(np.concatenate([fp, np.tile(fp[-1:], (64 - len(fp), 1))]))
        cam = np.eye(4)
        cam[:3, :3] = rot_z(rng.uniform(-np.pi, np.pi)) @ np.diag([1.0, -1.0, -1.0])
        cam[:3, 3] = [rng.uniform(-0.5, 0.5), rng.uniform(-0.5, 0.5), rng.uniform(1.5, 3.0)]
        cams.append(cam)
    return (np.tile(K[None], (B, 1, 1)).astype(np.float32), np.stack(cams).astype(np.float32),
            np.stack(fps).astype(np.float32))


def scene_points(dev, rng, B: int, K: np.ndarray, size: int):
    """Projected footprints (B, 64, 2) and their masks (B, 64) (in front of
    the camera), on `dev`: what the supervision flush hands K4."""
    import torch

    from wild_visual_navigation_tpu_torch.ops.projection import Camera, project_points

    Ks, poses, fps = (torch.from_numpy(a).to(dev) for a in footprint_scene(rng, B, K))
    p2d, _, valid_z = project_points(Camera(Ks, size, size), poses, fps)
    return p2d, valid_z


def product_estimator(dev, size: int, num_segments: int, feature_dim: int):
    """The estimator at the product's settings (cfg/node_params.py,
    cfg/experiment.py): capacity 256, fan-out 32, batch 8, the
    [256, 32, 1] head from seed 0."""
    from wild_visual_navigation_tpu_torch.cfg.experiment import ExperimentParams
    from wild_visual_navigation_tpu_torch.cfg.node_params import LearningNodeParams
    from wild_visual_navigation_tpu_torch.traversability.estimator import TraversabilityEstimator

    ln, exp = LearningNodeParams(), ExperimentParams()
    return TraversabilityEstimator(
        model_cfg={"name": "SimpleMLP", "simple_mlp_cfg": {"input_size": feature_dim, "hidden_sizes": [256, 32, 1],
                                                           "reconstruction": True}},
        loss_cfg=exp.loss_cfg(), lr=exp.optimizer.lr, max_distance=ln.traversability_radius,
        image_distance_thr=ln.image_graph_dist_thr, supervision_distance_thr=ln.supervision_graph_dist_thr,
        min_samples_for_training=ln.min_samples_for_training, batch_size=exp.ablation_data_module.batch_size,
        buffer_capacity=256, num_segments=num_segments, feature_dim=feature_dim, image_height=size,
        image_width=size, reprojection_fanout=32, seed=0, device=dev)


def mission_events(seq: dict) -> list:
    """(stamp, 0 for a frame or 1 for a robot state, index) in stamp order."""
    return sorted([(t, 0, i) for i, t in enumerate(seq["frame_stamps"])] +
                  [(t, 1, i) for i, t in enumerate(seq["state_stamps"])], key=lambda e: e[0])


def frame_node(seq: dict, i: int, stamp: float):
    from wild_visual_navigation_tpu_torch.traversability.nodes import MissionNode

    return MissionNode(timestamp=float(stamp), pose_base_in_world=seq["frame_pose"][i],
                       pose_cam_in_base=seq["frame_cam_in_base"][i], camera_name=str(seq["frame_cameras"][i]))


def state_node(seq: dict, i: int, stamp: float, sg):
    """Robot state i through the supervision generator `sg`, as a
    SupervisionNode of the product's robot."""
    from wild_visual_navigation_tpu_torch.cfg.node_params import LearningNodeParams
    from wild_visual_navigation_tpu_torch.traversability.nodes import SupervisionNode

    ln = LearningNodeParams()
    trav, var, untrav = sg.update_velocity_tracking(seq["state_twist"][i], seq["state_desired"][i],
                                                    max_velocity=0.8, velocities=["vx", "vy"])
    return SupervisionNode(timestamp=float(stamp), pose_base_in_world=seq["state_pose"][i],
                           twist_in_base=seq["state_twist"][i], desired_twist_in_base=seq["state_desired"][i],
                           length=ln.robot_length, width=ln.robot_width, height=ln.robot_height,
                           traversability=trav, traversability_var=var, is_untraversable=untrav)


def replay_learning(dev, frame, cg_state, seq: dict, size: int, num_segments: int, feature_dim: int,
                    frames_in=None):
    """Replay a recorded mission through the online learning loop at the
    product's settings (cfg/node_params.py, cfg/experiment.py), in stamp
    order as the JAX package's runtime replay does: each frame through
    `frame` and add_mission_node, each robot state through the
    supervision generator, add_supervision_node and one train step.

    frames_in: per-frame (features, feat_valid, segments) to use in place
    of running `frame` (the CPU replay takes the card's frame outputs, so
    it compares the learning loop alone). Returns the estimator and a dict
    of what the replay saw."""
    import torch

    import wild_visual_navigation_tpu_torch as port
    from wild_visual_navigation_tpu_torch.cfg.node_params import LearningNodeParams
    from wild_visual_navigation_tpu_torch.ops.projection import scale_intrinsics
    from wild_visual_navigation_tpu_torch.supervision.supervision_generator import SupervisionGenerator

    ln = LearningNodeParams()
    est = product_estimator(dev, size, num_segments, feature_dim)
    sg = SupervisionGenerator(untraversable_thr=ln.untraversable_thr)
    updates, samples = [], []
    reproject, sample = est._reproject_update, est._sample_indices

    def recorded_reproject(*args):
        updates.append(args)
        return reproject(*args)

    def recorded_sample(batch_size=None):
        idx = sample(batch_size)
        if idx is not None:
            samples.append(idx.tolist())
        return idx

    est._reproject_update, est._sample_indices = recorded_reproject, recorded_sample
    events = mission_events(seq)
    frames_out, losses, flushes, k4_per_flush = [], [], 0, []
    for stamp, kind, i in events:
        if kind == 0:
            h0, w0 = seq["frame_images"].shape[2:]
            if frames_in is None:
                res = frame(cg_state, torch.from_numpy(seq["frame_images"][i : i + 1]).to(dev))
                out = (res.features, res.feat_valid, res.segments)
            else:
                out = frames_in[i]
            frames_out.append(out)
            K_scaled = scale_intrinsics(seq["frame_K"][i], h0, w0, new_h=size)
            est.add_mission_node(frame_node(seq, i, stamp), *out, K_scaled)
            continue
        snode = state_node(seq, i, stamp, sg)
        n_updates, k4 = len(updates), port.launch_counts()["fill_hulls"]
        if est.add_supervision_node(snode):
            flushes += 1
            k4_per_flush.append((len(updates) - n_updates, port.launch_counts()["fill_hulls"] - k4))
        step = est.step
        out = est.train(convert_losses=False)
        if est.step > step:
            losses.append(out["loss_total"])
    losses = [float(x) for x in losses]
    return est, {"frames": frames_out, "losses": losses, "flushes": flushes, "k4_per_flush": k4_per_flush,
                 "updates": updates, "samples": samples,
                 "valid_nodes": est.get_num_valid_nodes()}


def runtime_params():
    """The product's node settings (cfg/node_params.py) with the callback
    rates raised so a replay at virtual time is not gated, as the demo
    raises them (demo_online.py)."""
    from wild_visual_navigation_tpu_torch.cfg.node_params import FeatureExtractorNodeParams, LearningNodeParams

    return (FeatureExtractorNodeParams(image_callback_rate=1e9),
            LearningNodeParams(supervision_callback_rate=1e9))


def make_runtime(dev):
    """WVNRuntime at the product's settings: DINO ViT-S/8 at 224 (seed 0, the
    frame phase's backbone), SLIC 100, per-pixel prediction, buffer 256,
    fan-out 32, batch 8."""
    from wild_visual_navigation_tpu_torch.runtime import WVNRuntime

    fe, ln = runtime_params()
    return WVNRuntime(fe_params=fe, ln_params=ln, seed=0, buffer_capacity=256, reprojection_fanout=32, device=dev)


def replay_runtime(rt, seq):
    """run_replay through the runtime's callbacks, with the losses each
    learning step read back (every `logging` tick) and the launches."""
    import wild_visual_navigation_tpu_torch as port
    from wild_visual_navigation_tpu_torch.runtime import run_replay

    losses, step = [], rt.learning_step

    def recorded():
        before = rt.estimator.step
        st = step()
        if rt.estimator.step > before and st.step % 5 == 0 and st.loss_total > 0:
            losses.append(st.loss_total)
        return st

    rt.learning_step = recorded
    port.reset_launch_counts()
    rep = run_replay(rt, seq)
    if rt.estimator.buffer.features.is_cuda:
        import torch

        torch.cuda.synchronize()
    counts = port.launch_counts()
    rt.learning_step = step
    return rep, losses, counts


def learning_node_process(sock_path: str, folder: str, seq_path: str, device: str, queue) -> None:
    """The learning process of the two-process topology (started with
    spawn): a LearningNode on the card fed ImageFeatures over a Unix
    socket, and the recorded mission's robot states in stamp order; it
    writes the hot-swap file at the checkpoint rate and at shutdown."""
    sys.path.insert(0, str(ROOT))
    try:
        import torch

        import wild_visual_navigation_tpu_torch as port
        from wild_visual_navigation_tpu_torch.runtime.msgs import ImageFeatures
        from wild_visual_navigation_tpu_torch.runtime.nodes import LearningNode
        from wild_visual_navigation_tpu_torch.runtime.transport import SocketSubscriber

        fe, ln = runtime_params()
        node = LearningNode(fe_params=fe, ln_params=ln, hot_swap_folder=folder, device=device)
        writes, write = [], node._write_hot_swap

        def counted():
            writes.append(node.runtime.estimator.step)
            return write()

        node._write_hot_swap = counted
        sub = SocketSubscriber(sock_path, maxlen=100_000)
        queue.put({"connected": True})
        seq = np.load(seq_path)
        n_states, si, frames, flushes = len(seq["state_stamps"]), 0, 0, 0
        port.reset_launch_counts()

        def states_before(stamp):
            nonlocal si, flushes
            while si < n_states and seq["state_stamps"][si] < stamp:
                flushes += node.robot_state_callback(float(seq["state_stamps"][si]), seq["state_pose"][si],
                                                     seq["state_twist"][si], seq["state_desired"][si])
                node.learning_step()
                si += 1

        while True:
            payload = sub.poll()
            if payload is None:
                time.sleep(0.001)
                continue
            if payload == b"END":
                break
            states_before(ImageFeatures.unpack(payload).stamp)
            node.imagefeat_callback(payload)
            frames += 1
        states_before(float("inf"))
        node.shutdown(str(Path(folder) / "mission"))
        if device == "cuda":
            torch.cuda.synchronize()
        est = node.runtime.estimator
        queue.put({"frames": frames, "flushes": flushes, "steps": est.step, "valid_nodes": est.get_num_valid_nodes(),
                   "mission_nodes": len(est.get_mission_nodes()), "hot_swap_writes": writes,
                   "launches": port.launch_counts(), "errors": len(node.runtime.events.snapshot()["errors"])})
        sub.close()
    except Exception as exc:  # reported to the parent, which raises
        import traceback

        queue.put({"error": "".join(traceback.format_exception(exc))})


def from_child(queue, proc, timeout: float) -> dict:
    """The child's next message; raises if it died or the time ran out."""
    import queue as queue_mod

    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        try:
            msg = queue.get(timeout=1.0)
        except queue_mod.Empty:
            require(proc.is_alive(), f"the learning process exited with code {proc.exitcode}")
            continue
        require("error" not in msg, f"learning process: {msg.get('error')}")
        return msg
    raise RuntimeError(f"check failed: no message from the learning process in {timeout:.0f} s")


def two_process(dev, seq: dict, seq_path: Path) -> dict:
    """A LearningNode in a spawned process on the same card, fed by a
    FeatureExtractorNode in this one over a Unix socket, frames at 10 Hz
    (the camera rate); the feature node polls the hot-swap file after every
    frame and once more after the learner's shutdown."""
    import multiprocessing as mp
    import shutil
    import tempfile

    import wild_visual_navigation_tpu_torch as port
    from wild_visual_navigation_tpu_torch.runtime.nodes import FeatureExtractorNode
    from wild_visual_navigation_tpu_torch.runtime.transport import SocketPublisher

    sock_dir = tempfile.mkdtemp(prefix="wvn")  # a short path: Unix socket paths hold at most 107 bytes
    sock = str(Path(sock_dir) / "features.sock")
    folder = str(Path(sock_dir) / "hot_swap")
    pub = SocketPublisher(sock)
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    proc = ctx.Process(target=learning_node_process, args=(sock, folder, str(seq_path), torch_device(dev), queue),
                       daemon=True)
    t0 = time.perf_counter()
    proc.start()
    try:
        from_child(queue, proc, 300)
        deadline = time.perf_counter() + 30
        while not pub._conns and time.perf_counter() < deadline:  # the publisher accepts on its own thread
            time.sleep(0.01)
        require(bool(pub._conns), "the learning process's subscriber connected")
        started = time.perf_counter() - t0
        fe, _ = runtime_params()
        node = FeatureExtractorNode(params=fe, hot_swap_folder=folder, publish_features=pub.publish, seed=0,
                                    device=dev)
        reloads, port_counts = [], None
        port.reset_launch_counts()
        for i in range(len(seq["frame_stamps"])):
            tick = time.perf_counter()
            trav, conf = node.image_callback(seq["frame_images"][i], float(seq["frame_stamps"][i]), "front",
                                             seq["frame_K"][i], 64, 64, seq["frame_pose"][i],
                                             seq["frame_cam_in_base"][i])
            require(np.isfinite(trav).all() and np.isfinite(conf).all(), "feature node maps finite")
            if node.maybe_reload_weights():
                reloads.append(node._loaded_step)
            time.sleep(max(0.0, 0.1 - (time.perf_counter() - tick)))
        port_counts = port.launch_counts()
        pub.publish(b"END")
        out = from_child(queue, proc, 600)
        proc.join(timeout=60)
        final = node.maybe_reload_weights()
        if final:
            reloads.append(node._loaded_step)
        return {**out, "reloads": reloads, "final_reload": final, "startup_s": started,
                "feature_launches": port_counts, "wall_s": time.perf_counter() - t0}
    finally:
        pub.close()
        if proc.is_alive():
            proc.kill()
            proc.join(timeout=30)
        shutil.rmtree(sock_dir, ignore_errors=True)


def profile_calls(fn, inputs) -> tuple[float, float, float, float]:
    """torch.profiler over fn(*x) for each input: (wall ms per call, device
    kernel ms per call, kernel launches per call, busy share)."""
    p = profile_ops(fn, inputs)
    return p["wall_ms"], p["device_ms"], p["launches"], p["busy"]


def torch_device(dev) -> str:
    return str(dev).split(":")[0]


def runtime_phase(dev, card: str, seq: dict, seq_path: Path, learn: dict) -> dict:
    """The port's WVNRuntime at the product's settings, through the entry
    points a robot stack calls: the recorded mission replayed (launches per
    accepted frame and per flush), the same replay on the CPU, the batched
    callback against single ones, the learning thread while frames arrive,
    the two-process topology, and the callbacks' timings. Returns the
    replay's launches by kernel."""
    import torch

    import wild_visual_navigation_tpu_torch as port
    from wild_visual_navigation_tpu_torch.runtime import load_sequence
    from wild_visual_navigation_tpu_torch.runtime.replay import Sequence

    sequence = load_sequence(str(seq_path))
    n_frames = len(sequence.frames)

    # 1. the mission through the runtime on the card
    rt = make_runtime(dev)
    t0 = time.perf_counter()
    rep, losses, counts = replay_runtime(rt, sequence)
    replay_s = time.perf_counter() - t0
    per = {k: counts[k] / max(rep.frames_processed, 1) for k in ("flash_attention", "pixelwise_score", "slic_step")}
    k4 = counts["fill_hulls"] / max(rep.supervision_updates, 1)
    print(f"[runtime] run_replay of {n_frames} frames + {len(sequence.states)} robot states through WVNRuntime in "
          f"{replay_s:.2f} s: {rep.frames_processed} frames processed, {rep.frames_gated} gated, "
          f"{rep.supervision_updates} supervision updates, {rep.train_steps} train steps, {rep.valid_nodes} valid "
          f"nodes; losses read back, first {[round(x, 5) for x in losses[:3]]}, last {[round(x, 5) for x in losses[-3:]]}"
          f"; {rt.hot_swaps} hot swaps", flush=True)
    print(f"[runtime] launches {counts}: per accepted frame K1 {per['flash_attention']:.2f}, K2 "
          f"{per['pixelwise_score']:.2f}, K3 {per['slic_step']:.2f}; per flush K4 {k4:.2f}")
    from wild_visual_navigation_tpu_torch.ops.slic_fused import cluster_slots, slic_step, step_layout

    paths = dict(slic_step.variant_launches)
    want = step_layout(224, 224, 100, cluster_slots(dev))
    print(f"[runtime] K3 launches by reduction path {paths}; the frame's step at 224x224, K=100 is {want}, "
          f"{want.variant!r}")
    require(paths == {want.variant: counts["slic_step"]}, "every K3 launch of the replay takes the frame's path")
    require(rep.frames_processed == n_frames and rep.frames_gated == 0, "every frame accepted")
    require(per == {"flash_attention": 12, "pixelwise_score": 1, "slic_step": 11} and k4 == 1,
            "K1 12, K2 1, K3 11 per accepted frame and K4 1 per flush")
    require(rep.supervision_updates == learn["flushes"] and rep.valid_nodes == learn["valid_nodes"]
            and rep.train_steps == learn["steps"],
            f"the runtime's replay counts equal replay_learning's ({learn['flushes']} flushes, "
            f"{learn['valid_nodes']} valid nodes, {learn['steps']} steps)")
    require(len(losses) >= 3 and all(np.isfinite(losses)) and losses[-1] < losses[0], "finite falling losses")
    trav, conf = rep.last_result.to_numpy()
    require(trav.shape == (rt._H, rt._W) and np.isfinite(trav).all() and np.isfinite(conf).all()
            and trav.min() >= 0 and trav.max() <= 1, "the last frame's maps finite, in [0, 1]")

    # 2. the mission's first 20 frames on the card and on the CPU, through the plain versions (as the other
    # runtimes' phases hold theirs; the whole mission took 76 s on the CPU, over the smoke's time)
    last = sequence.frames[19].stamp
    head20 = Sequence(frames=sequence.frames[:20], states=[s for s in sequence.states if s.stamp <= last])
    rt20 = make_runtime(dev)
    rep20, losses20, _ = replay_runtime(rt20, head20)
    t0 = time.perf_counter()
    rt_cpu = make_runtime("cpu")
    rep_cpu, losses_cpu, counts_cpu = replay_runtime(rt_cpu, head20)
    cpu_s = time.perf_counter() - t0
    trav, conf = rep20.last_result.to_numpy()
    trav_c, conf_c = rep_cpu.last_result.to_numpy()
    occupied = rt20.estimator.buffer.valid.cpu()
    m_gpu = rt20.estimator.buffer.supervision_mask.cpu()[occupied]
    m_cpu = rt_cpu.estimator.buffer.supervision_mask[occupied]
    mask_differ = int((m_gpu != m_cpu).sum())
    loss_diff = max((abs(a - b) / abs(b) for a, b in zip(losses20, losses_cpu)), default=float("nan"))
    same = all(getattr(rep20, f) == getattr(rep_cpu, f) for f in
               ("frames_processed", "frames_gated", "supervision_updates", "train_steps", "valid_nodes"))
    print(f"[runtime] the first 20 frames on the card and on the CPU (plain versions, {cpu_s:.1f} s): counts equal: "
          f"{same} "
          f"({rep_cpu.frames_processed} frames, {rep_cpu.supervision_updates} updates, {rep_cpu.train_steps} steps, "
          f"{rep_cpu.valid_nodes} valid nodes); no kernel launched: {sum(counts_cpu.values()) == 0}; supervision masks "
          f"differ in {mask_differ} of {m_gpu.numel()} pixels; the last frame's trav mean abs diff "
          f"{np.abs(trav - trav_c).mean():.3e} (tol 1e-2), max {np.abs(trav - trav_c).max():.3e} (tol 1e-1), conf mean "
          f"abs diff {np.abs(conf - conf_c).mean():.3e} (tol 5e-2); max relative loss difference {loss_diff:.3e} "
          f"(tol 5e-2)", flush=True)
    require(same and sum(counts_cpu.values()) == 0, "the CPU replay's counts equal the card's")
    require(mask_differ <= 1e-4 * m_gpu.numel(), "supervision masks agree with the CPU replay")
    # the bf16 backbones round differently on the two devices, and the heads then train on features that differ
    # by that much, so the maps are held to a bf16-scale tolerance
    require(np.abs(trav - trav_c).mean() <= 1e-2 and np.abs(trav - trav_c).max() <= 1e-1
            and np.abs(conf - conf_c).mean() <= 5e-2 and loss_diff <= 5e-2, "maps and losses agree with the CPU replay")
    del rt_cpu, rt20

    # 3. image_batch_callback at B=4 against four image_callbacks
    rt_b, rt_s = make_runtime(dev), make_runtime(dev)
    idx = np.arange(4)
    args = (seq["frame_images"][idx], seq["frame_stamps"][idx], ["front"] * 4, seq["frame_K"][idx], 64, 64,
            seq["frame_pose"][idx], seq["frame_cam_in_base"][idx])
    port.reset_launch_counts()
    batch = rt_b.image_batch_callback(*args)
    torch.cuda.synchronize()
    batch_counts = port.launch_counts()
    singles = [rt_s.image_callback(seq["frame_images"][i], float(seq["frame_stamps"][i]), "front", seq["frame_K"][i],
                                   64, 64, seq["frame_pose"][i], seq["frame_cam_in_base"][i]) for i in idx]
    t_diff = max(float((b.traversability - s.traversability).abs().max()) for b, s in zip(batch, singles))
    c_diff = max(float((b.confidence - s.confidence).abs().max()) for b, s in zip(batch, singles))
    slots_b = [(n.timestamp, n.buffer_slot) for n in rt_b.estimator.get_mission_nodes()]
    slots_s = [(n.timestamp, n.buffer_slot) for n in rt_s.estimator.get_mission_nodes()]
    f_diff = float((rt_b.estimator.buffer.features - rt_s.estimator.buffer.features).abs().max())
    seg_same = bool(torch.equal(rt_b.estimator.buffer.seg, rt_s.estimator.buffer.seg))
    print(f"[runtime] image_batch_callback B=4 against 4 image_callbacks: trav max abs diff {t_diff:.3e}, conf "
          f"{c_diff:.3e} (tol 2e-2); mission nodes and slots equal: {slots_b == slots_s} ({len(slots_b)}); buffer "
          f"segments equal: {seg_same}, features max abs diff {f_diff:.3e} (tol 0.25); the batch launched "
          f"{batch_counts}")
    require(t_diff <= 2e-2 and c_diff <= 2e-2 and slots_b == slots_s and seg_same and f_diff <= 0.25,
            "the batched callback agrees with single callbacks")
    require(batch_counts == {"flash_attention": 12, "pixelwise_score": 1, "slic_step": 11, "fill_hulls": 0},
            "the batch runs the backbone, SLIC and K2 once")
    del rt_b, rt_s

    # 4. the learning thread at 10 Hz while the mission's frames arrive at 20 Hz
    rt_t = make_runtime(dev)
    used, frame_fn = [], rt_t._fused_frame

    def recording(cg, x, head=None):
        used.append(head)
        return frame_fn(cg, x, head)

    recording.frames_batch = frame_fn.frames_batch
    rt_t._fused_frame = recording
    initial = rt_t.inference_head[0]
    rt_t.start_learning_thread()
    t0 = time.perf_counter()
    try:
        for _, kind, p in sequence.events():
            if kind == "frame":
                res = rt_t.image_callback(p.image, p.stamp, p.camera, p.K, 64, 64, p.pose_base_in_world,
                                          p.pose_cam_in_base)
                time.sleep(0.05)
            else:
                rt_t.robot_state_callback(p.stamp, p.pose_base_in_world, p.current_twist, p.desired_twist)
    finally:
        rt_t.stop_learning_thread()
    thread_s = time.perf_counter() - t0
    t_last, c_last = res.to_numpy()
    errors = rt_t.events.snapshot()["errors"]
    swapped = used[-1] is not initial and used[-1] is not None
    print(f"[runtime] learning thread at {rt_t.ln_params.learning_thread_rate:.0f} Hz while {n_frames} frames arrive "
          f"over {thread_s:.2f} s: {rt_t.estimator.step} train steps, {rt_t.hot_swaps} hot swaps, {len(errors)} "
          f"errors in the events journal; the last frame scored with a swapped head: {swapped}; its maps finite: "
          f"{bool(np.isfinite(t_last).all() and np.isfinite(c_last).all())}", flush=True)
    require(not errors, f"no error in the events journal: {errors[:1]}")
    require(rt_t.estimator.step > 0 and rt_t.hot_swaps >= 2 and swapped, "the thread trained and swapped heads")
    require(np.isfinite(t_last).all() and np.isfinite(c_last).all(), "maps finite under the learning thread")
    del rt_t

    # 5. the two-process topology
    tp = two_process(dev, seq, seq_path)
    print(f"[runtime] two processes (LearningNode spawned on the same card, FeatureExtractorNode here, Unix socket): "
          f"learner up in {tp['startup_s']:.1f} s, whole exchange {tp['wall_s']:.1f} s; the learner ingested "
          f"{tp['frames']} frames, {tp['flushes']} flushes, {tp['steps']} train steps, {tp['valid_nodes']} valid "
          f"nodes, hot-swap writes at steps {tp['hot_swap_writes']}, launches {tp['launches']}, {tp['errors']} errors; "
          f"the feature node reloaded at steps {tp['reloads']} (the last after the learner's shutdown: "
          f"{tp['final_reload']}) and launched {tp['feature_launches']}", flush=True)
    require(tp["frames"] == n_frames and tp["errors"] == 0, "the learner ingested every frame")
    require(tp["flushes"] == rep.supervision_updates and tp["valid_nodes"] == rep.valid_nodes
            and tp["steps"] == rep.train_steps, "the two-process mission counts equal the runtime's")
    require(len(tp["reloads"]) >= 1 and tp["final_reload"], "the feature node reloaded the hot-swap file")
    require(tp["launches"]["fill_hulls"] == tp["flushes"] and tp["feature_launches"]["slic_step"] == 11 * n_frames
            and tp["feature_launches"]["flash_attention"] == 12 * n_frames,
            "K4 once per flush in the learner; K1 and K3 in the feature node")

    # 6. timings, each host latency ending in a synchronize
    rt_time = make_runtime(dev)
    frames = [(seq["frame_images"][i], float(seq["frame_stamps"][i]), "front", seq["frame_K"][i], 64, 64,
               seq["frame_pose"][i], seq["frame_cam_in_base"][i]) for i in range(WARMUP + N_TIMED)]
    head, cg = rt_time.inference_head
    bare = [(cg, torch.from_numpy(seq["frame_images"][i : i + 1]).to(dev), head) for i in range(WARMUP + N_TIMED)]
    lat_cb = wall_ms(rt_time.image_callback, frames)
    lat_frame = wall_ms(rt_time._fused_frame, bare)
    lat_cb2 = wall_ms(make_runtime(dev).image_callback, frames)
    lat_frame2 = wall_ms(rt_time._fused_frame, bare)
    prof_cb = profile_calls(make_runtime(dev).image_callback, frames[:10])
    prof_frame = profile_calls(rt_time._fused_frame, bare[:10])
    batches = [(seq["frame_images"][np.arange(i, i + 4) % n_frames], [float(seq["frame_stamps"][i]) + 100.0 + j
                                                                       for j in range(4)],
                ["front"] * 4, seq["frame_K"][:4], 64, 64, seq["frame_pose"][np.arange(i, i + 4) % n_frames],
                seq["frame_cam_in_base"][:4]) for i in range(WARMUP + N_TIMED)]
    lat_b4 = wall_ms(rt_time.image_batch_callback, batches)
    # supervision: new robot states past the end of the mission, each one flushing over the fan-out
    last = len(seq["state_stamps"]) - 1
    heading = seq["state_pose"][last][:3, 0]

    def state(k):
        T = seq["state_pose"][last].copy()
        T[:3, 3] += 0.25 * (k + 1) * heading
        return (float(seq["state_stamps"][last]) + 0.2 * (k + 1), T, seq["state_twist"][last], seq["state_desired"][last])

    flushed = []

    def robot_state(*a):
        flushed.append(rt.robot_state_callback(*a))

    lat_rs = wall_ms(robot_state, [state(k) for k in range(WARMUP + N_TIMED)])
    lat_ls = wall_ms(rt.learning_step, [() for _ in range(WARMUP + N_TIMED)])
    print(f"[time] image_callback B=1 (64x64 demo frame, upload, frame, buffer insert): {lat_cb:.3f} ms, then "
          f"{lat_cb2:.3f} ms; the bare frame (the same frames on the card, the mailbox head) {lat_frame:.3f} ms, then "
          f"{lat_frame2:.3f} ms; on the host clock | {card}")
    print(f"[time] under the profiler, 10 calls each: image_callback {prof_cb[0]:.3f} ms per call, device kernels "
          f"{prof_cb[1]:.3f} ms, {prof_cb[2]:.0f} launches per call, busy share {prof_cb[3]:.3f}; bare frame "
          f"{prof_frame[0]:.3f} ms, device {prof_frame[1]:.3f} ms, {prof_frame[2]:.0f} launches, busy share "
          f"{prof_frame[3]:.3f} | {card}")
    print(f"[time] image_batch_callback B=4: {lat_b4:.3f} ms ({lat_b4 / 4:.3f} ms per frame) | {card}")
    print(f"[time] robot_state_callback with its flush (fan-out 32, 224x224, S=100; {sum(flushed)} of "
          f"{len(flushed)} calls flushed): {lat_rs:.3f} ms | {card}")
    print(f"[time] learning_step (train step, batch 8, with the deferred supervision readback and a loss readback "
          f"every 5th step): {lat_ls:.3f} ms | {card}", flush=True)
    require(sum(flushed) == len(flushed), "every timed robot state flushed")
    return counts


STEGO_HEAD = {"name": "SimpleMLP", "simple_mlp_cfg": {"input_size": 90, "hidden_sizes": [256, 32, 1],
                                                     "reconstruction": True}}


def k2_bound(ops, n_px: int) -> tuple[dict, dict, int]:
    """K2's bound over n_px output pixels. Bytes: its operands (hw at the
    patch rows, zsts, the weights and row tables) in, the two fp32 maps out.
    Operations per pixel, with K1 and K from the head: the K1 -> K product on
    the tensor cores (2 K K1); the H lerp of hw, two products and a sum per
    channel in bf16x2 (3 K1); in fp32 the bias and relu (2 K), the logit
    (2 K), the quadratic form over the upper triangle of the symmetric M
    (K (K + 1)), the z lerp (3 K), 2 x1 . (v - z) (3 K) and the rest of reco
    and the sigmoid (16). Returns (bound, operations by type, bytes)."""
    K1, K = ops.w1t.shape[1], ops.w1t.shape[0]
    k2_ops = {"bf16_tensor": 2 * K * K1 * n_px, "bf16x2": 3 * K1 * n_px, "fp32": (K * (K + 1) + 10 * K + 16) * n_px}
    k2_bytes = sum(x.numel() * x.element_size() for x in ops) + 2 * n_px * 4
    return bound(k2_bytes, k2_ops), k2_ops, k2_bytes


def jackal_params():
    """The Jackal robot's profile (configs/default.yaml, then
    configs/robots/jackal.yaml: stego features and segments, ViT-B/8 at 224,
    per-pixel prediction) with the callback rates raised for a replay at
    virtual time."""
    import dataclasses

    from wild_visual_navigation_tpu_torch.utils.loading import load_node_params

    fe, ln = load_node_params(str(ROOT / "configs/default.yaml"), str(ROOT / "configs/robots/jackal.yaml"))
    return (dataclasses.replace(fe, image_callback_rate=1e9), dataclasses.replace(ln, supervision_callback_rate=1e9))


def make_jackal_runtime(dev, like=None):
    """WVNRuntime in the Jackal profile (buffer 256, fan-out 32, backbone seed
    0); `like` hands over another such runtime's ViT-B/8 weights, so the
    CPU twin skips the random draw."""
    from wild_visual_navigation_tpu_torch.runtime import WVNRuntime

    fe, ln = jackal_params()
    backbone = None
    if like is not None:
        backbone = {k: v.cpu() for k, v in like.feature_extractor._extractor.vit.state_dict().items()}
    return WVNRuntime(fe_params=fe, ln_params=ln, seed=0, buffer_capacity=256, reprojection_fanout=32, device=dev,
                      backbone_params=backbone)


def record_train_losses(rt) -> list:
    """Every optimisation step's loss, kept as the device scalar it is and
    read after the run."""
    out, train = [], rt.estimator.train

    def recorded(convert_losses=True):
        before = rt.estimator.step
        res = train(convert_losses=convert_losses)
        if rt.estimator.step > before:
            out.append(res["loss_total"])
        return res

    rt.estimator.train = recorded
    return out


def slic_448_phase(dev, card: str, g, mlp, cg_state, demo) -> None:
    """SLIC at 448 px: the card's 10-iteration slic_batch (K3, per-tile sums)
    against the plain whole-image loop on the same images, and what the other
    order does to a ViT-S/8 frame at 448 that scores per segment (per-pixel
    maps do not depend on the segments)."""
    import torch

    from wild_visual_navigation_tpu_torch.feature_extractor.dino import DinoInterface
    from wild_visual_navigation_tpu_torch.models.vit import dense_features
    from wild_visual_navigation_tpu_torch.ops.resize import imagenet_normalize, resize_image
    from wild_visual_navigation_tpu_torch.ops.slic import slic_batch
    from wild_visual_navigation_tpu_torch.runtime.fused import build_fused_frame_fn
    from wild_visual_navigation_tpu_torch.utils.confidence_generator import ConfidenceConfig

    imgs = {"random": torch.rand(1, 3, 448, 448, device=dev, generator=g),
            "demo frames 0-3": resize_image(torch.from_numpy(demo[:4]).to(dev), 448, 448)}
    agree, segs = {}, {}
    for name, x in imgs.items():
        t0 = time.perf_counter()
        segs[name] = slic_batch(x), slic_batch(x.cpu()).to(dev)
        plain_s = time.perf_counter() - t0
        agree[name] = [float((segs[name][0][b] == segs[name][1][b]).float().mean()) for b in range(x.shape[0])]
    print(f"[slic 448] 10 iterations, K=100, card (K3) against the plain whole-image loop, label agreement: "
          + "; ".join(f"{k} {[round(a, 4) for a in v]}" for k, v in agree.items()) + f" (min {SLIC_448_MIN}); the "
          f"plain loop took {plain_s:.1f} s for the 4 demo frames on the host", flush=True)
    require(min(min(v) for v in agree.values()) >= SLIC_448_MIN, "SLIC at 448 agrees with the plain loop")

    dino = DinoInterface(input_size=448, device=dev, seed=0)
    frame = build_fused_frame_fn(dino.vit, mlp, ConfidenceConfig(std_factor=0.5), 448, prediction_per_pixel=False)
    x = imgs["demo frames 0-3"]
    feat = dense_features(dino.vit, imagenet_normalize(x))
    a, b = (frame.tail(cg_state, feat, seg) for seg in segs["demo frames 0-3"])
    t_mae = float((a.traversability - b.traversability).abs().mean())
    c_mae = float((a.confidence - b.confidence).abs().mean())
    print(f"[slic 448] ViT-S/8 frame at 448 scoring per segment, demo frames 0-3, K3's segments against the plain "
          f"loop's: trav MAE {t_mae:.3e}, conf MAE {c_mae:.3e} (tol 5e-2 each) | {card}", flush=True)
    require(t_mae <= 5e-2 and c_mae <= 5e-2, "the per-segment maps at 448 agree across the two SLIC orders")


def stego_phase(dev, card: str, g, demo, seq_path: Path) -> dict:
    """The STEGO path (BASELINE config 3; the Jackal robot's profile): K2 with
    the 90-d STEGO head, the fused STEGO frame at 448 in both scoring forms
    against the same frame on the CPU, the Jackal runtime's replay of the
    recorded mission at 224 (and its first 20 frames on the CPU), and the
    frame's latency at 224 and 448. Returns the replay's launches and K2's
    D = 90 times."""
    import torch

    import wild_visual_navigation_tpu_torch as port
    from wild_visual_navigation_tpu_torch.feature_extractor.stego import StegoInterface
    from wild_visual_navigation_tpu_torch.models.registry import get_model
    from wild_visual_navigation_tpu_torch.ops.flash_attention import bf16_atol, flash_attention, xla_attention
    from wild_visual_navigation_tpu_torch.ops.pixelwise_fused import (
        fused_precompute,
        pixelwise_score_fused,
        score_pixels,
        score_pixels_plain,
    )
    from wild_visual_navigation_tpu_torch.ops.resize import imagenet_normalize, resize_image
    from wild_visual_navigation_tpu_torch.runtime import load_sequence, run_replay
    from wild_visual_navigation_tpu_torch.runtime.fused import build_fused_stego_frame_fn
    from wild_visual_navigation_tpu_torch.runtime.replay import Sequence
    from wild_visual_navigation_tpu_torch.utils.confidence_generator import ConfidenceConfig, confidence_init

    out = {}
    # 1. K1 on strided views of ViT-B's qkv product (12 heads)
    for B, S in ((1, 3137), (4, 785)):
        buf = torch.randn(B, S, 3, 12, 64, device=dev, generator=g).to(torch.bfloat16)
        q, k, v = buf.permute(2, 0, 3, 1, 4).unbind(0)
        ref = xla_attention(q, k, v, 0.125).float()
        err, tol, tail = k1_bf16_check(flash_attention(q, k, v, 0.125), ref, q, k, v, xla_attention, bf16_atol)
        print(f"[stego K1] strided views of a ({B}, {S}, 3, 12, 64) bf16 qkv buffer (ViT-B/8): max abs err "
              f"{err:.3e} (tol {tol:.3e}; without the last kv tile the plain version errs by {tail:.3e})")
        require(err <= tol < tail, f"K1 on ViT-B's strided qkv views at B={B}, S={S}")

    # 2. K2 with the STEGO head [90 -> 256 -> 32 -> 91]
    head = get_model(STEGO_HEAD, device=dev, generator=torch.Generator().manual_seed(1)).eval().requires_grad_(False)
    for B in (1, 4):
        for hp, size in ((28, 224), (56, 448)):
            feat = torch.randn(B, 90, hp, hp, device=dev, generator=g)
            with torch.no_grad():
                ops = fused_precompute(head, feat, size, size)
                trav, reco = score_pixels(ops, 90)
                trav_p, reco_p = score_pixels_plain(ops, 90)
            terr = float((trav - trav_p).abs().max())
            rbound = float(((reco - reco_p).abs() - 1e-3 * reco_p.abs()).max())
            print(f"[stego K2] feat ({B}, 90, {hp}, {hp}) -> {size}x{size}, STEGO head: trav max abs err {terr:.3e} "
                  f"(tol 2e-3); reco max abs err {float((reco - reco_p).abs().max()):.3e} at max |reco| "
                  f"{float(reco_p.abs().max()):.3e} (tol rtol 1e-3 + atol 1e-4)")
            require(terr <= 2e-3 and rbound <= 1e-4, f"K2 with D = 90 at B={B}, {size}")
    with torch.no_grad():
        for hp, size in ((28, 224), (56, 448)):
            opss = [(fused_precompute(head, torch.randn(1, 90, hp, hp, device=dev, generator=g), size, size),)
                    for _ in range(WARMUP + N_TIMED)]
            k_ms = device_ms(lambda o: score_pixels(o, 90), opss)
            p_ms = device_ms(lambda o: score_pixels_plain(o, 90), opss)
            b2, _, k2_bytes = k2_bound(opss[0][0], size * size)
            print(f"[time] K2 pixelwise_score {size}x{size} from (1, 90, {hp}, {hp}), STEGO head: kernel "
                  f"{k_ms:.4f} ms, plain {p_ms:.4f} ms; bound {b2['bound_ms']:.6f} ms ({b2['bound_by']}: {k2_bytes} "
                  f"bytes), share of the bound {b2['bound_ms'] / k_ms:.3f} | {card}", flush=True)
            out[f"k2_d90_{size}"] = {"ms": k_ms, "plain_ms": p_ms, **b2}

    # 3. the fused STEGO frame at 448, per pixel and per segment
    si = StegoInterface(input_size=448, device=dev, seed=0)
    frames = {pp: build_fused_stego_frame_fn(si, head, ConfidenceConfig(std_factor=0.5), 448, prediction_per_pixel=pp)
              for pp in (True, False)}
    x0 = torch.from_numpy(demo[:1]).to(dev)
    with torch.no_grad():
        codes0 = si.head(si.vit(imagenet_normalize(resize_image(x0, 448, 448)))["patch_tokens"])["code"]
        _, reco0 = pixelwise_score_fused(head, codes0.reshape(1, 56, 56, 90).permute(0, 3, 1, 2), 448, 448)
    # confidence statistics at the scale of this head's reconstruction error
    cg = confidence_init(dev)._replace(mean=reco0.mean(), std=reco0.std())
    for pp, name in ((True, "per pixel"), (False, "per segment")):
        want = {"flash_attention": 12, "pixelwise_score": int(pp), "slic_step": 0, "fill_hulls": 0}
        torch.cuda.synchronize()
        port.reset_launch_counts()
        for i in range(5):
            before = port.launch_counts()
            res = frames[pp](cg, torch.from_numpy(demo[i : i + 1]).to(dev))
            delta = {k: v - before[k] for k, v in port.launch_counts().items()}
            require(delta == want, f"launches of a STEGO frame scored {name}: {delta}")
            for m in (res.traversability, res.confidence):
                require(tuple(m.shape) == (448, 448) and bool(torch.isfinite(m).all())
                        and float(m.min()) >= 0 and float(m.max()) <= 1, "STEGO maps finite, in [0, 1]")
            require(int(res.segments.min()) >= 0 and int(res.segments.max()) < 20, "STEGO segment ids in [0, 20)")
        print(f"[stego frame] 448, scored {name}: 5 demo frames, each launched {delta}; "
              f"{int(res.feat_valid.sum())} of 20 clusters non-empty in the last")

    # the same frame on the CPU through the plain versions, the same weights and initial indices
    si_cpu = StegoInterface(input_size=448, device="cpu", seed=0,
                            backbone_params={k: v.cpu() for k, v in si.vit.state_dict().items()},
                            head_params={k: v.cpu() for k, v in si.head.state_dict().items()})
    head_cpu = get_model(STEGO_HEAD)
    head_cpu.load_state_dict({k: v.cpu() for k, v in head.state_dict().items()})
    frames_cpu = {pp: build_fused_stego_frame_fn(si_cpu, head_cpu, ConfidenceConfig(std_factor=0.5), 448,
                                                 prediction_per_pixel=pp) for pp in (True, False)}
    cg_cpu = confidence_init()._replace(mean=reco0.mean().cpu(), std=reco0.std().cpu())
    x = torch.from_numpy(demo[10:11])
    t0 = time.perf_counter()
    with torch.no_grad():
        codes_cpu = si_cpu.head(si_cpu.vit(imagenet_normalize(resize_image(x, 448, 448)))["patch_tokens"])["code"]
        codes_card = si.head(si.vit(imagenet_normalize(resize_image(x.to(dev), 448, 448)))["patch_tokens"])["code"]
    cpu_s = time.perf_counter() - t0
    code_diff = float((codes_card.cpu() - codes_cpu).abs().max())
    for pp, name in ((True, "per pixel"), (False, "per segment")):
        got = frames[pp](cg, x.to(dev))
        ref = frames_cpu[pp].tail(cg_cpu, codes_cpu)  # the CPU frame: its own backbone's codes
        same = frames_cpu[pp].tail(cg_cpu, codes_card.cpu())  # the card's codes through the CPU tail
        for label, r, tol in (("the CPU frame", ref, STEGO_CPU_TOL), ("the card's codes on the CPU", same,
                                                                      STEGO_SAME_CODES_TOL)):
            agree = float((got.segments.cpu() == r.segments[0]).float().mean())
            t_mae = float((got.traversability.cpu() - r.traversability[0]).abs().mean())
            c_mae = float((got.confidence.cpu() - r.confidence[0]).abs().mean())
            both = (got.feat_valid.cpu() & r.feat_valid[0])
            f_diff = float((got.features.cpu() - r.features[0])[both].abs().max())
            print(f"[stego frame] 448 scored {name}, demo frame 10 against {label}: k-means label agreement "
                  f"{agree:.4f} (min {tol['agree']}), trav MAE {t_mae:.3e} (tol {tol['mae']:.0e}), conf MAE "
                  f"{c_mae:.3e} (tol {tol['mae']:.0e}), pooled code max abs diff {f_diff:.3e} (tol {tol['feat']})")
            require(agree >= tol["agree"] and t_mae <= tol["mae"] and c_mae <= tol["mae"] and f_diff <= tol["feat"],
                    f"the STEGO frame ({name}) agrees with {label}")
    print(f"[stego frame] the CPU backbone at 448 (bf16) and the card's: codes max abs diff {code_diff:.3e}; the CPU's "
          f"ViT-B/8 took {cpu_s:.1f} s", flush=True)
    del si_cpu, frames_cpu

    # 4. the Jackal runtime at 224: the recorded mission through run_replay
    sequence = load_sequence(str(seq_path))
    rt = make_jackal_runtime(dev)
    fe = rt.fe_params
    require((fe.feature_type, fe.segmentation_type, fe.network_input_image_height, fe.prediction_per_pixel)
            == ("stego", "stego", 224, True) and rt._fused_frame is not None, "the Jackal profile: fused stego at 224")
    t0 = time.perf_counter()
    rep, losses, counts = replay_runtime(rt, sequence)
    replay_s = time.perf_counter() - t0
    n = max(rep.frames_processed, 1)
    per = {k: counts[k] / n for k in ("flash_attention", "pixelwise_score", "slic_step")}
    k4 = counts["fill_hulls"] / max(rep.supervision_updates, 1)
    print(f"[stego runtime] Jackal profile (stego x stego, ViT-B/8 at 224, 20 clusters, per-pixel), run_replay of "
          f"{len(sequence.frames)} frames + {len(sequence.states)} robot states in {replay_s:.2f} s: "
          f"{rep.frames_processed} frames processed, {rep.frames_gated} gated, {rep.supervision_updates} supervision "
          f"updates, {rep.train_steps} train steps, {rep.valid_nodes} valid nodes; losses read back, first "
          f"{[round(x, 5) for x in losses[:3]]}, last {[round(x, 5) for x in losses[-3:]]}; launches {counts}: per "
          f"accepted frame K1 {per['flash_attention']:.2f}, K2 {per['pixelwise_score']:.2f}, K3 "
          f"{per['slic_step']:.2f}; per flush K4 {k4:.2f}", flush=True)
    require(rep.frames_processed == len(sequence.frames) and rep.frames_gated == 0, "every STEGO frame accepted")
    require(per == {"flash_attention": 12, "pixelwise_score": 1, "slic_step": 0} and k4 == 1,
            "K1 12, K2 1, K3 0 per accepted STEGO frame and K4 1 per flush")
    require(rep.supervision_updates > 0 and rep.train_steps > 0 and rep.valid_nodes >= 5, "the STEGO mission learns")
    require(all(np.isfinite(losses)), "finite losses")
    trav, conf = rep.last_result.to_numpy()
    require(trav.shape == (224, 224) and np.isfinite(trav).all() and np.isfinite(conf).all()
            and trav.min() >= 0 and trav.max() <= 1, "the last STEGO frame's maps finite, in [0, 1]")
    out["launches"] = counts

    # its first 20 frames (10 would train no step) on the card and on the CPU
    last = sequence.frames[19].stamp
    head20 = Sequence(frames=sequence.frames[:20], states=[s for s in sequence.states if s.stamp <= last])
    runs = {}
    for d in (dev, "cpu"):
        r = make_jackal_runtime(d, like=rt)
        step_losses = record_train_losses(r)
        t0 = time.perf_counter()
        rp = run_replay(r, head20)
        runs[str(d)] = (r, rp, [float(x) for x in step_losses], time.perf_counter() - t0)
    (r_k, rp_k, l_k, _), (r_c, rp_c, l_c, cpu_s) = runs[str(dev)], runs["cpu"]
    occupied = r_k.estimator.buffer.valid.cpu()
    m_k, m_c = r_k.estimator.buffer.supervision_mask.cpu()[occupied], r_c.estimator.buffer.supervision_mask[occupied]
    mask_differ = int((m_k != m_c).sum())
    loss_diff = max((abs(a - b) / abs(b) for a, b in zip(l_k, l_c)), default=float("nan"))
    same = all(getattr(rp_k, f) == getattr(rp_c, f) for f in
               ("frames_processed", "supervision_updates", "train_steps", "valid_nodes"))
    print(f"[stego runtime] the first 20 frames on the card and on the CPU ({cpu_s:.1f} s): counts equal {same} "
          f"({rp_c.frames_processed} frames, {rp_c.supervision_updates} updates, {rp_c.train_steps} steps, "
          f"{rp_c.valid_nodes} valid nodes); supervision masks differ in {mask_differ} of {m_k.numel()} pixels "
          f"(max {1e-4 * m_k.numel():.0f}); per-step losses card {[round(x, 5) for x in l_k]}, CPU "
          f"{[round(x, 5) for x in l_c]}, max relative difference {loss_diff:.3e} (tol {STEGO_LOSS_RTOL})", flush=True)
    require(same and rp_k.train_steps > 0 and len(l_k) == len(l_c) == rp_k.train_steps, "the same counts on the CPU")
    require(mask_differ <= 1e-4 * m_k.numel() and loss_diff <= STEGO_LOSS_RTOL,
            "masks and losses agree with the CPU replay")
    del runs, r_k, r_c

    # 5. latencies: the STEGO frame at 224 (the runtime's) and at 448, B=1
    frame224 = rt._fused_frame
    head224, cg224 = rt.inference_head
    for size, fn, c, hd in ((224, frame224, cg224, head224), (448, frames[True], cg, None)):
        ins = [(c, torch.from_numpy(demo[i % len(demo) : i % len(demo) + 1]).to(dev), hd)
               for i in range(WARMUP + N_TIMED)]
        lat = wall_ms(fn, ins)
        prof = profile_calls(fn, ins[:10])
        print(f"[time] STEGO frame B=1 at {size} (per pixel): {lat:.3f} ms on the host clock; under the profiler "
              f"{prof[0]:.3f} ms per frame, device kernels {prof[1]:.3f} ms, {prof[2]:.0f} launches per frame, busy "
              f"share {prof[3]:.3f} | {card}", flush=True)
    profile_frames(frames[True], cg, demo, dev, card, tag="stego profile 448")
    return out


FEATURE_TOL = {"sift": 1e-4, "histogram": 1e-5, "lk_px": 1e-3}  # card against CPU, the same plain functions
MODE_MAP_MAE = 1e-3  # the anomaly and graph frames against the CPU tail on the card's features
ANOMALY_LOSS_RTOL = 5e-2  # the anomaly runtime's per-step losses, card against CPU (bf16 backbones)


def features_phase(dev, card: str, size: int = 224) -> dict:
    """Dense SIFT, the colour histogram and pyramidal LK on the card against
    the same functions on the CPU, at `size` px; then the facade's sift and
    histogram modes with SLIC on the card (K3 11 launches per image). No
    kernel is their own: they are plain PyTorch on CUDA tensors. Returns the
    facade's launches."""
    import torch

    import wild_visual_navigation_tpu_torch as port
    from wild_visual_navigation_tpu_torch.feature_extractor.feature_extractor import FeatureExtractor
    from wild_visual_navigation_tpu_torch.feature_extractor.sift import dense_sift_features
    from wild_visual_navigation_tpu_torch.ops.histogram import dense_color_histogram
    from wild_visual_navigation_tpu_torch.ops.optical_flow import track_points

    rng = np.random.default_rng(8)
    img = rng.random((3, size // 8, size // 8), dtype=np.float32).repeat(8, 1).repeat(8, 2)
    x = torch.from_numpy(np.clip(img + 0.05 * rng.standard_normal(img.shape).astype(np.float32), 0, 1))
    xd = x.to(dev)
    for name, fn in (("sift", dense_sift_features), ("histogram", dense_color_histogram)):
        got, want = fn(xd), fn(x)
        err = float((got.cpu() - want).abs().max())
        lat = wall_ms(fn, [(xd,)] * (WARMUP + N_TIMED))
        print(f"[features] {name} (3, {size}, {size}) -> {tuple(got.shape)} on the card against the CPU: max abs err "
              f"{err:.3e} (tol {FEATURE_TOL[name]:.0e}); {lat:.3f} ms on the host clock | {card}")
        require(err <= FEATURE_TOL[name] and bool(torch.isfinite(got).all()), f"{name} on the card")
    nxt = torch.roll(x, (1, 2), dims=(1, 2))
    pts = torch.from_numpy(rng.uniform(20, size - 24, (256, 2)).astype(np.float32))
    p_card, v_card = track_points(xd, nxt.to(dev), pts.to(dev))
    p_cpu, v_cpu = track_points(x, nxt, pts)
    err = float((p_card.cpu() - p_cpu).abs().max())
    same_valid = bool(torch.equal(v_card.cpu(), v_cpu))
    lat = wall_ms(track_points, [(xd, nxt.to(dev), pts.to(dev))] * (WARMUP + N_TIMED))
    print(f"[features] LK track_points, 256 points over 3 levels on {size}x{size} (moved by (2, 1) px): positions max "
          f"abs err {err:.3e} px (tol {FEATURE_TOL['lk_px']:.0e}), validity equal {same_valid} ({int(v_cpu.sum())} valid), "
          f"median shift {p_card.cpu().sub(pts).median(0).values.tolist()}; {lat:.3f} ms on the host clock | {card}")
    require(err <= FEATURE_TOL["lk_px"] and same_valid and float(v_cpu.float().mean()) > 0.9, "LK on the card")
    counts = {}
    for ft, dim in (("sift", 384), ("histogram", 90)):
        fe = FeatureExtractor(segmentation_type="slic", feature_type=ft, input_size=size, device=dev)
        port.reset_launch_counts()
        ex = fe.extract(xd[None], return_dense_features=True)
        torch.cuda.synchronize()
        c = port.launch_counts()
        ref = fe.compute_features(x[None])
        d_err = float((ex.dense_features.cpu() - ref).abs().max())
        print(f"[features] facade {ft} x slic at {size} on the card: features {tuple(ex.features.shape)}, "
              f"{int(ex.center_valid.sum())} segments, launches {c}; dense features against the CPU max abs err "
              f"{d_err:.3e} (tol {FEATURE_TOL[ft]:.0e})")
        require(tuple(ex.features.shape) == (100, dim) and bool(torch.isfinite(ex.features).all())
                and d_err <= FEATURE_TOL[ft], f"the facade's {ft} mode")
        require(c == {"flash_attention": 0, "pixelwise_score": 0, "slic_step": 11, "fill_hulls": 0},
                f"the facade's {ft} x slic launches K3 11 times and nothing else")
        counts = {k: counts.get(k, 0) + v for k, v in c.items()}
    return counts


def anomaly_params():
    """The product's node settings (rates raised for a replay at virtual
    time) and the experiment's LinearRnvp defaults (input 384, topology
    [200], 2 flows, odds mask, permutations)."""
    from wild_visual_navigation_tpu_torch.cfg.experiment import ExperimentParams

    fe, ln = runtime_params()
    exp = ExperimentParams()
    exp.model.name = "LinearRnvp"
    return fe, ln, exp


def make_anomaly_runtime(dev, like=None):
    """WVNRuntime(anomaly_detection=True) at the product's settings (ViT-S/8
    at 224 seed 0, SLIC 100, per pixel, buffer 256, fan-out 32, batch 8)."""
    from wild_visual_navigation_tpu_torch.runtime import WVNRuntime

    fe, ln, exp = anomaly_params()
    backbone = None
    if like is not None:
        backbone = {k: v.cpu() for k, v in like.feature_extractor._extractor.vit.state_dict().items()}
    return WVNRuntime(fe_params=fe, ln_params=ln, exp_params=exp, seed=0, anomaly_detection=True,
                      buffer_capacity=256, reprojection_fanout=32, device=dev, backbone_params=backbone)


def modes_phase(dev, card: str, demo, seq_path: Path, size: int = 224) -> dict:
    """The anomaly (LinearRnvp) and graph (SimpleGCN) frames at full width,
    the anomaly runtime's replay of the mission on the card and the CPU, and
    the demo golden replay on the card. Returns each path's launches, the
    counts set to 0 just before it and read just after."""
    import torch

    import wild_visual_navigation_tpu_torch as port
    from wild_visual_navigation_tpu_torch.feature_extractor.dino import DinoInterface
    from wild_visual_navigation_tpu_torch.models.registry import apply_model, get_model
    from wild_visual_navigation_tpu_torch.models.vit import dense_features
    from wild_visual_navigation_tpu_torch.ops.pixelwise import pixelwise_map_rows_chunked
    from wild_visual_navigation_tpu_torch.ops.resize import imagenet_normalize, resize_image
    from wild_visual_navigation_tpu_torch.runtime import load_sequence, run_replay
    from wild_visual_navigation_tpu_torch.runtime.demo_golden import (
        OVERLAY_MAE_LIMIT,
        TRAV_MAE_LIMIT,
        replay_against_golden,
    )
    from wild_visual_navigation_tpu_torch.runtime.fused import _score_rows, build_fused_frame_fn
    from wild_visual_navigation_tpu_torch.runtime.replay import Sequence
    from wild_visual_navigation_tpu_torch.utils.confidence_generator import ConfidenceConfig, confidence_init

    out = {}
    _, _, exp = anomaly_params()
    heads = {"anomaly": {"name": "LinearRnvp", "linear_rnvp_cfg": {**exp.model.linear_rnvp_cfg.to_dict(),
                                                                    "input_size": 384}},
             "graph": {"name": "SimpleGCN", "simple_gcn_cfg": {**exp.model.simple_gcn_cfg.to_dict(),
                                                               "input_size": 384}}}
    dino = DinoInterface(input_size=size, device=dev, seed=0)
    cg_cfg = ConfidenceConfig(std_factor=0.5)
    x0 = torch.from_numpy(demo[10:11]).to(dev)
    with torch.no_grad():
        feat0 = dense_features(dino.vit, imagenet_normalize(resize_image(x0, size, size)))  # (1, 384, 28, 28) at 224
    # 1. the anomaly frame (per pixel, the chunked path) and the graph frame (per segment) at 224
    for kind, cfg in heads.items():
        anomaly = kind == "anomaly"
        head = get_model(cfg, device=dev, generator=torch.Generator().manual_seed(2)).eval().requires_grad_(False)
        frame = build_fused_frame_fn(dino.vit, head, cg_cfg, size, anomaly=anomaly)
        with torch.no_grad():
            if anomaly:  # confidence statistics at the scale of the flow's negative log-likelihood
                o = head(feat0[0].reshape(384, -1).T)
                score = -(o["logprob"].sum(-1) + o["log_det"])
            else:
                rows = feat0[0].reshape(384, -1).T
                score = ((apply_model(head, rows)[:, 1:] - rows) ** 2).mean(-1)
        cg = confidence_init(dev)._replace(mean=score.mean(), std=score.std())
        torch.cuda.synchronize()
        port.reset_launch_counts()
        per = []
        for i in range(10):
            before = port.launch_counts()
            res = frame(cg, torch.from_numpy(demo[i : i + 1]).to(dev))
            per.append({k: v - before[k] for k, v in port.launch_counts().items()})
        torch.cuda.synchronize()
        counts = port.launch_counts()
        require(all(p == {"flash_attention": 12, "pixelwise_score": 0, "slic_step": 11, "fill_hulls": 0} for p in per),
                f"the {kind} frame launches K1 12, K3 11, K2 0 per frame: {per}")
        if not anomaly:
            out["graph_launches"] = counts
        res = frame(cg, x0)
        head_cpu = get_model(cfg).eval().requires_grad_(False)
        head_cpu.load_state_dict({k: v.cpu() for k, v in head.state_dict().items()})
        tail = build_fused_frame_fn(dino.vit, head_cpu, cg_cfg, size, anomaly=anomaly).tail
        ref = tail(type(cg)(*(t.cpu() for t in cg)), feat0.cpu(), res.segments[None].cpu())
        t_mae = float((res.traversability.cpu() - ref.traversability[0]).abs().mean())
        c_mae = float((res.confidence.cpu() - ref.confidence[0]).abs().mean())
        finite = all(bool(torch.isfinite(m).all()) and float(m.min()) >= 0 and float(m.max()) <= 1
                     for m in (res.traversability, res.confidence))
        lat = wall_ms(frame, [(cg, torch.from_numpy(demo[i % 50 : i % 50 + 1]).to(dev)) for i in
                              range(WARMUP + N_TIMED)])
        prof = profile_calls(frame, [(cg, torch.from_numpy(demo[i : i + 1]).to(dev)) for i in range(10)])
        what = ("LinearRnvp [384, topology 200, 2 flows] per pixel in row bands" if anomaly
                else "SimpleGCN [384, 256, 128, 1+384] per segment over the SLIC adjacency")
        print(f"[{kind} frame] DINO ViT-S/8 at {size}, SLIC 100, {what}: launches per frame {per[0]} over 10 demo "
              f"frames; against the CPU tail on the card's features and segments: trav MAE {t_mae:.3e}, conf MAE "
              f"{c_mae:.3e} (tol {MODE_MAP_MAE:.0e}); maps finite in [0, 1]: {finite}; trav std "
              f"{float(res.traversability.std()):.3e}", flush=True)
        print(f"[time] {kind} frame B=1 at {size}: {lat:.3f} ms on the host clock; under the profiler {prof[0]:.3f} ms "
              f"per frame, device kernels {prof[1]:.3f} ms, {prof[2]:.0f} launches per frame, busy share "
              f"{prof[3]:.3f} | {card}", flush=True)
        require(t_mae <= MODE_MAP_MAE and c_mae <= MODE_MAP_MAE and finite, f"the {kind} frame against the CPU tail")
        if anomaly:
            # the scoring alone is host-bound too, so CUDA events around it would count the device's idle
            # gaps: its device time is the profiler's sum of its kernels
            chunked = profile_calls(lambda f: pixelwise_map_rows_chunked(
                lambda r: _score_rows(head, cg_cfg, cg, r, True), f, size, size), [(feat0,)] * 10)
            print(f"[time] the anomaly frame's chunked LinearRnvp scoring alone ({size * size} pixels in bands of 32 "
                  f"rows), under the profiler: {chunked[0]:.3f} ms per call, device kernels {chunked[1]:.3f} ms, "
                  f"{chunked[2]:.0f} launches, {chunked[1] / prof[1]:.3f} of the frame's device time and "
                  f"{chunked[2] / prof[2]:.3f} of its launches | {card}")
            profile_frames(frame, cg, demo, dev, card, tag="anomaly profile")

    # 2. the anomaly runtime: the recorded mission through run_replay on the card
    sequence = load_sequence(str(seq_path))
    rt = make_anomaly_runtime(dev)
    require(rt._fused_frame is not None and rt.anomaly_detection, "anomaly mode runs the fused DINO frame")
    t0 = time.perf_counter()
    rep, losses, counts = replay_runtime(rt, sequence)
    replay_s = time.perf_counter() - t0
    n = max(rep.frames_processed, 1)
    per = {k: counts[k] / n for k in ("flash_attention", "pixelwise_score", "slic_step")}
    k4 = counts["fill_hulls"] / max(rep.supervision_updates, 1)
    print(f"[anomaly runtime] WVNRuntime(anomaly_detection=True), run_replay of {len(sequence.frames)} frames + "
          f"{len(sequence.states)} robot states in {replay_s:.2f} s: {rep.frames_processed} frames processed, "
          f"{rep.supervision_updates} supervision updates, {rep.train_steps} train steps, {rep.valid_nodes} valid "
          f"nodes; losses read back, first {[round(x, 3) for x in losses[:3]]}, last "
          f"{[round(x, 3) for x in losses[-3:]]}; launches {counts}: per accepted frame K1 {per['flash_attention']:.2f}, K2 {per['pixelwise_score']:.2f}, "
          f"K3 {per['slic_step']:.2f}; per flush K4 {k4:.2f}", flush=True)
    require(rep.frames_processed == len(sequence.frames), "every anomaly frame accepted")
    require(per == {"flash_attention": 12, "pixelwise_score": 0, "slic_step": 11} and k4 == 1,
            "K1 12, K2 0, K3 11 per accepted anomaly frame and K4 1 per flush")
    require(rep.supervision_updates > 0 and rep.train_steps > 0 and rep.valid_nodes >= 5 and all(np.isfinite(losses)),
            "the anomaly mission learns with finite losses")
    trav, conf = rep.last_result.to_numpy()
    require(trav.shape == (size, size) and np.isfinite(trav).all() and trav.min() >= 0 and trav.max() <= 1
            and (conf == 1).all(), "the last anomaly frame's maps")
    out["anomaly_launches"] = counts

    # its first 20 frames on the card and on the CPU
    last = sequence.frames[19].stamp
    head20 = Sequence(frames=sequence.frames[:20], states=[s for s in sequence.states if s.stamp <= last])
    runs = {}
    for d in (dev, "cpu"):
        r = make_anomaly_runtime(d, like=rt)
        step_losses = record_train_losses(r)
        t0 = time.perf_counter()
        rp = run_replay(r, head20)
        runs[str(d)] = (r, rp, [float(x) for x in step_losses], time.perf_counter() - t0)
    (r_k, rp_k, l_k, _), (r_c, rp_c, l_c, cpu_s) = runs[str(dev)], runs["cpu"]
    occupied = r_k.estimator.buffer.valid.cpu()
    m_k, m_c = r_k.estimator.buffer.supervision_mask.cpu()[occupied], r_c.estimator.buffer.supervision_mask[occupied]
    mask_differ = int((m_k != m_c).sum())
    loss_diff = max((abs(a - b) / abs(b) for a, b in zip(l_k, l_c)), default=float("nan"))
    same = all(getattr(rp_k, f) == getattr(rp_c, f) for f in
               ("frames_processed", "supervision_updates", "train_steps", "valid_nodes"))
    print(f"[anomaly runtime] the first 20 frames on the card and on the CPU ({cpu_s:.1f} s): counts equal {same} "
          f"({rp_c.frames_processed} frames, {rp_c.supervision_updates} updates, {rp_c.train_steps} steps, "
          f"{rp_c.valid_nodes} valid nodes); supervision masks differ in {mask_differ} of {m_k.numel()} pixels "
          f"(max {1e-4 * m_k.numel():.0f}); per-step losses card {[round(x, 3) for x in l_k]}, CPU "
          f"{[round(x, 3) for x in l_c]}, max relative difference {loss_diff:.3e} (tol {ANOMALY_LOSS_RTOL})",
          flush=True)
    require(same and rp_k.train_steps > 0 and len(l_k) == len(l_c) == rp_k.train_steps, "the same counts on the CPU")
    require(mask_differ <= 1e-4 * m_k.numel() and loss_diff <= ANOMALY_LOSS_RTOL,
            "masks and losses agree with the CPU replay")
    del runs, r_k, r_c, rt

    # 3. the demo golden replay (sift on a 64-px grid) on the card against the committed golden
    torch.cuda.synchronize()
    port.reset_launch_counts()
    t0 = time.perf_counter()
    g = replay_against_golden(dev)
    torch.cuda.synchronize()
    counts = port.launch_counts()
    print(f"[golden] demo mission replay (sift x grid at 64 px, [64, 32, 1] head from the committed initial head, "
          f"sampling seed 7) on the card in {time.perf_counter() - t0:.2f} s: train steps {g['train_steps']} (golden "
          f"{g['golden_train_steps']}, within {g['steps_limit']}), valid nodes {g['valid_nodes']} (golden "
          f"{g['golden_valid_nodes']}), {g['flushes']} flushes; traversability MAE {g['trav_mae']:.4e} (limit "
          f"{TRAV_MAE_LIMIT}), overlay MAE {g['overlay_mae']:.4f} (limit {OVERLAY_MAE_LIMIT}, uint8); launches "
          f"{counts}", flush=True)
    require(g["ok"], "the golden replay meets the golden's limits")
    require(counts["fill_hulls"] == g["flushes"] > 0, "K4 once per flush in the golden replay")
    out["golden_launches"] = counts
    return out


# the torchvision path and the grid map: ResNet-18 / ResNet-50 / EfficientNet-B4 pyramids in bf16 against fp32 (TF32
# off on both sides), each level's error relative to its largest |value| (the CPU's first reading at 128 px:
# 4.7e-3 to 1.25e-2; some 8 bf16 units)
PYRAMID_BF16_REL = 3e-2
TV_TAIL_MAE = 1e-5  # the torchvision frame against its CPU tail on the card's pyramid and segments
TV_LOSS_RTOL = 5e-2  # the torchvision runtime's per-step losses, card against CPU (bf16 backbones)
TV_BATCH_ATOL = 2e-2  # image_batch_callback against single callbacks (cuDNN may pick other algorithms at B=4)
GRID_TRAV_MAE = 2e-2  # the card's grid map against the CPU's, over the cells valid on both
GRID_VALID_SHARE = 1e-2  # cells valid on one side only, as a share of those valid on either
TV_MODELS = ("resnet18", "resnet50", "efficientnet_b4")


def make_tv_runtime(dev, gridmap_size: int = 128, like=None):
    """WVNRuntime in torchvision x slic mode at the product's settings
    (ResNet-18, SLIC 100 at 224, buffer 256, fan-out 32, backbone seed 0,
    rates raised for a replay at virtual time) with a 128 x 0.15 m grid map;
    `like` hands over another such runtime's ResNet-18 weights."""
    from wild_visual_navigation_tpu_torch.runtime import WVNRuntime

    import dataclasses

    fe, ln = runtime_params()
    fe = dataclasses.replace(fe, feature_type="torchvision")
    backbone = None
    if like is not None:
        backbone = {k: v.cpu() for k, v in like.feature_extractor._extractor.params.items()}
    return WVNRuntime(fe_params=fe, ln_params=ln, seed=0, buffer_capacity=256, reprojection_fanout=32, device=dev,
                      gridmap_size=gridmap_size, gridmap_resolution=0.15, backbone_params=backbone)


def with_carrots(rt, every: int = 2) -> list:
    """Ask for a carrot after every `every`-th accepted frame, at the robot's
    yaw, as a planner polling the grid map would; returns the goals."""
    goals, callback, accepted = [], rt.image_callback, [0]

    def image_callback(img, stamp, camera, K, h, w, pose_base, pose_cam, *rest):
        res = callback(img, stamp, camera, K, h, w, pose_base, pose_cam, *rest)
        if res is not None:
            accepted[0] += 1
            if accepted[0] % every == 0:
                goals.append(rt.get_carrot(yaw=float(np.arctan2(pose_base[1][0], pose_base[0][0])))[0])
        return res

    rt.image_callback = image_callback
    return goals


def grid_against(a, b) -> tuple[int, int, float]:
    """(cells valid on one side only, cells valid on either, trav MAE over
    the cells valid on both) of two grid maps with the same origin."""
    require(np.array_equal(a.origin_xy, b.origin_xy), "the grid maps share their origin")
    va, vb = a.valid.cpu().numpy(), b.valid.cpu().numpy()
    ta, tb = a.traversability.cpu().numpy(), b.traversability.cpu().numpy()
    both = va & vb
    return int((va != vb).sum()), int((va | vb).sum()), float(np.abs(ta - tb)[both].mean()) if both.any() else 0.0


def seeded_head(D: int, dev, feats):
    """A seeded SimpleMLP [D -> 256 -> 32 -> 1+D] (the runtime's head shape)
    with confidence statistics at the scale of its reconstruction error on
    `feats` (S, D)."""
    import torch

    from wild_visual_navigation_tpu_torch.models.registry import apply_model, get_model
    from wild_visual_navigation_tpu_torch.utils.confidence_generator import confidence_init

    cfg = {"name": "SimpleMLP", "simple_mlp_cfg": {"input_size": D, "hidden_sizes": [256, 32, 1],
                                                   "reconstruction": True}}
    head = get_model(cfg, device=dev, generator=torch.Generator().manual_seed(3)).eval().requires_grad_(False)
    with torch.no_grad():
        reco = ((apply_model(head, feats)[:, 1:] - feats) ** 2).mean(-1)
    return cfg, head, confidence_init(dev)._replace(mean=reco.mean(), std=reco.std())


def torchvision_phase(dev, card: str, demo, seq_path: Path) -> dict:
    """The torchvision path and the grid map with the smart carrot (ROADMAP.md
    items 21 and 24): the three pyramids at 448, bf16 against fp32; the facade and
    the fused torchvision frame at 448 (B=1 and B=4) for each, K3 11 launches
    a call, the tail against the CPU; the torchvision runtime with its grid
    map replaying the mission (carrots every second frame) and its first 20
    frames on the CPU; image_batch_callback B=4; the closed-loop obstacle
    scenario; and the timings. Returns the runtime replay's and the closed
    loop's launches, the counts set to 0 just before each and read just after."""
    import torch

    import wild_visual_navigation_tpu_torch as port
    from wild_visual_navigation_tpu_torch.feature_extractor.feature_extractor import FeatureExtractor
    from wild_visual_navigation_tpu_torch.feature_extractor.torchvision_interface import TorchVisionInterface
    from wild_visual_navigation_tpu_torch.models.registry import get_model
    from wild_visual_navigation_tpu_torch.ops.resize import imagenet_normalize, resize_image
    from wild_visual_navigation_tpu_torch.ops.slic import slic_batch
    from wild_visual_navigation_tpu_torch.runtime import load_sequence, run_replay
    from wild_visual_navigation_tpu_torch.runtime.fused import build_fused_torchvision_frame_fn
    from wild_visual_navigation_tpu_torch.runtime.obstacle_scenario import build_runtime, run_obstacle_scenario
    from wild_visual_navigation_tpu_torch.runtime.replay import Sequence
    from wild_visual_navigation_tpu_torch.utils.confidence_generator import ConfidenceConfig

    out = {}
    cg_cfg = ConfidenceConfig(std_factor=0.5)
    k3_only = {"flash_attention": 0, "pixelwise_score": 0, "slic_step": 11, "fill_hulls": 0}
    img448 = torch.from_numpy(np.repeat(np.repeat(demo[20:21], 7, 2), 7, 3)).to(dev)  # 64 -> 448

    # 1. each pyramid at 448: bf16 against fp32, the facade and the fused frame, the tail against the CPU
    for mt in TV_MODELS:
        fp32 = TorchVisionInterface(mt, device=dev, dtype=torch.float32, seed=0)
        bf16 = TorchVisionInterface(mt, device=dev, params=fp32.params)  # bf16, the path's type
        x = torch.rand((WARMUP + N_TIMED, 1, 3, 448, 448), device=dev)
        with torch.no_grad():
            lv32, lv16 = fp32.inference(x[0]), bf16.inference(x[0])
        errs = {k: float((lv16[k] - lv32[k]).abs().max() / lv32[k].abs().max()) for k in lv32}
        finite = all(bool(torch.isfinite(v).all()) for v in lv16.values())
        shapes = {k: tuple(v.shape[1:]) for k, v in lv16.items()}
        xs = [(imagenet_normalize(x[i]),) for i in range(len(x))]
        with torch.no_grad():
            ms16 = device_ms(bf16.model, xs)
            ms32 = device_ms(fp32.model, xs)
            # hundreds of launches outlast the sleep kernel ahead of each run, so the events also count the host's
            # enqueue: the profiler's sum of kernels is the device time
            prof16 = profile_calls(bf16.model, xs[:5])
        print(f"[torchvision] {mt} at 448 ({sum(p.numel() for p in fp32.model.parameters()) / 1e6:.1f} M weights, "
              f"levels {shapes}, {bf16.feature_dim}-d pyramid): bf16 against fp32 (TF32 off), max abs error over each "
              f"level's largest |value|: {', '.join(f'{k} {v:.2e}' for k, v in errs.items())} (tol "
              f"{PYRAMID_BF16_REL:.0e}); finite {finite}", flush=True)
        print(f"[time] {mt} pyramid at 448, B=1, CUDA events: bf16 {ms16:.4f} ms, fp32 {ms32:.4f} ms; bf16 under the "
              f"profiler: device kernels {prof16[1]:.4f} ms, {prof16[2]:.0f} launches per call | {card}", flush=True)
        require(finite and all(e <= PYRAMID_BF16_REL for e in errs.values()), f"{mt}: bf16 against fp32")
        del fp32, lv32, x, xs

        fe = FeatureExtractor(seed=0, segmentation_type="slic", feature_type="torchvision", input_size=448,
                              device=dev, model_type=mt, backbone_params=bf16.params)
        torch.cuda.synchronize()
        port.reset_launch_counts()
        ex = fe.extract(img448)
        torch.cuda.synchronize()
        counts_fe = port.launch_counts()
        require(counts_fe == k3_only, f"{mt}: the facade's torchvision x slic launches K3 11 times: {counts_fe}")
        require(tuple(ex.features.shape) == (100, bf16.feature_dim) and bool(torch.isfinite(ex.features).all()),
                f"{mt}: the facade's pooled features")
        cfg, head, cg = seeded_head(bf16.feature_dim, dev, ex.features)
        frame = build_fused_torchvision_frame_fn(bf16, head, cg_cfg, 448)
        launches = {}
        for B in (1, 4):
            imgs = torch.from_numpy(np.repeat(np.repeat(demo[20:20 + B], 7, 2), 7, 3)).to(dev)
            torch.cuda.synchronize()
            port.reset_launch_counts()
            res = frame.frames_batch(cg, imgs)
            torch.cuda.synchronize()
            launches[B] = port.launch_counts()
            require(launches[B] == k3_only, f"{mt}: the fused frame at B={B} launches K3 11 times: {launches[B]}")
            require(tuple(res.traversability.shape) == (B, 448, 448) and all(
                bool(torch.isfinite(m).all()) and float(m.min()) >= 0 and float(m.max()) <= 1
                for m in (res.traversability, res.confidence)), f"{mt}: the fused frame's maps at B={B}")
        with torch.no_grad():
            x = resize_image(imgs.float() / 255.0 if imgs.dtype == torch.uint8 else imgs, 448, 448)
            pyr, segs = bf16.model(imagenet_normalize(x)), slic_batch(x)
        card_tail = frame.tail(cg, pyr, segs)
        head_cpu = get_model(cfg).eval().requires_grad_(False)
        head_cpu.load_state_dict({k: v.cpu() for k, v in head.state_dict().items()})
        cpu_tail = build_fused_torchvision_frame_fn(bf16, head_cpu, cg_cfg, 448).tail(
            type(cg)(*(t.cpu() for t in cg)), {k: v.cpu() for k, v in pyr.items()}, segs.cpu())
        t_mae = float((card_tail.traversability.cpu() - cpu_tail.traversability).abs().mean())
        c_mae = float((card_tail.confidence.cpu() - cpu_tail.confidence).abs().mean())
        f_diff = float((card_tail.features.cpu() - cpu_tail.features).abs().max())
        print(f"[torchvision] {mt} at 448: the facade (torchvision x slic) launched {counts_fe}; the fused frame at "
              f"B=1 launched {launches[1]}, at B=4 {launches[4]}; B=4 tail against the CPU tail on the card's pyramid "
              f"and segments: trav MAE {t_mae:.3e}, conf MAE {c_mae:.3e} (tol {TV_TAIL_MAE:.0e}), pooled features max "
              f"abs diff {f_diff:.3e}", flush=True)
        require(t_mae <= TV_TAIL_MAE and c_mae <= TV_TAIL_MAE, f"{mt}: the fused frame's tail against the CPU")
        del fe, bf16, frame, pyr, card_tail, cpu_tail

    # 2. the torchvision runtime with its grid map replaying the mission, a carrot every second frame
    sequence = load_sequence(str(seq_path))
    rt = make_tv_runtime(dev)
    require(rt._fused_frame is not None and rt._D == 960 and rt.gridmap is not None,
            "the torchvision runtime fuses its frame and keeps a grid map")
    goals = with_carrots(rt)
    t0 = time.perf_counter()
    rep, losses, counts = replay_runtime(rt, sequence)
    replay_s = time.perf_counter() - t0
    n = max(rep.frames_processed, 1)
    per = {k: counts[k] / n for k in ("flash_attention", "pixelwise_score", "slic_step")}
    k4 = counts["fill_hulls"] / max(rep.supervision_updates, 1)
    chosen = [g for g in goals if g is not None]
    valid_cells = int(rt.gridmap.valid.sum())
    print(f"[torchvision runtime] WVNRuntime torchvision x slic (ResNet-18 at 224, SLIC 100, head [960, 256, 32, "
          f"1+960], grid map 128 x 0.15 m), run_replay of {len(sequence.frames)} frames + {len(sequence.states)} robot "
          f"states in {replay_s:.2f} s: {rep.frames_processed} frames processed, {rep.supervision_updates} supervision "
          f"updates, {rep.train_steps} train steps, {rep.valid_nodes} valid nodes; losses read back, first "
          f"{[round(x, 5) for x in losses[:3]]}, last {[round(x, 5) for x in losses[-3:]]}; launches {counts}: per "
          f"accepted frame K1 {per['flash_attention']:.2f}, K2 {per['pixelwise_score']:.2f}, K3 {per['slic_step']:.2f};"
          f" per flush K4 {k4:.2f}; grid map {valid_cells} valid cells, origin {rt.gridmap.origin_xy.tolist()}; "
          f"{len(goals)} carrots asked, {len(chosen)} chosen, last {goals[-1] if goals else None}", flush=True)
    require(rep.frames_processed == len(sequence.frames), "every torchvision frame accepted")
    require(per == {"flash_attention": 0, "pixelwise_score": 0, "slic_step": 11} and k4 == 1,
            "K1 0, K2 0, K3 11 per accepted torchvision frame and K4 1 per flush")
    require(rep.supervision_updates > 0 and rep.train_steps > 0 and rep.valid_nodes >= 5 and len(losses) > 0
            and all(np.isfinite(losses)), "the torchvision mission learns with finite losses")
    require(valid_cells > 100 and len(goals) == len(sequence.frames) // 2 and len(chosen) > 0,
            "the grid map fills and yields carrots")
    trav, conf = rep.last_result.to_numpy()
    require(trav.shape == (224, 224) and np.isfinite(trav).all() and np.isfinite(conf).all()
            and trav.min() >= 0 and trav.max() <= 1, "the last torchvision frame's maps")
    out["torchvision_launches"] = counts

    # its first 20 frames on the card and on the CPU
    last = sequence.frames[19].stamp
    head20 = Sequence(frames=sequence.frames[:20], states=[s for s in sequence.states if s.stamp <= last])
    runs = {}
    for d in (dev, "cpu"):
        r = make_tv_runtime(d, like=rt)
        step_losses = record_train_losses(r)
        t0 = time.perf_counter()
        rp = run_replay(r, head20)
        runs[str(d)] = (r, rp, [float(x) for x in step_losses], time.perf_counter() - t0)
    (r_k, rp_k, l_k, _), (r_c, rp_c, l_c, cpu_s) = runs[str(dev)], runs["cpu"]
    occupied = r_k.estimator.buffer.valid.cpu()
    m_k, m_c = r_k.estimator.buffer.supervision_mask.cpu()[occupied], r_c.estimator.buffer.supervision_mask[occupied]
    mask_differ = int((m_k != m_c).sum())
    loss_diff = max((abs(a - b) / abs(b) for a, b in zip(l_k, l_c)), default=float("nan"))
    same = all(getattr(rp_k, f) == getattr(rp_c, f) for f in
               ("frames_processed", "supervision_updates", "train_steps", "valid_nodes"))
    one_side, either, g_mae = grid_against(r_k.gridmap, r_c.gridmap)
    print(f"[torchvision runtime] the first 20 frames on the card and on the CPU ({cpu_s:.1f} s): counts equal {same} "
          f"({rp_c.frames_processed} frames, {rp_c.supervision_updates} updates, {rp_c.train_steps} steps, "
          f"{rp_c.valid_nodes} valid nodes); supervision masks differ in {mask_differ} of {m_k.numel()} pixels (must "
          f"be 0); per-step losses max relative difference {loss_diff:.3e} (tol {TV_LOSS_RTOL}); grid maps: "
          f"{one_side} of {either} cells valid on one side only (tol {GRID_VALID_SHARE:.0%}), trav MAE over the "
          f"cells valid on both {g_mae:.3e} (tol {GRID_TRAV_MAE:.0e})", flush=True)
    require(same and rp_k.train_steps > 0 and len(l_k) == len(l_c) == rp_k.train_steps, "the same counts on the CPU")
    require(mask_differ == 0 and loss_diff <= TV_LOSS_RTOL, "masks and losses agree with the CPU replay")
    require(one_side <= GRID_VALID_SHARE * either and g_mae <= GRID_TRAV_MAE, "the grid map agrees with the CPU's")
    del runs, r_k, r_c

    # 3. image_batch_callback at B=4 against four image_callbacks, grid maps included
    seq = dict(np.load(seq_path))
    rt_b, rt_s = make_tv_runtime(dev, like=rt), make_tv_runtime(dev, like=rt)
    idx = np.arange(4)
    port.reset_launch_counts()
    batch = rt_b.image_batch_callback(seq["frame_images"][idx], seq["frame_stamps"][idx], ["front"] * 4,
                                      seq["frame_K"][idx], 64, 64, seq["frame_pose"][idx], seq["frame_cam_in_base"][idx])
    torch.cuda.synchronize()
    batch_counts = port.launch_counts()
    singles = [rt_s.image_callback(seq["frame_images"][i], float(seq["frame_stamps"][i]), "front", seq["frame_K"][i],
                                   64, 64, seq["frame_pose"][i], seq["frame_cam_in_base"][i]) for i in idx]
    t_diff = max(float((b.traversability - s.traversability).abs().max()) for b, s in zip(batch, singles))
    c_diff = max(float((b.confidence - s.confidence).abs().max()) for b, s in zip(batch, singles))
    one_side_b, either_b, g_mae_b = grid_against(rt_b.gridmap, rt_s.gridmap)
    print(f"[torchvision runtime] image_batch_callback B=4 against 4 image_callbacks: trav max abs diff {t_diff:.3e}, "
          f"conf {c_diff:.3e} (tol {TV_BATCH_ATOL:.0e}); grid maps {one_side_b} of {either_b} cells valid on one side "
          f"only, trav MAE {g_mae_b:.3e}; the batch launched {batch_counts}", flush=True)
    require(batch_counts == k3_only and t_diff <= TV_BATCH_ATOL and c_diff <= TV_BATCH_ATOL
            and one_side_b <= GRID_VALID_SHARE * either_b and g_mae_b <= GRID_TRAV_MAE,
            "the batched torchvision callback agrees with single callbacks")
    del rt_b, rt_s

    # 4. the closed-loop obstacle scenario (the JAX package's closed-loop test, sift x grid at 64 px)
    torch.cuda.synchronize()
    port.reset_launch_counts()
    t0 = time.perf_counter()
    sc = run_obstacle_scenario(build_runtime(dev))
    torch.cuda.synchronize()
    loop_counts = port.launch_counts()
    print(f"[closed loop] obstacle scenario on the card in {time.perf_counter() - t0:.2f} s: crossed at x = "
          f"{sc['crossed_x']:.3f} m (min 3.2) after {sc['train_steps']} train steps (min 101), least supervision signal "
          f"{sc['min_signal']:.3f} (max 0.4); rebuilt grid map: obstacle cell {sc['obstacle_trav']:.3f}, clean cell "
          f"{sc['clean_trav']:.3f} (at least 0.15 apart); carrot {sc['carrot']}; closed loop {sc['loop_ticks']} ticks, "
          f"{sc['loop_goals']} carrots chosen; checks {sc['checks']}; launches {loop_counts}", flush=True)
    require(all(sc["checks"].values()), f"the closed-loop scenario's checks: {sc['checks']}")
    require(loop_counts["fill_hulls"] > 0 and loop_counts["flash_attention"] == loop_counts["pixelwise_score"]
            == loop_counts["slic_step"] == 0, "the closed loop launched K4 (sift x grid: no K1-K3)")
    out["closed_loop_launches"] = loop_counts

    # 5. timings: the frame, frames_batch, image_callback with and without the grid map, the grid-map update, get_carrot
    frame = rt._fused_frame
    head, cg = rt.inference_head
    frames_1 = [(cg, torch.from_numpy(demo[i % 50 : i % 50 + 1]).to(dev), head) for i in range(WARMUP + N_TIMED)]
    lat1 = wall_ms(frame, frames_1)
    prof = profile_calls(frame, frames_1[:10])
    batches = [(cg, torch.from_numpy(demo[np.arange(i, i + 4) % 50]).to(dev), head) for i in range(WARMUP + N_TIMED)]
    lat4 = wall_ms(frame.frames_batch, batches)
    print(f"[time] torchvision frame B=1 (64x64 demo frame -> 224, ResNet-18, SLIC 100, per segment): {lat1:.3f} ms on "
          f"the host clock; under the profiler {prof[0]:.3f} ms per frame, device kernels {prof[1]:.3f} ms, "
          f"{prof[2]:.0f} launches per frame, busy share {prof[3]:.3f} | {card}", flush=True)
    print(f"[time] torchvision frames_batch B=4: {lat4:.3f} ms ({lat4 / 4:.3f} ms per frame) | {card}", flush=True)
    profile_frames(lambda c, x: frame(c, x, head), cg, demo, dev, card, tag="torchvision profile")

    rt_g, rt_n = make_tv_runtime(dev, like=rt), make_tv_runtime(dev, gridmap_size=0, like=rt)
    times = {"grid": [], "none": []}
    for i in range(WARMUP + N_TIMED):
        for name, r in (("none", rt_n), ("grid", rt_g)) if i % 2 else (("grid", rt_g), ("none", rt_n)):
            j = i % 50
            t0 = time.perf_counter()
            r.image_callback(seq["frame_images"][j], 100.0 + i, "front", seq["frame_K"][j], 64, 64,
                             seq["frame_pose"][j], seq["frame_cam_in_base"][j])
            torch.cuda.synchronize()
            if i >= WARMUP:
                times[name].append((time.perf_counter() - t0) * 1e3)
    res_g = rt_g.image_callback(seq["frame_images"][0], 1000.0, "front", seq["frame_K"][0], 64, 64,
                                seq["frame_pose"][0], seq["frame_cam_in_base"][0])
    K0 = rt_g._scale_K(seq["frame_K"][0], 64, 64)
    upd = [(res_g.traversability, res_g.confidence, K0, seq["frame_pose"][j] @ seq["frame_cam_in_base"][j],
            seq["frame_pose"][j]) for j in range(WARMUP + N_TIMED)]
    lat_upd = wall_ms(rt_g._update_gridmap, upd)
    lat_carrot = wall_ms(rt_g.get_carrot, [(0.1 * i,) for i in range(WARMUP + N_TIMED)])
    prof_carrot = profile_calls(rt_g.get_carrot, [(0.0,)] * 5)
    print(f"[time] torchvision image_callback B=1, interleaved over {N_TIMED} calls each: with the grid map "
          f"{statistics.median(times['grid']):.3f} ms, without {statistics.median(times['none']):.3f} ms (medians) | "
          f"{card}", flush=True)
    print(f"[time] grid-map update alone (recentre + project 224x224 at stride 2 into 128x128): {lat_upd:.3f} ms on "
          f"the host clock | {card}", flush=True)
    print(f"[time] get_carrot (SDF, 2 x 64 relaxations on 128x128, one copy to the host, select_carrot): "
          f"{lat_carrot:.3f} ms on the host clock; under the profiler {prof_carrot[1]:.3f} ms of device kernels, "
          f"{prof_carrot[2]:.0f} launches per call | {card}", flush=True)
    return out


# generate_dataset at 448 with fp32 backbones, the card against the CPU on the same weights: SLIC labels are held
# to SLIC_448_MIN, the STEGO majority labels and the per-segment features' MAE to these (the card's first reading,
# NVIDIA H100 80GB HBM3: label agreement 1.0, feature MAE 1.1e-7)
GEN_CPU_TOL = {"labels": 0.95, "feat_mae": 1e-5}
K448 = np.array([[268.8, 0, 224], [0, 268.8, 224], [0, 0, 1]])  # the demo camera scaled 64 -> 448


def offline_phase(dev, card: str, g, demo) -> dict:
    """The offline tools through their entry points on the card: dataset
    generation at the tool's defaults (448 px, DINOv2 ViT-S/14 x SLIC 100,
    STEGO labels) on 8 demo frames, its first 2 frames again on the card and
    on the CPU with fp32 backbones; the ablation sweep (slic:sift, grid:dinov2)
    and slic:sift again on the CPU; the parameter search's population of 64
    against OfflineTrainer; the soak at 448 on 2 cameras with its gates. Then
    K1, K2, K3 and K4 against their plain versions at the shapes these tools
    give them, timed. Returns the kernels' launches over the tools' runs
    (the comparisons excluded) and the new shapes' times."""
    import tempfile

    import torch

    import wild_visual_navigation_tpu_torch as port
    from wild_visual_navigation_tpu_torch.models.registry import get_model
    from wild_visual_navigation_tpu_torch.offline import OfflineTrainer, OfflineTrainerConfig
    from wild_visual_navigation_tpu_torch.ops.flash_attention import bf16_atol, flash_attention, xla_attention
    from wild_visual_navigation_tpu_torch.ops.pixelwise_fused import fused_precompute, score_pixels, score_pixels_plain
    from wild_visual_navigation_tpu_torch.ops.rasterize import convex_hull
    from wild_visual_navigation_tpu_torch.ops.rasterize_fill import fill_hulls, fill_hulls_plain, hull_fill
    from wild_visual_navigation_tpu_torch.ops.resize import resize_image
    from wild_visual_navigation_tpu_torch.ops.slic import _init_index, pixel_features, rgb_to_lab, slic_geometry
    from wild_visual_navigation_tpu_torch.ops.slic_fused import (
        SlicScratch,
        cluster_slots,
        slic_step,
        slic_step_plain,
        step_layout,
    )
    from wild_visual_navigation_tpu_torch.tools import ablation_sweep, param_search, soak
    from wild_visual_navigation_tpu_torch.tools import generate_dataset as gen

    out = {}
    tmp = tempfile.TemporaryDirectory(prefix="wvn_offline")
    torch.cuda.synchronize()
    port.reset_launch_counts()

    # 1. dataset generation at the tool's defaults on the first 8 demo frames, upscaled to 448
    images = [x.numpy() for x in resize_image(torch.from_numpy(demo[:8]), 448, 448)]
    names = [f"demo_mission_frame_{i:02d}" for i in range(8)]
    fe, st = gen.build_extractors(device=dev)
    before = port.launch_counts()
    t0 = time.perf_counter()
    meta = gen.generate(images, names, fe, st, tmp.name, "demo448")
    first_s = time.perf_counter() - t0
    delta = {k: v - before[k] for k, v in port.launch_counts().items()}
    t0 = time.perf_counter()
    gen.generate(images, names, fe, st, tmp.name, "demo448_again")  # the same frames with every path warm
    gen_s = time.perf_counter() - t0
    recs = [np.load(Path(tmp.name) / "demo448" / f"graph_{i:04d}.npz") for i in range(8)]
    shapes = {"feat": (100, 384), "seg": (448, 448), "edges": (2, 1024), "edge_valid": (1024,), "centers": (100, 2),
              "center_valid": (100,), "label": (100,), "flow_next": (100, 2), "flow_good": (100,), "source": ()}
    bad = [(i, k) for i, r in enumerate(recs) for k, s in shapes.items() if k not in r.files or r[k].shape != s]
    labelled = sum(int((r["label"] >= 0).sum()) for r in recs)
    finite = all(np.isfinite(r["feat"]).all() and np.isfinite(r["flow_next"]).all() for r in recs)
    print(f"[offline] generate_dataset, 8 demo frames at 448 (dinov2 x slic 100, stego labels, bf16): {meta['images']} "
          f"records, splits {meta['splits']}, {labelled} of 800 segments labelled; launches {delta} (K1 12 per "
          f"extraction and 12 per STEGO inference, K3 11 per frame); on the host clock, records written, "
          f"{gen_s * 1e3 / 8:.1f} ms per frame warm, {first_s * 1e3 / 8:.1f} ms in the first call | {card}", flush=True)
    require(meta["images"] == 8 and not bad and finite, f"8 records with the JAX record's keys and shapes ({bad})")
    require(delta == {"flash_attention": 8 * 24, "pixelwise_score": 0, "slic_step": 8 * 11, "fill_hulls": 0},
            f"generate_dataset's launches {delta}")

    fe32, st32 = gen.build_extractors(device=dev, dtype=torch.float32)

    def cpu_state(m):
        return {k: v.cpu() for k, v in m.state_dict().items()}

    fe32_cpu, st32_cpu = gen.build_extractors(device="cpu", dtype=torch.float32,
                                              backbone_params=cpu_state(fe32._extractor.vit),
                                              stego_backbone_params=cpu_state(st32.vit),
                                              stego_head_params=cpu_state(st32.head))
    pair = {}
    for name, (f, s) in (("card", (fe32, st32)), ("cpu", (fe32_cpu, st32_cpu))):
        t0 = time.perf_counter()
        gen.generate(images[:2], names[:2], f, s, tmp.name, f"fp32_{name}")
        pair[name] = ([np.load(Path(tmp.name) / f"fp32_{name}" / f"graph_{i:04d}.npz") for i in range(2)],
                      time.perf_counter() - t0)
    seg_agree = min(float((a["seg"] == b["seg"]).mean()) for a, b in zip(pair["card"][0], pair["cpu"][0]))
    lab_agree = min(float((a["label"] == b["label"]).mean()) for a, b in zip(pair["card"][0], pair["cpu"][0]))
    feat_mae = max(float(np.abs(a["feat"] - b["feat"]).mean()) for a, b in zip(pair["card"][0], pair["cpu"][0]))
    print(f"[offline] generate_dataset, demo frames 0-1 at 448 with fp32 backbones, card against CPU on the same "
          f"weights: SLIC label agreement {seg_agree:.4f} (min {SLIC_448_MIN}), STEGO majority-label agreement "
          f"{lab_agree:.4f} (min {GEN_CPU_TOL['labels']}), per-segment feature MAE {feat_mae:.3e} (tol "
          f"{GEN_CPU_TOL['feat_mae']:.0e}); {pair['card'][1]:.1f} s on the card, {pair['cpu'][1]:.1f} s on the CPU "
          f"for the 2 frames | {card}", flush=True)
    require(seg_agree >= SLIC_448_MIN and lab_agree >= GEN_CPU_TOL["labels"] and feat_mae <= GEN_CPU_TOL["feat_mae"],
            "generate_dataset on the card agrees with the CPU")

    # 2. the ablation sweep; slic:sift again on the CPU
    sweep_args = ["--size", "64", "--duration", "8", "--epochs", "40", "--kfold", "5"]
    rows = {}
    for combo, dev_name in (("slic:sift", "cuda"), ("grid:dinov2", "cuda"), ("slic:sift", "cpu")):
        before = port.launch_counts()
        row = ablation_sweep.sweep(ablation_sweep.parse_args(
            ["--combos", combo, "--device", dev_name, "--out", str(Path(tmp.name) / f"ablation_{dev_name}")]
            + sweep_args))[0]
        delta = {k: v - before[k] for k, v in port.launch_counts().items()}
        rows[(combo, dev_name)] = row
        print(f"[offline] ablation_sweep {combo} on the {dev_name}: {json.dumps(row)}; launches {delta}", flush=True)
        require("error" not in row, f"ablation {combo} on the {dev_name} gave an error row")
        require(np.isfinite(row["val_auroc"]) and np.isfinite(row["control_auroc"]), f"ablation {combo}: finite AUROCs")
        need = {"slic:sift": ("slic_step", "fill_hulls"), "grid:dinov2": ("flash_attention", "fill_hulls")}[combo]
        require(dev_name == "cpu" or all(delta[k] > 0 for k in need), f"ablation {combo} launched {need}")
    a, b = rows[("slic:sift", "cuda")], rows[("slic:sift", "cpu")]
    require(a["nodes_exported"] == b["nodes_exported"] and a["online_train_steps"] == b["online_train_steps"],
            "ablation slic:sift exports the same nodes after the same steps on the card and the CPU")

    # 3. the parameter search: the CLI, then the population of 64 against OfflineTrainer (trial 0)
    require(param_search.main(["--data", "synth", "--trials", "64", "--epochs", "10", "--anomaly_balanced", "true",
                               "--out", str(Path(tmp.name) / "search")]) == 0, "param_search's CLI")
    train, val = param_search.make_synth(seed=42)
    lr, wt, wr = param_search.sample_space(64, 43)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scores, _, _ = param_search.population_fit(train, val, lr, wt, wr, epochs=10, batch_size=8, seed=42)
    pop_s = time.perf_counter() - t0
    cfg = OfflineTrainerConfig(epochs=10, batch_size=8, seed=42)
    cfg.model_cfg["simple_mlp_cfg"]["input_size"] = 32
    trainer = OfflineTrainer(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.fit(train)
    seq_s = time.perf_counter() - t0
    ref = trainer.predict(val.features)
    err = float(np.max(np.abs(scores[0] - ref) - 2e-3 * np.abs(ref)))
    aurocs = [m["val_auroc"] for m in param_search.evaluate_population(scores, val)]
    print(f"[offline] param_search, 64 trials x 10 epochs (synth, 80 steps) on the card: trial 0 against "
          f"OfflineTrainer max |diff| - rtol 2e-3 x |ref| = {err:.3e} (tol 2e-4); AUROC trial 0 {aurocs[0]}, best "
          f"{max(aurocs)}; the population {pop_s:.2f} s, one sequential trial {seq_s:.2f} s on the host clock | "
          f"{card}", flush=True)
    require(err <= 2e-4, "population_fit's trial 0 matches OfflineTrainer on the card")
    require(max(aurocs) >= aurocs[0], "the best trial is not below trial 0")
    out["times"] = {"population_s": pop_s, "sequential_trial_s": seq_s, "generate_ms_per_frame": gen_s * 1e3 / 8}

    # 4. the soak: 600 frames at 448 on 2 cameras, dinov2 x slic 64, per-pixel scoring
    before = port.launch_counts()
    res = soak.run_soak(soak.build_parser().parse_args(
        ["--frames", "600", "--size", "448", "--cameras", "2", "--seg", "slic", "--feature", "dinov2", "--pixelwise",
         "--window", "100", "--warmup_windows", "2"]))
    delta = {k: v - before[k] for k, v in port.launch_counts().items()}
    gates = {k: v for k, v in res.items() if k.startswith("ok_")}
    print(f"[offline] soak, 600 frames at 448 on 2 cameras (dinov2 x slic 64, per pixel), windows of 100: "
          f"{res['fps_median']} frames/s median, {res['fps_last']} last; CUDA memory growth {res['device_growth_mb']} "
          f"MB (budget 64; peak reserved {res['device_reserved_peak_mb']} MB), RSS growth {res['rss_growth_mb']} MB "
          f"(budget 300); {res['graph_semantics']['graph_evictions_total']} graph evictions, {res['train_steps']} "
          f"train steps, {res['supervision_updates']} supervision updates; launches per frame "
          f"{res['launches_per_frame']}; launches {delta}; gates {gates} | {card}", flush=True)
    require(all(gates.values()), f"every soak gate holds: {gates}")
    require(all(v > 0 for v in delta.values()), "the soak launched K1, K2, K3 and K4")
    out["times"].update(soak_fps=res["fps_median"])
    torch.cuda.synchronize()
    out["offline_launches"] = port.launch_counts()
    tmp.cleanup()

    # 5. each kernel against its plain version at these tools' shapes, timed
    q, k, v = (torch.randn(1, 6, 1025, 64, device=dev, generator=g).to(torch.bfloat16) for _ in range(3))
    e1, tol1, tail1 = k1_bf16_check(flash_attention(q, k, v, 0.125), xla_attention(q, k, v, 0.125).float(), q, k, v,
                                    xla_attention, bf16_atol)
    require(e1 <= tol1 < tail1, "K1 at (1, 6, 1025, 64)")
    qkvs = [tuple(torch.randn(1, 6, 1025, 64, device=dev, generator=g).to(torch.bfloat16) for _ in range(3))
            for _ in range(WARMUP + N_TIMED)]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    k1 = {"ms": device_ms(lambda q, k, v: flash_attention(q, k, v, 0.125), qkvs),
          "plain_ms": device_ms(lambda q, k, v: xla_attention(q, k, v, 0.125), qkvs),
          "library_ms": device_ms(lambda q, k, v: sdpa(q, k, v, scale=0.125), qkvs),
          **bound(4 * 6 * 1025 * 64 * 2, {"bf16_tensor": 4 * 6 * 1025 * 1025 * 64}), "max_abs_err": e1}

    head = get_model({"name": "SimpleMLP", "simple_mlp_cfg": {"input_size": 384, "hidden_sizes": [256, 32, 1],
                                                              "reconstruction": True}},
                     device=dev, generator=torch.Generator().manual_seed(2)).eval().requires_grad_(False)
    with torch.no_grad():
        ops = fused_precompute(head, torch.randn(1, 384, 32, 32, device=dev, generator=g), 448, 448)
        (trav, reco), (trav_p, reco_p) = score_pixels(ops, 384), score_pixels_plain(ops, 384)
        opss = [(fused_precompute(head, torch.randn(1, 384, 32, 32, device=dev, generator=g), 448, 448),)
                for _ in range(WARMUP + N_TIMED)]
        k2 = {"ms": device_ms(lambda o: score_pixels(o, 384), opss),
              "plain_ms": device_ms(lambda o: score_pixels_plain(o, 384), opss), "library_ms": None,
              **k2_bound(opss[0][0], 448 * 448)[0]}
    terr = float((trav - trav_p).abs().max())
    rbound = float(((reco - reco_p).abs() - 1e-3 * reco_p.abs()).max())
    require(terr <= 2e-3 and rbound <= 1e-4, "K2 with a 384-d head at 32^2 -> 448^2")
    k2["max_abs_err"] = max(terr, float((reco - reco_p).abs().max()))

    k3 = {}
    for K in (64, 100):
        ws, win2 = slic_geometry(K, 10.0, 448, 448)
        steps = []
        for _ in range(WARMUP + N_TIMED):
            f = pixel_features(rgb_to_lab(torch.rand(1, 3, 448, 448, device=dev, generator=g)), ws)
            steps.append((f, f[:, :, _init_index(K, 448, 448).to(dev)].transpose(1, 2).contiguous()))
        scratch = SlicScratch.allocate(1, 448, 448, K, dev)
        ids, centers = slic_step(steps[0][0], steps[0][1], 448, ws, win2, scratch)  # views of the scratch
        ids_p, centers_p = slic_step_plain(steps[0][0], steps[0][1], 448, ws, win2)
        differ = int((ids != ids_p).sum())
        cerr = float((centers - centers_p).abs().max())
        cbound = float(((centers - centers_p).abs() - 1e-5 * centers_p.abs()).max())
        require(differ == 0 and cbound <= 1e-3, f"K3 at 448x448, K={K}")
        pairs, orphans = zip(*(slic_work(c, 448, 448, ws, win2) for _, c in steps[WARMUP:]))
        pairs, orphans = float(np.mean(pairs)), float(np.mean(orphans))
        hw = 448 * 448
        k3[K] = {"ms": device_ms(lambda f, c: slic_step(f, c, 448, ws, win2, scratch), steps),
                 "path": str(step_layout(448, 448, K, cluster_slots(dev))),
                 "plain_ms": device_ms(lambda f, c: slic_step_plain(f, c, 448, ws, win2), steps), "library_ms": None,
                 **bound(5 * hw * 4 + K * 5 * 4 + hw * 4 + K * 5 * 4, {"fp32": 20 * (pairs + orphans * K) + 6 * hw}),
                 "max_abs_err": cerr, "pairs": pairs, "orphans": orphans}

    rng = np.random.default_rng(9)
    point_sets = [scene_points(dev, rng, 16, K448, 448) for _ in range(WARMUP + N_TIMED)]
    masks_f, hulls_f, hv_f = hull_fill(*point_sets[0], 448, 448, 32)
    hulls, hull_valid = convex_hull(*point_sets[0], max_hull=32)
    differ4 = int((masks_f != fill_hulls_plain(hulls, hull_valid, 448, 448)).sum())
    require(differ4 == 0 and int(masks_f.sum()) > 0, "K4 from points at 16 x 448^2 identical to the plain version")
    nv = torch.stack([convex_hull(p, v, max_hull=32)[1].sum(1) for p, v in point_sets[WARMUP:]]).float()
    march = float(torch.where(nv >= 3, nv.clamp(max=31), 0.0).sum(1).mean())
    hull_sets = [convex_hull(p, v, max_hull=32) for p, v in point_sets]
    k4 = {"ms": device_ms(lambda p, v: hull_fill(p, v, 448, 448, 32), point_sets),
          "plain_ms": device_ms(lambda p, v: fill_hulls_plain(*convex_hull(p, v, max_hull=32), 448, 448), point_sets),
          "library_ms": None,
          **bound(16 * 64 * 9 + 16 * 32 * 9 + 16 * 448 * 448, {"fp32": march * (3 * 64 * 64 + 9 * 64)}),
          "fill_ms": device_ms(lambda h, v: fill_hulls(h, v, 448, 448), hull_sets),
          "fill_plain_ms": device_ms(lambda h, v: fill_hulls_plain(h, v, 448, 448), hull_sets),
          "max_abs_err": 0.0}
    print(f"[offline] kernels at the tools' shapes against their plain versions: K1 (1, 6, 1025, 64) bf16 max abs err "
          f"{e1:.3e} (tol {tol1:.3e}); K2 384-d head (1, 384, 32, 32) -> 448x448 trav {terr:.3e} (tol 2e-3), reco "
          f"within rtol 1e-3 + atol 1e-4; K3 448x448 K=64 and K=100 single-step ids identical; K4 16 footprints -> "
          f"16x448x448 masks from points, 0 pixels differ", flush=True)
    for name, r in (("K1 flash_attention (1, 6, 1025, 64) bf16, ViT-S/14 at 448", k1),
                    ("K2 pixelwise_score 384-d head (1, 384, 32, 32) -> 448x448", k2),
                    ("K3 slic_step 448x448, K=64", k3[64]), ("K3 slic_step 448x448, K=100", k3[100]),
                    ("K4 hull_fill 16 footprints x 64 points -> 16x448x448, from points", k4)):
        lib = f", torch SDPA {r['library_ms']:.4f} ms" if r["library_ms"] is not None else ""
        extra = (f"; {r['pairs']:.0f} (pixel, candidate) pairs, {r['orphans']:.0f} orphans; {r['path']}" if "pairs" in r else
                 f"; the fill alone {r['fill_ms']:.4f} ms, plain {r['fill_plain_ms']:.4f} ms" if "fill_ms" in r else "")
        print(f"[offline time] {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms{lib}; bound "
              f"{r['bound_ms']:.6f} ms ({r['bound_by']}), share of the bound {r['bound_ms'] / r['ms']:.3f}{extra} | "
              f"{card}", flush=True)
    out["kernels"] = {"k1_1025": k1, "k2_d384_448": k2, "k3_448_k64": k3[64], "k3_448_k100": k3[100],
                      "k4_16x448": k4}
    print(f"[offline] launches over the tools' runs {out['offline_launches']}; generate_dataset "
          f"{out['times']['generate_ms_per_frame']:.1f} ms per frame, soak {res['fps_median']} frames/s | {card}",
          flush=True)
    return out


# ------------------------------------------------------------- the parallel layer
PARALLEL_TIMED = 10  # timed calls per rank in the [parallel] phase, after WARMUP calls
TRAINER_RTOL, TRAINER_ATOL = 1e-4, 1e-5  # the distributed trainer against its twin on the card (fp32)


def _parallel_wrapped(counts: dict) -> None:
    """Record the shapes K1 and K4 launch at on the main path, through the
    module attributes the ViT and the hull fill call."""
    import wild_visual_navigation_tpu_torch.models.vit as vit_mod
    import wild_visual_navigation_tpu_torch.ops.rasterize as rast_mod

    k1, k4 = vit_mod.flash_attention, rast_mod.hull_masks

    def flash(q, k, v, *a, **kw):
        counts.setdefault("k1_shapes", set()).add(tuple(q.shape))
        return k1(q, k, v, *a, **kw)

    def hulls(points2d, *a, **kw):
        counts.setdefault("k4_hulls", set()).add(int(points2d.shape[0]))
        return k4(points2d, *a, **kw)

    vit_mod.flash_attention, rast_mod.hull_masks = flash, hulls


def _calls(n: int = WARMUP + PARALLEL_TIMED) -> list:
    """wall_ms's inputs for a function of the call's index: the ranks of a
    mesh make the same calls in the same order."""
    return [(i,) for i in range(n)]


def _mesh_runtime(mesh=None):
    """WVNRuntime at the product's configuration (ViT-S/8 at 224 in bf16,
    SLIC 100, per-pixel prediction, buffer 256, fan-out 32) with the mesh
    scenario's learning gates."""
    from wild_visual_navigation_tpu_torch.runtime import WVNRuntime
    from wild_visual_navigation_tpu_torch.runtime.mesh_scenario import scenario_params

    fe, ln = scenario_params(product=True)
    return WVNRuntime(fe_params=fe, ln_params=ln, seed=0, buffer_capacity=256, reprojection_fanout=32, mesh=mesh,
                      device="cuda")


def _scenario_and_times(rt, record_shapes: bool = False) -> dict:
    """The mesh scenario through `rt`, its launches (and, in a rank, the
    shapes K1 and K4 launched at), then image_batch_callback B=4 and
    learning_step timed."""
    import torch

    import wild_visual_navigation_tpu_torch as port
    from wild_visual_navigation_tpu_torch.runtime.mesh_scenario import run_mesh_scenario, scenario_inputs

    shapes: dict = {}
    if record_shapes:
        _parallel_wrapped(shapes)
    torch.cuda.synchronize()
    port.reset_launch_counts()
    out = run_mesh_scenario(rt)
    torch.cuda.synchronize()
    out["launches"] = port.launch_counts()
    out.update({k: sorted(v) for k, v in shapes.items()})
    imgs, Ks, Tc = scenario_inputs()

    def batch(i):
        poses = np.tile(np.eye(4), (4, 1, 1))
        poses[:, 0, 3] = 100.0 + i  # new places: every frame takes a slot, as a robot moving on would
        res = rt.image_batch_callback(imgs, stamps=[100.0 + i + 0.01 * c for c in range(4)],
                                      cameras=[f"cam{c}" for c in range(4)], Ks=Ks, orig_h=40, orig_w=40,
                                      poses_base_in_world=poses, poses_cam_in_base=np.tile(Tc, (4, 1, 1)))
        return res[-1].traversability

    out["batch_ms"] = wall_ms(batch, _calls())
    out["learn_ms"] = wall_ms(lambda i: rt.learning_step(), _calls())
    return out


def parallel_mesh_rank(rank: int, world: int) -> dict:
    """(a) on one rank of the (2, 2) mesh: the meshed runtime."""
    from wild_visual_navigation_tpu_torch.parallel import create_mesh

    from wild_visual_navigation_tpu_torch.runtime.mesh_scenario import run_single_frame_scenario

    mesh = create_mesh(dp=2, tp=2, device="cuda")
    out = _scenario_and_times(_mesh_runtime(mesh), record_shapes=True)
    out["coords"] = (mesh.get_local_rank("dp"), mesh.get_local_rank("tp"))
    # image_callback one frame at a time on a fresh meshed runtime: the tp ViT on one frame
    shapes: dict = {}
    _parallel_wrapped(shapes)
    out["single_frame"] = run_single_frame_scenario(_mesh_runtime(mesh))
    out["single_frame_k1_shapes"] = sorted(shapes.get("k1_shapes", ()))
    return out


def parallel_nccl_rank(rank: int, world: int) -> dict:
    """(c) NCCL at world size 1: a (1, 1) mesh against no mesh, same rank."""
    import torch.distributed as dist

    from wild_visual_navigation_tpu_torch.parallel import create_mesh
    from wild_visual_navigation_tpu_torch.runtime.mesh_scenario import run_mesh_scenario

    backend = dist.get_backend()
    meshed = run_mesh_scenario(_mesh_runtime(create_mesh(dp=1, tp=1, device="cuda")))
    plain = run_mesh_scenario(_mesh_runtime())
    return {"backend": str(backend), "meshed": meshed, "plain": plain}


def _ingest(est, seq: dict, frames: list, size: int, keep) -> None:
    """Mission nodes of the frames `keep` selects (the card's frame outputs)
    and every robot state's footprint, in stamp order, without training."""
    from wild_visual_navigation_tpu_torch.cfg.node_params import LearningNodeParams
    from wild_visual_navigation_tpu_torch.ops.projection import scale_intrinsics
    from wild_visual_navigation_tpu_torch.supervision.supervision_generator import SupervisionGenerator

    sg = SupervisionGenerator(untraversable_thr=LearningNodeParams().untraversable_thr)
    h0, w0 = seq["frame_images"].shape[2:]
    for stamp, kind, i in mission_events(seq):
        if kind == 0 and keep(i):
            est.add_mission_node(frame_node(seq, i, stamp), *(t.to(est._device) for t in frames[i]),
                                 scale_intrinsics(seq["frame_K"][i], h0, w0, new_h=size))
        elif kind == 1:
            est.add_supervision_node(state_node(seq, i, stamp, sg))
    est._resolve_pending_supervision()


def parallel_trainer_rank(rank: int, world: int, path: str) -> dict:
    """(b) one rank's estimator fed its half of the demo mission (every
    other frame), in a DistributedTrainer with tp = 1 and then tp = 2;
    rank 1 ingests only after the first step, so it is starved there."""
    import torch

    from wild_visual_navigation_tpu_torch.parallel import DistributedTrainer
    from wild_visual_navigation_tpu_torch.runtime.mesh_scenario import params_checksum

    data = torch.load(path, weights_only=False)
    seq, frames, size, S, D = data["seq"], data["frames"], data["size"], data["S"], data["D"]
    out = {}

    def mine(i):
        return i % world == rank

    for tp in (1, 2):
        est = product_estimator("cuda", size, S, D)
        if rank == 0:
            _ingest(est, seq, frames, size, mine)
        trainer = DistributedTrainer(est, tp=tp)
        local, losses, valid, batches = trainer._local_batch, [], [], []

        def recorded():
            b = local()
            batches.append([None if t is None else t.cpu().numpy() for t in b])
            return b

        trainer._local_batch = recorded
        for step in range(3):
            if step == 1 and rank == 1:
                _ingest(est, seq, frames, size, mine)
            losses.append(trainer.step()["loss_total"])
            valid.append(est._mission_graph.get_num_valid_nodes())
        trainer.sync_to_estimator()
        trainer._local_batch = local
        out[tp] = {"losses": losses, "batches": batches, "valid": valid, "mesh": trainer.mesh.mesh_dim_names,
                   "params": {k: v.detach().cpu().clone().numpy() for k, v in est.params.items()},
                   "checksum": params_checksum(est.params),
                   "step_ms": wall_ms(lambda i: trainer.step(), _calls())}
        if tp == 1:
            out["local_ms"] = wall_ms(lambda i: est.train(), _calls())
    return out


def parallel_phase(dev, card: str, seq: dict, frames: list, size: int, S: int, D: int) -> dict:
    """The [parallel] phase: (a) the meshed runtime on 4 Gloo ranks sharing
    the card as (dp, tp) = (2, 2) against the unmeshed runtime, (b) the
    distributed trainer on 2 ranks against a single-process twin, (c) NCCL
    at world size 1; then K1 and K4 at the ranks' shapes, each held against
    its plain version and timed. Returns rank 0's launches in (a)."""
    import tempfile

    import torch

    from wild_visual_navigation_tpu_torch.ops.flash_attention import bf16_atol, flash_attention, xla_attention
    from wild_visual_navigation_tpu_torch.ops.rasterize import convex_hull
    from wild_visual_navigation_tpu_torch.ops.rasterize_fill import fill_hulls, fill_hulls_plain, hull_fill
    from wild_visual_navigation_tpu_torch.parallel.launch import run_ranks
    from wild_visual_navigation_tpu_torch.runtime.mesh_scenario import TOLERANCES, run_single_frame_scenario
    from wild_visual_navigation_tpu_torch.utils.data import TravBatch

    t0 = time.perf_counter()
    # (a) the unmeshed runtime first, alone on the card, then the 4 ranks
    single = _scenario_and_times(_mesh_runtime())
    ranks = run_ranks(parallel_mesh_rank, 4, timeout=400)
    checks = []
    for r in ranks:
        trav = max(float(np.abs(a - b).max()) for a, b in zip(r["trav"], single["trav"]))
        loss_ok = np.allclose(r["losses"], single["losses"], rtol=TOLERANCES["loss_rtol"],
                              atol=TOLERANCES["loss_atol"])
        par = max(float(np.abs(r["params"][k] - v).max()) for k, v in single["params"].items())
        checks.append((trav, loss_ok, par))
    print(f"[parallel] (a) WVNRuntime(mesh=(dp 2, tp 2)) on 4 Gloo ranks sharing the card, product configuration "
          f"(ViT-S/8 at 224 bf16, SLIC 100, per pixel, buffer 256, fan-out 32), the mesh scenario (4 cameras x 3 "
          f"steps, 5 learning steps) against the unmeshed runtime: per rank (dp, tp) {[r['coords'] for r in ranks]}, "
          f"trav max abs diff {[round(c[0], 6) for c in checks]} (tol {TOLERANCES['trav_atol']}), losses "
          f"{[round(x, 6) for x in ranks[0]['losses']]} against {[round(x, 6) for x in single['losses']]} (rtol "
          f"{TOLERANCES['loss_rtol']}, atol {TOLERANCES['loss_atol']}), params max abs diff "
          f"{[round(c[2], 6) for c in checks]} (tol {TOLERANCES['params_atol']}); checksums "
          f"{[r['checksum'] for r in ranks]}", flush=True)
    for rank, r in enumerate(ranks):
        print(f"[parallel] (a) rank {rank} launches {r['launches']}; K1 at {r.get('k1_shapes')}, K4 on "
              f"{r.get('k4_hulls')} hulls per launch; unmeshed launches {single['launches']}")
    require(all(c[0] <= TOLERANCES["trav_atol"] and c[1] and c[2] <= TOLERANCES["params_atol"] for c in checks),
            "the meshed runtime agrees with the unmeshed one")
    require(len({r["checksum"] for r in ranks}) == 1, "every rank of the mesh holds the same params")
    require(single["losses"][-1] >= 0, "the scenario trained")
    require(all(r["launches"][k] > 0 for r in ranks for k in r["launches"]), "every kernel launched on every rank")
    require(all(r.get("k1_shapes") == [(2, 3, 785, 64)] and r.get("k4_hulls") == [16] for r in ranks),
            "K1 on each rank's 3 heads of its 2 frames, K4 on its 16 of the 32 hulls")
    single_frame = run_single_frame_scenario(_mesh_runtime())
    sf = [max(float(np.abs(a - b).max()) for a, b in zip(r["single_frame"]["trav"], single_frame["trav"]))
          for r in ranks]
    sf_feat = [float(np.abs(r["single_frame"]["features"] - single_frame["features"]).max()) for r in ranks]
    print(f"[parallel] (a) image_callback one frame at a time on the (2, 2) mesh ({len(single_frame['trav'])} calls, "
          f"the scenario's cameras in turn) against the unmeshed runtime: trav max abs diff per rank "
          f"{[round(x, 6) for x in sf]} (tol {TOLERANCES['trav_atol']}), buffer features max abs diff "
          f"{[round(x, 6) for x in sf_feat]}; K1 at {[r['single_frame_k1_shapes'] for r in ranks]}", flush=True)
    require(all(x <= TOLERANCES["trav_atol"] for x in sf), "the meshed single-frame callback agrees with the unmeshed")
    require(all(r["single_frame_k1_shapes"] == [(1, 3, 785, 64)] for r in ranks),
            "K1 on each rank's 3 heads of the one frame")
    print(f"[time] (a) image_batch_callback B=4: meshed {[round(r['batch_ms'], 3) for r in ranks]} ms per rank "
          f"(4 ranks on one card, Gloo), unmeshed {single['batch_ms']:.3f} ms; learning_step meshed "
          f"{[round(r['learn_ms'], 3) for r in ranks]} ms, unmeshed {single['learn_ms']:.3f} ms; host clock, median "
          f"of {PARALLEL_TIMED} | {card}", flush=True)

    # (b) the distributed trainer, against a twin stepping on the concatenated rows
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/mission.pt"
        torch.save({"seq": seq, "frames": [tuple(t.cpu() for t in f) for f in frames], "size": size, "S": S,
                    "D": D}, path)
        trainers = run_ranks(parallel_trainer_rank, 2, args=(path,), timeout=400)
    for tp in (1, 2):
        twin = product_estimator(dev, size, S, D)
        twin_losses = []
        for step in range(3):
            parts = [[None if a is None else torch.from_numpy(a).to(dev) for a in r[tp]["batches"][step]]
                     for r in trainers]
            batch = TravBatch(*(None if f[0] is None else torch.cat(f) for f in zip(*parts)))
            loss, _, twin._cg_state = twin.step_on_batch(twin.model, twin.optimizer, twin.confidence_state, batch)
            twin_losses.append(float(loss))
        rows = [[int(np.asarray(b[3]).sum()) for b in r[tp]["batches"]] for r in trainers]
        par = max(float(np.abs(r[tp]["params"][k] - v.cpu().numpy()).max()) for r in trainers
                  for k, v in twin.params.items())
        print(f"[parallel] (b) DistributedTrainer tp={tp} (mesh {trainers[0][tp]['mesh']}) on 2 Gloo ranks, each "
              f"fed every other demo frame (valid nodes per step {[r[tp]['valid'] for r in trainers]}; valid rows "
              f"per step {rows}, rank 1 starved on step 1): losses {[round(x, 6) for x in trainers[0][tp]['losses']]}"
              f" against the twin's {[round(x, 6) for x in twin_losses]}; params max abs diff {par:.3e} (rtol "
              f"{TRAINER_RTOL}, atol {TRAINER_ATOL}); checksums {[r[tp]['checksum'] for r in trainers]}", flush=True)
        require(rows[1][0] == 0 and rows[0][0] > 0 and rows[1][1] > 0, "rank 1 starved on step 1 only")
        require(trainers[0][tp]["checksum"] == trainers[1][tp]["checksum"], "both ranks hold the same params")
        for r in trainers:
            require(np.allclose(r[tp]["losses"], twin_losses, rtol=TRAINER_RTOL, atol=TRAINER_ATOL),
                    f"the trainer's losses (tp={tp}) match the twin's")
            require(all(np.allclose(r[tp]["params"][k], v.cpu().numpy(), rtol=TRAINER_RTOL, atol=TRAINER_ATOL)
                        for k, v in twin.params.items()), f"the trainer's params (tp={tp}) match the twin's")
    print(f"[time] (b) DistributedTrainer.step (batch 8 x 100 per rank, 2 ranks on one card, Gloo): tp=1 "
          f"{[round(r[1]['step_ms'], 3) for r in trainers]} ms, tp=2 {[round(r[2]['step_ms'], 3) for r in trainers]} "
          f"ms; the local estimator's train step {[round(r['local_ms'], 3) for r in trainers]} ms; host clock, "
          f"median of {PARALLEL_TIMED} | {card}", flush=True)

    # (c) NCCL at world size 1
    (nccl,) = run_ranks(parallel_nccl_rank, 1, backend="nccl", timeout=400)
    same = all(np.array_equal(a, b) for a, b in zip(nccl["meshed"]["trav"] + nccl["meshed"]["conf"],
                                                      nccl["plain"]["trav"] + nccl["plain"]["conf"]))
    print(f"[parallel] (c) backend {nccl['backend']} at world size 1: WVNRuntime(mesh=(1, 1)) maps equal to the "
          f"unmeshed runtime's: {same}; losses {nccl['meshed']['losses']} and {nccl['plain']['losses']}", flush=True)
    require(nccl["backend"] == "nccl" and same and nccl["meshed"]["losses"] == nccl["plain"]["losses"],
            "a (1, 1) mesh over NCCL gives exactly the unmeshed runtime's maps")

    # the kernels at the ranks' shapes
    g = torch.Generator(device=dev).manual_seed(7)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    k1 = {}
    for shape in ((2, 3, 785, 64), (1, 3, 785, 64)):
        B, H, Sq, Dh = shape
        qkvs = [tuple(torch.randn(shape, device=dev, generator=g).bfloat16() for _ in range(3))
                for _ in range(WARMUP + N_TIMED)]
        # a tp rank's heads as the ViT hands them over: strided views of its (B, S, 3, H/tp, Dh) qkv product
        buf = torch.randn(B, Sq, 3, H, Dh, device=dev, generator=g).bfloat16()
        for what, (q, k, v) in (("contiguous", qkvs[0]), (f"strided views of a {(B, Sq, 3, H, Dh)} qkv buffer",
                                                          buf.permute(2, 0, 3, 1, 4).unbind(0))):
            ref = xla_attention(q, k, v, 0.125).float()
            err, tol, tail = k1_bf16_check(flash_attention(q, k, v, 0.125), ref, q, k, v, xla_attention, bf16_atol)
            print(f"[parallel] K1 flash_attention {shape} bfloat16, {what}: max abs err {err:.3e} (tol {tol:.3e}; "
                  f"without the last kv tile the plain version errs by {tail:.3e})")
            require(err <= tol < tail, f"K1 at a tp rank's {shape}, {what}")
        k_ms = device_ms(lambda q, k, v: flash_attention(q, k, v, 0.125), qkvs)
        p_ms = device_ms(lambda q, k, v: xla_attention(q, k, v, 0.125), qkvs)
        s_ms = device_ms(lambda q, k, v: sdpa(q, k, v, scale=0.125), qkvs)
        b = bound(4 * B * H * Sq * Dh * 2, {"bf16_tensor": 4 * B * H * Sq * Sq * Dh})
        k1[shape] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": s_ms, **b}
        what = "image_batch_callback B=4 over dp 2" if B == 2 else "image_callback, one frame"
        print(f"[time] K1 flash_attention {shape} bf16 (a tp rank's 3 heads, {what}): kernel {k_ms:.4f} ms, "
              f"plain {p_ms:.4f} ms, torch SDPA {s_ms:.4f} ms; bound {b['bound_ms']:.6f} ms "
              f"({b['bound_by']}), share of the bound {b['bound_ms'] / k_ms:.3f} | {card}")
    rng = np.random.default_rng(11)
    K224 = np.array([[160.0, 0, 112], [0, 160.0, 112], [0, 0, 1]], np.float32)
    point_sets = [scene_points(dev, rng, 16, K224, 224) for _ in range(WARMUP + N_TIMED)]
    hull_sets = [convex_hull(p, v, max_hull=32) for p, v in point_sets]
    differ = [int((fill_hulls(h, v, 224, 224) != fill_hulls_plain(h, v, 224, 224)).sum()) for h, v in hull_sets]
    from_points = [int((hull_fill(p, v, 224, 224, 32)[0] != fill_hulls_plain(*hs, 224, 224)).sum())
                   for (p, v), hs in zip(point_sets, hull_sets)]
    print(f"[parallel] K4 on {len(hull_sets)} sets of 16 hulls at 224x224 (a dp rank's half of the fan-out): pixels "
          f"differing from fill_hulls_plain {sum(differ)} (must be 0), from points (hull and fill) {sum(from_points)} "
          f"(must be 0), of {len(hull_sets) * 16 * 224 * 224}")
    require(sum(differ) == 0 and sum(from_points) == 0, "K4 on 16 hulls identical to its plain version")
    fa_ms = device_ms(lambda h, v: fill_hulls(h, v, 224, 224), hull_sets)
    fap_ms = device_ms(lambda h, v: fill_hulls_plain(h, v, 224, 224), hull_sets)
    hp_ms = device_ms(lambda p, v: hull_fill(p, v, 224, 224, 32), point_sets)
    b4 = bound(16 * 32 * 9 + 16 * 224 * 224, {"fp32": 16 * 33 * 6})
    print(f"[time] K4 fill_hulls 16 hulls -> 16x224x224 (a dp rank's half of the fan-out of 32): kernel {fa_ms:.4f} "
          f"ms, plain {fap_ms:.4f} ms, the launch from points (hull and fill) {hp_ms:.4f} ms; bound "
          f"{b4['bound_ms']:.6f} ms ({b4['bound_by']}), share of the bound {b4['bound_ms'] / fa_ms:.3f} | {card}")
    print(f"[parallel] phase done in {time.perf_counter() - t0:.1f} s", flush=True)
    return {"launches": ranks[0]["launches"], "k1": k1,
            "k4_16": {"ms": fa_ms, "plain_ms": fap_ms, "from_points_ms": hp_ms, **b4}}


# ------------------------------------------------- 4i: the quantised backbone on the mesh
QUANT_MESH_TOL = {"trav_mean": 2e-2, "trav_max": 2e-1, "conf_mean": 5e-2}  # an int8 runtime against another
# all_reduces of one forward of a quantised ViT-S/8 on the (2, 2) mesh: the int32 sums of proj and fc2 over tp,
# the MAX of every Linear's dynamic abs-max, of "xla_int8"'s q, k and v
QUANT_MESH_REDUCES = {"int8_static": {"SUM int32": 24}, "int8": {"SUM int32": 24, "MAX float32": 48},
                      "int8 xla_int8": {"SUM int32": 24, "MAX float32": 48 + 36}}


def _quant_runtime(quant, mesh=None):
    """_mesh_runtime with a quantised backbone, calibrated (int8_static) on
    the mesh scenario's frames: every rank the same frames."""
    from wild_visual_navigation_tpu_torch.runtime import WVNRuntime
    from wild_visual_navigation_tpu_torch.runtime.mesh_scenario import scenario_inputs, scenario_params

    fe, ln = scenario_params(product=True)
    fe.dino_quant = quant
    rt = WVNRuntime(fe_params=fe, ln_params=ln, seed=0, buffer_capacity=256, reprojection_fanout=32, mesh=mesh,
                    device="cuda")
    rt.calibrate_backbone([scenario_inputs()[0]])
    return rt


def _count_reduces(fn) -> dict:
    """fn() with every torch.distributed.all_reduce counted by op and type."""
    import torch.distributed as dist

    counts: dict = {}
    all_reduce = dist.all_reduce

    def counting(t, op=dist.ReduceOp.SUM, *a, **kw):
        key = f"{'MAX' if op == dist.ReduceOp.MAX else 'SUM'} {str(t.dtype)[6:]}"
        counts[key] = counts.get(key, 0) + 1
        return all_reduce(t, op, *a, **kw)

    dist.all_reduce = counting
    try:
        fn()
    finally:
        dist.all_reduce = all_reduce
    return counts


def quant_mesh_rank(rank: int, world: int) -> dict:
    """4i on one rank of the (2, 2) mesh: the int8_static and int8 product
    runtimes through the mesh scenario (launches and K1's shapes), the
    all_reduces of one ViT forward of each (and of an int8 ViT with
    "xla_int8" attention, split by shard_module), then image_batch_callback
    B=4 of the two and of the bf16 runtime, in turns."""
    import torch

    import wild_visual_navigation_tpu_torch as port
    from wild_visual_navigation_tpu_torch.models import vit as tvit
    from wild_visual_navigation_tpu_torch.parallel import create_mesh, shard_module, vit_param_spec
    from wild_visual_navigation_tpu_torch.runtime.mesh_scenario import run_mesh_scenario, scenario_inputs

    mesh = create_mesh(dp=2, tp=2, device="cuda")
    out = {"coords": (mesh.get_local_rank("dp"), mesh.get_local_rank("tp"))}
    rts = {"int8_static": _quant_runtime("int8_static", mesh), "int8": _quant_runtime("int8", mesh),
           "bf16": _mesh_runtime(mesh)}
    x = torch.rand(2, 3, 224, 224, generator=torch.Generator().manual_seed(rank // 2)).cuda()  # this dp rank's frames
    for quant in ("int8_static", "int8"):
        shapes: dict = {}
        _parallel_wrapped(shapes)
        torch.cuda.synchronize()
        port.reset_launch_counts()
        res = run_mesh_scenario(rts[quant])
        torch.cuda.synchronize()
        res["launches"] = port.launch_counts()
        res["k1_shapes"] = sorted(shapes.get("k1_shapes", ()))
        res["amax"] = [float(m.amax) for m in rts[quant].feature_extractor._extractor.vit.modules()
                       if isinstance(m, tvit.StaticQuantLinear)]
        with torch.no_grad():
            res["reduces"] = _count_reduces(lambda: tvit.dense_features(rts[quant].feature_extractor._extractor.vit,
                                                                        x))
        out[quant] = res
    vit = tvit.make_vit("dino", "vit_small", 8, attention_impl="xla_int8", quant="int8", device="cuda",
                        generator=torch.Generator().manual_seed(0))
    shard_module(vit, vit_param_spec(vit, tp=2), mesh)
    with torch.no_grad():
        out["xla_int8_reduces"] = _count_reduces(lambda: tvit.dense_features(vit, x))
    imgs, Ks, Tc = scenario_inputs()

    def batch(rt, i):
        poses = np.tile(np.eye(4), (4, 1, 1))
        poses[:, 0, 3] = 100.0 + i
        res = rt.image_batch_callback(imgs, stamps=[100.0 + i + 0.01 * c for c in range(4)],
                                      cameras=[f"cam{c}" for c in range(4)], Ks=Ks, orig_h=40, orig_w=40,
                                      poses_base_in_world=poses, poses_cam_in_base=np.tile(Tc, (4, 1, 1)))
        return res[-1].traversability

    times: dict = {}
    for n, name in enumerate(["bf16", "int8_static", "int8", "int8", "int8_static", "bf16"]):
        calls = [(rts[name], 1000 * (n + 1) + i) for i in range(WARMUP + PARALLEL_TIMED)]
        times.setdefault(name, []).append(wall_ms(batch, calls))
    out["batch_ms"] = times
    return out


def quant_mesh_phase(dev, card: str) -> dict:
    """Phase 4i's quantised half: the product runtime with dino_quant
    "int8_static" and "int8" on 4 Gloo ranks sharing the card as (dp, tp) =
    (2, 2), held against the unmeshed runtimes on the same weights at the
    int8 limits, its amax equal to the unmeshed calibration's, its
    all_reduces counted, its image_batch_callback timed beside the meshed
    bf16 runtime's. Returns rank 0's launches in the int8_static scenario."""
    from wild_visual_navigation_tpu_torch.models import vit as tvit
    from wild_visual_navigation_tpu_torch.parallel.launch import run_ranks
    from wild_visual_navigation_tpu_torch.runtime.mesh_scenario import run_mesh_scenario

    t0 = time.perf_counter()
    single = {}
    for quant in ("int8_static", "int8"):
        rt = _quant_runtime(quant)
        single[quant] = run_mesh_scenario(rt)
        single[quant]["amax"] = [float(m.amax) for m in rt.feature_extractor._extractor.vit.modules()
                                 if isinstance(m, tvit.StaticQuantLinear)]
        del rt
    ranks = run_ranks(quant_mesh_rank, 4, timeout=500)
    for quant in ("int8_static", "int8"):
        diffs = []
        for r in ranks:
            d = [np.abs(a - b) for a, b in zip(r[quant]["trav"], single[quant]["trav"])]
            c = [np.abs(a - b).mean() for a, b in zip(r[quant]["conf"], single[quant]["conf"])]
            diffs.append((max(float(x.mean()) for x in d), max(float(x.max()) for x in d), max(c)))
        print(f"[parallel] (d) WVNRuntime(mesh=(dp 2, tp 2), dino_quant={quant!r}) on 4 Gloo ranks sharing the card, "
              f"the product configuration and the mesh scenario, against the unmeshed {quant} runtime on the same "
              f"weights: per rank trav mean abs diff {[round(d[0], 6) for d in diffs]} (tol "
              f"{QUANT_MESH_TOL['trav_mean']}), max {[round(d[1], 6) for d in diffs]} (tol {QUANT_MESH_TOL['trav_max']})"
              f", conf mean {[round(d[2], 6) for d in diffs]} (tol {QUANT_MESH_TOL['conf_mean']}); checksums "
              f"{[r[quant]['checksum'] for r in ranks]}; amax equal to the unmeshed calibration's: "
              f"{[r[quant]['amax'] == single[quant]['amax'] for r in ranks]} ({len(single[quant]['amax'])} buffers)",
              flush=True)
        for rank, r in enumerate(ranks):
            print(f"[parallel] (d) {quant} rank {rank} (dp, tp) {r['coords']}: launches {r[quant]['launches']}; K1 at "
                  f"{r[quant]['k1_shapes']}; all_reduces of one ViT forward (2 frames) {r[quant]['reduces']}")
        require(all(d[0] <= QUANT_MESH_TOL["trav_mean"] and d[1] <= QUANT_MESH_TOL["trav_max"]
                    and d[2] <= QUANT_MESH_TOL["conf_mean"] for d in diffs),
                f"the meshed {quant} runtime agrees with the unmeshed one")
        require(len({r[quant]["checksum"] for r in ranks}) == 1, f"every rank of the {quant} mesh holds the same params")
        require(all(r[quant]["amax"] == single[quant]["amax"] for r in ranks),
                f"{quant}: calibrated amax on the mesh equal to unmeshed, bit for bit")
        require(all(all(v > 0 for v in r[quant]["launches"].values()) for r in ranks),
                f"{quant}: every kernel launched on every rank")
        require(all(r[quant]["k1_shapes"] == [(2, 3, 785, 64)] for r in ranks), f"{quant}: K1 on each rank's 3 heads")
        require(all(r[quant]["reduces"] == QUANT_MESH_REDUCES[quant] for r in ranks),
                f"{quant}: the all_reduces of one forward are {QUANT_MESH_REDUCES[quant]}")
    print(f"[parallel] (d) an int8 ViT-S/8 with xla_int8 attention split by shard_module: all_reduces of one forward "
          f"per rank {[r['xla_int8_reduces'] for r in ranks]}", flush=True)
    require(all(r["xla_int8_reduces"] == QUANT_MESH_REDUCES["int8 xla_int8"] for r in ranks),
            "xla_int8: 24 int32 sums and 48 + 36 maxima per forward")
    print(f"[time] (d) image_batch_callback B=4 on the (2, 2) mesh, per rank, in turns (bf16, int8_static, int8, int8, "
          f"int8_static, bf16): " + "; ".join(f"{name} {[[round(t, 3) for t in r['batch_ms'][name]] for r in ranks]} ms"
                                               for name in ("bf16", "int8_static", "int8"))
          + f"; host clock, median of {PARALLEL_TIMED} | {card}", flush=True)
    print(f"[parallel] quantised mesh done in {time.perf_counter() - t0:.1f} s", flush=True)
    return {"launches": ranks[0]["int8_static"]["launches"], "batch_ms": [r["batch_ms"] for r in ranks]}


# ---------------------------------------------------------------- 4j [quant] and 4k [engine]

QUANT_CPU_TOL = {"trav_mean": 2e-2, "trav_max": 2e-1, "conf_mean": 5e-2}  # int8 card against its CPU twin
QUANT_CPU_FRAMES = 6  # the CPU twin replays the mission's first frames
QUANT_ATTN_REL = 0.05  # attention_scores_int8 against fp32 attention: JAX's own band (tests/test_models.py)
QUANT_FEAT_REL = 0.05  # config 5's features against the bf16 ViT's, relative L2
# every Linear of ViT-S/8 at 224 (B=1), the engine's ViT-S/14 at 224 and ViT-B/14 at 644 (B=4): (rows, in, out)
INT_MM_SHAPES = {"ViT-S/8 224": [(785, 384, 1152), (785, 384, 384), (785, 384, 1536), (785, 1536, 384)],
                 "ViT-S/14 224 (engine)": [(257, 384, 1152), (257, 1536, 384)],
                 "ViT-B/14 644 B=4": [(8468, 768, 2304), (8468, 768, 768), (8468, 768, 3072), (8468, 3072, 768)]}


def drive(rt, kind: str, payload):
    """One event of the recorded mission through rt's callbacks, as
    run_replay drives it: a frame's result, or None after a robot state and
    its learning step."""
    if kind == "frame":
        f = payload
        return rt.image_callback(f.image, f.stamp, f.camera, f.K, f.image.shape[1], f.image.shape[2],
                                 f.pose_base_in_world, f.pose_cam_in_base)
    rt.robot_state_callback(payload.stamp, payload.pose_base_in_world, payload.current_twist, payload.desired_twist)
    rt.learning_step()
    return None


def profile_ops(fn, inputs) -> dict:
    """torch.profiler over fn(*x) for each input: wall ms, device kernel ms
    and kernel launches per call, the busy share, and the device ms per call
    of each operator's own kernels (self time, by operator name). Where fn
    drives WVNRuntime, the runtime's spans are on while the profiler records
    (utils/timers.py), so wall ms and the busy share include their cost."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for x in inputs:
            fn(*x)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    n = len(inputs)
    averages = prof.key_averages()
    kernels = [r for r in averages if str(r.device_type).endswith("CUDA") and r.device_time_total > 0]
    busy = sum(r.device_time_total for r in kernels) / 1e3
    ops = {r.key: r.self_device_time_total / 1e3 / n for r in averages
           if not str(r.device_type).endswith("CUDA") and r.self_device_time_total > 0}
    return {"wall_ms": wall / n, "device_ms": busy / n, "launches": sum(r.count for r in kernels) / n,
            "busy": busy / wall, "ops": dict(sorted(ops.items(), key=lambda kv: -kv[1])),
            "kernels": {r.key: r.device_time_total / 1e3 / n for r in kernels}}


def int8_split(prof: dict) -> dict:
    """A profile's device ms per call in four parts: the int8 products
    (aten::_int_mm's kernels), K1 (its kernels by name: the eager route
    launches them outside any operator), the fp products (mm, addmm, bmm)
    and everything else (the quantise and dequantise passes in an int8
    frame, the LayerNorms, casts, GELU, SLIC, scoring, ...)."""
    ops = prof["ops"]
    out = {"int_mm": ops.get("aten::_int_mm", 0.0),
           "K1": sum(ms for name, ms in prof["kernels"].items() if "flash_fwd" in name),
           "fp_mm": sum(ops.get(op, 0.0) for op in ("aten::mm", "aten::addmm", "aten::bmm"))}
    out["rest"] = prof["device_ms"] - sum(out.values())
    return out


def quant_phase(dev, card: str, seq_path: Path) -> dict:
    """Phase 4j [quant]: (a) WVNRuntime at the product's settings with
    dino_quant="int8_static", calibrated on the first 2 demo frames, replaying
    the mission interleaved with the same runtime in bf16 on the same
    weights, and its first frames on the CPU; (b) BASELINE config 5 (DINOv2
    ViT-B/14 at 644, 4 cameras, grid, patch-resolution scoring) as
    int8_static, int8 and bf16 on the same weights, interleaved; (c) the
    shape rules of torch._int_mm at every Linear, and attention_scores_int8.
    Returns the int8 runtime's launches over its replay."""
    import dataclasses

    import torch

    import wild_visual_navigation_tpu_torch as port
    from wild_visual_navigation_tpu_torch.cfg.experiment import ExperimentParams
    from wild_visual_navigation_tpu_torch.cfg.node_params import FeatureExtractorNodeParams, LearningNodeParams
    from wild_visual_navigation_tpu_torch.models import quant
    from wild_visual_navigation_tpu_torch.models.vit import StaticQuantLinear, dense_features, make_vit
    from wild_visual_navigation_tpu_torch.ops.flash_attention import xla_attention
    from wild_visual_navigation_tpu_torch.ops.resize import imagenet_normalize
    from wild_visual_navigation_tpu_torch.runtime import WVNRuntime, load_sequence
    from wild_visual_navigation_tpu_torch.runtime.replay import Sequence

    t_phase = time.perf_counter()
    sequence = load_sequence(str(seq_path))
    events = list(sequence.events())
    fe, ln = runtime_params()

    def product(device, dino_quant):
        return WVNRuntime(fe_params=dataclasses.replace(fe, dino_quant=dino_quant), ln_params=ln, seed=0,
                          buffer_capacity=256, reprojection_fanout=32, device=device)

    # (a) the product runtime, int8_static against bf16, in turns on every event
    rts = {"int8_static": product(dev, "int8_static"), "bf16": product(dev, None)}
    cal = [sequence.frames[i].image[None] for i in range(2)]
    require(rts["int8_static"].calibrate_backbone(cal) and not rts["bf16"].calibrate_backbone(cal),
            "calibrate_backbone: True for int8_static, False for bf16")
    amax = [float(m.amax) for m in rts["int8_static"].feature_extractor._extractor.vit.modules()
            if isinstance(m, StaticQuantLinear)]
    require(len(amax) == 48 and min(amax) > 0, "48 calibrated activation scales")
    maps = {k: [] for k in rts}
    host = {k: [] for k in rts}
    per_frame, quant_launches = [], {k: 0 for k in port.launch_counts()}
    for i, (_, kind, payload) in enumerate(events):
        order = list(rts) if i % 2 == 0 else list(rts)[::-1]
        for name in order:
            before = port.launch_counts()
            t0 = time.perf_counter()
            res = drive(rts[name], kind, payload)
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) * 1e3
            if name == "int8_static":
                delta = {k: v - before[k] for k, v in port.launch_counts().items()}
                quant_launches = {k: quant_launches[k] + delta[k] for k in delta}
                if kind == "frame":
                    per_frame.append(delta)
            if res is not None:
                host[name].append(dt)
                maps[name].append(tuple(t.float().cpu().numpy() for t in (res.traversability, res.confidence)))
    n_frames = len(sequence.frames)
    require(all(len(maps[k]) == n_frames for k in maps), "every frame accepted by both runtimes")
    require(all((d["flash_attention"], d["pixelwise_score"], d["slic_step"]) == (12, 1, 11) for d in per_frame),
            f"K1 12, K2 1, K3 11 launches per int8 frame: {per_frame[:3]}")
    steps = rts["int8_static"].estimator.step
    for t, c in maps["int8_static"]:
        require(np.isfinite(t).all() and np.isfinite(c).all() and t.min() >= 0 and t.max() <= 1 and c.min() >= 0
                and c.max() <= 1, "the int8 runtime's maps finite, in [0, 1]")
    trav_vs = [float(np.abs(a[0] - b[0]).mean()) for a, b in zip(maps["int8_static"], maps["bf16"])]
    conf_vs = [float(np.abs(a[1] - b[1]).mean()) for a, b in zip(maps["int8_static"], maps["bf16"])]
    print(f"[quant] (a) WVNRuntime(dino_quant=int8_static) at the product's settings (ViT-S/8 at 224, SLIC 100, per "
          f"pixel, buffer 256, fan-out 32), calibrated on the first 2 demo frames (48 scales, amax "
          f"{min(amax):.3f} to {max(amax):.3f}), replaying {n_frames} frames + {len(sequence.states)} robot states "
          f"in turns with the bf16 runtime on the same weights: K1 12, K2 1, K3 11 per frame; over the replay "
          f"{quant_launches} ({steps} train steps, K4 {quant_launches['fill_hulls']} "
          f"flushes); against bf16 the trav mean abs diff per frame {np.mean(trav_vs):.3e} mean, {max(trav_vs):.3e} "
          f"max; conf {np.mean(conf_vs):.3e} mean, {max(conf_vs):.3e} max (heads trained apart) | {card}", flush=True)
    require(quant_launches["fill_hulls"] > 0 and steps > 0, "the int8 replay flushed supervision and trained")

    # the CPU twin: the same int8_static runtime on the CPU over the mission's first frames
    first = Sequence(frames=sequence.frames[:QUANT_CPU_FRAMES],
                     states=[s for s in sequence.states if s.stamp <= sequence.frames[QUANT_CPU_FRAMES - 1].stamp])
    cpu = product("cpu", "int8_static")
    cpu.calibrate_backbone(cal)
    cpu_maps = [tuple(t.float().numpy() for t in (r.traversability, r.confidence))
                for r in (drive(cpu, kind, p) for _, kind, p in first.events()) if r is not None]
    card_maps = maps["int8_static"][:QUANT_CPU_FRAMES]
    t_mean = max(float(np.abs(a[0] - b[0]).mean()) for a, b in zip(card_maps, cpu_maps))
    t_max = max(float(np.abs(a[0] - b[0]).max()) for a, b in zip(card_maps, cpu_maps))
    c_mean = max(float(np.abs(a[1] - b[1]).mean()) for a, b in zip(card_maps, cpu_maps))
    print(f"[quant] (a) against the CPU twin (int8_static, same weights and calibration frames) over the first "
          f"{len(cpu_maps)} frames: trav mean abs diff up to {t_mean:.3e} (tol {QUANT_CPU_TOL['trav_mean']}), max "
          f"{t_max:.3e} (tol {QUANT_CPU_TOL['trav_max']}), conf mean abs diff up to {c_mean:.3e} (tol "
          f"{QUANT_CPU_TOL['conf_mean']})", flush=True)
    require(len(cpu_maps) == QUANT_CPU_FRAMES and t_mean <= QUANT_CPU_TOL["trav_mean"]
            and t_max <= QUANT_CPU_TOL["trav_max"] and c_mean <= QUANT_CPU_TOL["conf_mean"],
            "the int8 runtime agrees with its CPU twin")
    del cpu
    demo = np.stack([f.image for f in sequence.frames])
    prof = {}
    for name in ["int8_static", "bf16", "bf16", "int8_static"]:
        rt = rts[name]
        head, cg = rt.inference_head
        frames = [(torch.from_numpy(demo[i : i + 1]).to(dev),) for i in range(10)]
        prof.setdefault(name, []).append(profile_ops(lambda x: rt._fused_frame(cg, x, head), frames))
    for name in rts:
        p = prof[name]
        split = int8_split(p[0])
        print(f"[quant] (a) {name} frame B=1 (image_callback's fused frame, 10 demo frames under the profiler, twice "
              f"in turns): host {[round(x['wall_ms'], 3) for x in p]} ms, device "
              f"{[round(x['device_ms'], 4) for x in p]}"
              f" ms per frame, {p[0]['launches']:.0f} launches per frame, busy share {p[0]['busy']:.3f}; device ms "
              f"per frame: int8 products {split['int_mm']:.4f}, K1 {split['K1']:.4f}, fp products "
              f"{split['fp_mm']:.4f}, the rest {split['rest']:.4f}; image_callback host median "
              f"{statistics.median(host[name]):.3f} ms over the replay | {card}", flush=True)
        print(f"[quant] (a) {name} top operators (device ms per frame): "
              + ", ".join(f"{op} {ms:.4f}" for op, ms in list(p[0]["ops"].items())[:10]))
    del rts, prof

    # (b) BASELINE config 5 on one card: DINOv2 ViT-B/14 at 644, 4 cameras, grid, patch-resolution scoring
    t0 = time.perf_counter()
    size, B = 644, 4
    cams = {f"cam{i}": {"use_for_training": True, "scheduler_weight": 1} for i in range(B)}
    weights = make_vit("dinov2", "vit_base", 14, dtype=torch.float32, device="cpu",
                       generator=torch.Generator().manual_seed(0)).state_dict()
    # layerscale 1, as JAX's int8 band tests set it: at its 1e-5 init every block is near the identity and any
    # quantisation error vanishes from the features (trained DINOv2 gammas are of order 0.1 to 1)
    weights = {k: torch.ones_like(v) if k.endswith(".gamma") else v for k, v in weights.items()}

    def config5(dino_quant):
        fe5 = FeatureExtractorNodeParams(network_input_image_height=size, network_input_image_width=size,
                                         segmentation_type="grid", feature_type="dinov2", dino_backbone="vit_base",
                                         dino_patch_size=14, dino_quant=dino_quant, grid_cell_size=size // 10,
                                         prediction_per_pixel=True, image_callback_rate=1e6, camera_topics=cams)
        ln5 = LearningNodeParams(network_input_image_height=size, network_input_image_width=size,
                                 supervision_callback_rate=1e6, learning_thread_rate=1e6, image_graph_dist_thr=0.05,
                                 supervision_graph_dist_thr=0.05, min_samples_for_training=4, camera_topics=cams,
                                 traversability_radius=3.0)
        return WVNRuntime(fe_params=fe5, ln_params=ln5, exp_params=ExperimentParams(), buffer_capacity=64,
                          reprojection_fanout=32, score_at_patch_res=True, backbone_params=weights, device=dev)

    modes = ("int8_static", "int8", "bf16")
    rt5 = {m: config5(None if m == "bf16" else m) for m in modes}
    rng = np.random.RandomState(0)
    pool = [torch.from_numpy(rng.rand(B, 3, size, size).astype(np.float32)).to(dev) for _ in range(4)]
    require(rt5["int8_static"].calibrate_backbone(pool[:2]), "config 5 calibrated")
    K = np.tile(np.array([[400.0, 0, size / 2], [0, 400.0, size / 2], [0, 0, 1]]), (B, 1, 1))
    down = np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1]], np.float64)

    def call(rt, i):
        pb, pc = np.tile(np.eye(4), (B, 1, 1)), np.tile(np.eye(4), (B, 1, 1))
        pb[:, 0, 3], pb[:, 2, 3], pb[:, :3, :3], pc[:, 0, 3] = i * 0.11, 1.5, down, 0.05 * np.arange(B)
        return rt.image_batch_callback(pool[i % len(pool)], [i + 0.001 * c for c in range(B)], list(cams), K, size,
                                       size, pb, pc)

    lat = {m: [] for m in modes}
    for i in range(WARMUP + 10):
        for m in (modes if i % 2 == 0 else modes[::-1]):
            t1 = time.perf_counter()
            res = call(rt5[m], i)
            torch.cuda.synchronize()
            if i >= WARMUP:
                lat[m].append((time.perf_counter() - t1) * 1e3)
            require(all(bool(torch.isfinite(r.traversability).all()) for r in res), f"config 5 {m}: finite maps")
    profs = {m: profile_ops(lambda i: call(rt5[m], i), [(100 + i,) for i in range(3)]) for m in modes}
    x = imagenet_normalize(pool[3])
    with torch.no_grad():
        feats = {m: dense_features(rt5[m].feature_extractor._extractor.vit, x).float() for m in modes}
    ref = feats["bf16"]
    for m in modes:
        p, split = profs[m], int8_split(profs[m])
        cos = torch.nn.functional.cosine_similarity(feats[m], ref, dim=1)
        rel = float((feats[m] - ref).norm() / ref.norm())
        print(f"[quant] (b) BASELINE config 5 {m}: image_batch_callback B=4 (DINOv2 ViT-B/14 at 644, 2117 tokens, "
              f"grid 64 px, patch-resolution scoring) host median {statistics.median(lat[m]):.3f} ms "
              f"({statistics.median(lat[m]) / B:.3f} ms per frame, {len(lat[m])} calls in turns); under the profiler "
              f"device {p['device_ms']:.3f} ms per call ({p['launches']:.0f} launches, busy {p['busy']:.3f}): int8 "
              f"products {split['int_mm']:.3f}, K1 {split['K1']:.3f}, fp products {split['fp_mm']:.3f}, the rest "
              f"{split['rest']:.3f} ms; features against bf16: cosine min {float(cos.min()):.5f} mean "
              f"{float(cos.mean()):.5f}, relative L2 {rel:.3e} | {card}", flush=True)
        print(f"[quant] (b) {m} top operators (device ms per call): "
              + ", ".join(f"{op} {ms:.4f}" for op, ms in list(p["ops"].items())[:10]))
        require(bool(torch.isfinite(feats[m]).all()) and rel < QUANT_FEAT_REL, f"config 5 {m}: features near bf16's")
    del rt5, feats
    print(f"[quant] (b) done in {time.perf_counter() - t0:.1f} s", flush=True)

    # (c) torch._int_mm's shape rules at every Linear, exact against an fp64 product; attention_scores_int8
    g = torch.Generator(device=dev).manual_seed(3)
    checked = []
    for what, shapes in INT_MM_SHAPES.items():
        for M, Kd, N in shapes:
            a = torch.randint(-127, 128, (M, Kd), device=dev, dtype=torch.int8, generator=g)
            b = torch.randint(-127, 128, (Kd, N), device=dev, dtype=torch.int8, generator=g)
            exact = torch.equal(torch._int_mm(a, b).double(), a.double() @ b.double())
            require(exact and torch.equal(quant.int_mm(a, b), torch._int_mm(a, b)), f"_int_mm exact at {(M, Kd, N)}")
            checked.append((what, M, Kd, N))
            # the right operand's layout: row-major as given, column-major as int_mm hands it over; bf16's GEMM
            wt, ab, bb = b.t().contiguous(), a.bfloat16(), b.t().contiguous().bfloat16()
            row = device_ms(lambda: torch._int_mm(a, b), [()] * (WARMUP + N_TIMED))
            col = device_ms(lambda: torch._int_mm(a, wt.t()), [()] * (WARMUP + N_TIMED))
            bf = device_ms(lambda: torch.nn.functional.linear(ab, bb), [()] * (WARMUP + N_TIMED))
            print(f"[quant] (c) {what} ({M}, {Kd}, {N}): _int_mm with the right operand row-major {row:.4f} ms, "
                  f"column-major {col:.4f} ms; the bf16 linear {bf:.4f} ms | {card}")
    refused = []
    a = torch.randint(-127, 128, (16, 384), device=dev, dtype=torch.int8, generator=g)
    b = torch.randint(-127, 128, (384, 64), device=dev, dtype=torch.int8, generator=g)
    a64 = torch.randint(-127, 128, (785, 64), device=dev, dtype=torch.int8, generator=g)
    b64 = torch.randint(-127, 128, (64, 800), device=dev, dtype=torch.int8, generator=g)
    probes = {"16 rows": (a, b), "inner 380": (a[:, :380], b[:380]), "60 columns": (a, b[:, :60]),
              "inner 64 with a row-major right operand": (a64, b64)}
    for name, (x1, x2) in probes.items():
        try:
            torch._int_mm(x1.contiguous(), x2.contiguous())
        except RuntimeError:
            refused.append(name)
        padded = quant.int_mm(x1, x2)
        require(torch.equal(padded.double(), x1.double() @ x2.double()), f"int_mm pads {name} exactly")
    q, k, v = (torch.randn(1, 6, 785, 64, device=dev, generator=g) for _ in range(3))
    got = quant.attention_scores_int8(q, k, v, 0.125)
    want = xla_attention(q, k, v, 0.125)
    rel = float((got - want).norm() / want.norm())
    print(f"[quant] (c) torch._int_mm exact (against an fp64 product) at every Linear of {list(INT_MM_SHAPES)}: "
          f"{len(checked)} shapes; refused by the raw call with contiguous operands: {refused} (of {list(probes)}), "
          f"each exact through int_mm (zero padding, the right operand column-major); attention_scores_int8 at "
          f"(1, 6, 785, 64) against fp32 attention: "
          f"relative L2 {rel:.3e} (JAX's band {QUANT_ATTN_REL})", flush=True)
    require(rel < QUANT_ATTN_REL, "attention_scores_int8 within JAX's band")
    print(f"[quant] phase done in {time.perf_counter() - t_phase:.1f} s", flush=True)
    return quant_launches


PORT_MODEL_CODE = ("wild_visual_navigation_tpu_torch.models", "wild_visual_navigation_tpu_torch.tools")
ENGINE_BF16_ATOL = 6e-3  # the compiled bf16 engine against eager: traversability per patch (the CPU tests' bf16 band)
ENGINE_INT8_TOL = {"trav_mean": 2e-2, "trav_max": 2e-1}  # the compiled int8_static engine against eager
# kernels that would be a library's attention: named so, and not one of Inductor's pointwise or reduction kernels,
# which are named after the graph operators they read or write (K1's operator among them)
ATTENTION_NAMES = ("flash", "fmha", "sdpa", "attention", "efficient")
INDUCTOR_ELEMENTWISE = ("triton_poi_", "triton_per_", "triton_red_")


def _kernel_names(fn) -> set:
    """The names of the CUDA kernels one call of fn() runs (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key for e in prof.key_averages() if e.device_time_total > 0}


def engine_child(x_path: str, *specs_and_outs: str) -> int:
    """The fresh process of phase 4k: for each (spec, out) pair, load the
    compiled engine (no model code), call it once counting launches and
    the kernels it runs, time it, refuse another shape; report what the
    process built or compiled while loading and calling (the kernel
    library's builds, the subprocesses it started, the files Inductor's
    cache directory, empty before, holds after). One JSON line, a list with
    an entry per engine."""
    import os

    import torch

    spawned = []
    popen = subprocess.Popen.__init__
    subprocess.Popen.__init__ = lambda self, *a, **kw: spawned.append(str(a[:1])[:200]) or popen(self, *a, **kw)

    import wild_visual_navigation_tpu_torch as port
    from wild_visual_navigation_tpu_torch.feature_extractor.aot_engine import load_engine, load_engine_spec
    from wild_visual_navigation_tpu_torch.ops import _cuda
    from wild_visual_navigation_tpu_torch.ops.flash_attention import flash_attention

    x = torch.from_numpy(np.load(x_path)).cuda()
    q = torch.randn(1, 6, 257, 64, device="cuda").bfloat16()
    k1_names = _kernel_names(lambda: flash_attention(q, q, q, 0.125))
    report = []
    for spec, out_path in zip(specs_and_outs[::2], specs_and_outs[1::2]):
        t0 = time.perf_counter()
        engine = load_engine(spec)
        load_s = time.perf_counter() - t0
        _, shape, _, meta = load_engine_spec(spec)
        engine(x)
        torch.cuda.synchronize()
        port.reset_launch_counts()
        out = engine(x)
        torch.cuda.synchronize()
        launches = port.launch_counts()
        np.save(out_path, out.cpu().numpy())
        names = _kernel_names(lambda: engine(x))
        try:
            engine(torch.zeros(shape[0], 3, shape[2] + 14, shape[3] + 14, device="cuda"))
            refused = ""
        except ValueError as e:
            refused = str(e)
        report.append({"load_s": load_s, "launches": launches, "ms": wall_ms(engine, [(x,)] * (WARMUP + 10)),
                       "flops": engine.flops, "memory": engine.memory_analysis(), "refused": refused, "meta": meta,
                       "kernels": len(names), "k1_kernels": sorted(names & k1_names),
                       "attention_kernels": sorted(n for n in names - k1_names
                                                   if any(a in n.lower() for a in ATTENTION_NAMES)
                                                   and not n.startswith(INDUCTOR_ELEMENTWISE)),
                       "inductor_kernels": sum(n.startswith("triton_") for n in names)})
    cache = [f for _, _, fs in os.walk(os.environ["TORCHINDUCTOR_CACHE_DIR"]) for f in fs]
    for r in report:
        r.update(models_imported=sorted(m for m in sys.modules if m.startswith(PORT_MODEL_CODE)),
                 kernel_builds=_cuda.builds, spawned=spawned, inductor_cache=cache)
    print(json.dumps(report))
    return 0


def engine_phase(dev, card: str) -> dict:
    """Phase 4k [engine]: `python -m ...tools.export_engine` at its defaults
    (DINOv2 ViT-S/14 at 224, B = 1, bf16) in a subprocess, an int8_static
    engine built and compiled here through the API; both loaded in one
    fresh process that builds and compiles nothing, each launching K1 12
    times per call and no library attention, held to the eager pipeline
    (bf16 within ENGINE_BF16_ATOL, int8_static within ENGINE_INT8_TOL),
    refusing another shape, its operations within 1 % of the analytic
    count. Then each engine's host time per call in turns with its eager
    pipeline and its exported program, and K1's operator against the
    direct launch, per call and in the frame. Returns the engine's
    launches."""
    import os
    import tempfile

    import torch

    import wild_visual_navigation_tpu_torch.models.vit as vit_mod
    from wild_visual_navigation_tpu_torch.feature_extractor.aot_engine import (
        load_engine,
        load_engine_spec,
        program_path,
        save_engine_spec,
    )
    from wild_visual_navigation_tpu_torch.models.vit import calibrate_int8_static
    from wild_visual_navigation_tpu_torch.ops import flash_attention as k1_mod
    from wild_visual_navigation_tpu_torch.tools.export_engine import build_pipeline, export_pipeline, pipeline_flops

    t_phase = time.perf_counter()
    rng = np.random.default_rng(5)
    x = rng.random((1, 3, 224, 224), dtype=np.float32)
    xd = torch.from_numpy(x).to(dev)
    results = {}
    with tempfile.TemporaryDirectory() as d:
        np.save(f"{d}/x.npy", x)
        # the tool in its process while this one builds, calibrates, exports, compiles and saves the int8_static one
        spec, spec8 = f"{d}/engines/engine.spec", f"{d}/engine_int8_static.spec"
        t0 = time.perf_counter()
        tool = subprocess.Popen([sys.executable, "-m", "wild_visual_navigation_tpu_torch.tools.export_engine", "--out",
                                 spec], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=str(ROOT))
        pipe8 = build_pipeline(device=dev, quant="int8_static")
        calibrate_int8_static(pipe8.vit, [torch.from_numpy(rng.random((2, 3, 224, 224), dtype=np.float32)).to(dev)
                                          for _ in range(2)])
        eng8 = export_pipeline(pipe8, 224, 1)
        n_int_mm = sum(n.target is torch.ops.aten._int_mm.default for n in eng8.program.graph.nodes)
        save_engine_spec(spec8, {"vit": pipe8.vit.state_dict(), "head": pipe8.head.state_dict()}, eng8.input_shape,
                         str(eng8.input_dtype), {"quant": "int8_static"}, engine=eng8)
        tool_out, tool_err = tool.communicate(timeout=900)
        tool_s = time.perf_counter() - t0
        require(tool.returncode == 0, f"tools.export_engine at its defaults: {tool_err[-2000:]}")
        print(f"[engine] tools.export_engine at its defaults ({tool_s:.1f} s in its process, beside this one's int8 "
              f"engine): " + " | ".join(tool_out.strip().splitlines()), flush=True)
        require(n_int_mm == 48, f"the int8 program holds 48 _int_mm nodes ({n_int_mm})")
        # both engines loaded in one fresh process, with an empty Inductor cache and the kernel library's build
        cache = f"{d}/inductor_cache"
        os.makedirs(cache)
        out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--engine-child", f"{d}/x.npy", spec,
                              f"{d}/bf16.npy", spec8, f"{d}/int8.npy"], capture_output=True, text=True,
                             cwd=str(ROOT), timeout=300, env={**os.environ, "TORCHINDUCTOR_CACHE_DIR": cache})
        require(out.returncode == 0, f"the engines load in a fresh process: {out.stderr[-2000:]}")
        info, info8 = json.loads(out.stdout.strip().splitlines()[-1])
        params, *_ = load_engine_spec(spec)
        pipe = build_pipeline(device=dev)
        pipe.vit.load_state_dict(params["vit"])
        pipe.head.load_state_dict(params["head"])
        engines = {"bf16": (pipe, load_engine(spec), info, np.load(f"{d}/bf16.npy"),
                            float(tool_out.split("compiled in ")[1].split("s")[0]), os.path.getsize(program_path(spec))),
                   "int8_static": (pipe8, eng8, info8, np.load(f"{d}/int8.npy"), eng8.compile_seconds,
                                   os.path.getsize(program_path(spec8)))}
        for tag, (p, eng, inf, got, compile_s, nbytes) in engines.items():
            with torch.no_grad():
                eager = p(xd).cpu().numpy()
                program = torch.export.export(p, (xd,)).module() if eng.program is None else eng.program.module()
            diff = np.abs(got - eager)
            analytic = pipeline_flops(p, 224, 1)
            flops_rel = inf["flops"] / analytic - 1
            times: dict = {}
            for name in ["engine", "program", "eager", "eager", "program", "engine"]:
                fn = {"engine": eng, "program": program, "eager": p}[name]
                with torch.no_grad():
                    times.setdefault(name, []).append(wall_ms(fn, [(xd,)] * (WARMUP + 20)))
            print(f"[engine] {tag}: exported and compiled in {compile_s:.1f} s, package {nbytes} bytes; loaded in a "
                  f"fresh process in {inf['load_s']:.3f} s (model modules imported there: {inf['models_imported']}; "
                  f"kernel library builds {inf['kernel_builds']}, subprocesses {inf['spawned']}, files in the empty "
                  f"Inductor cache {inf['inductor_cache']}); one call: launches {inf['launches']}, {inf['kernels']} "
                  f"kernels ({inf['inductor_kernels']} Inductor's Triton kernels), K1's {inf['k1_kernels']}, library "
                  f"attention {inf['attention_kernels']}; output {got.shape} "
                  f"against eager: max abs diff {diff.max():.3e}, mean {diff.mean():.3e}; another shape refused: "
                  f"{inf['refused']!r}; flops {inf['flops']} against the analytic {analytic} ({flops_rel:+.4%}); "
                  f"memory {inf['memory']}; host per call {inf['ms']:.3f} ms in the fresh process | {card}", flush=True)
            print(f"[time] {tag} engine, host ms per call B=1 at 224 in turns (engine, program, eager, eager, program, "
                  f"engine), median of 20: compiled engine {[round(t, 3) for t in times['engine']]}, the exported "
                  f"program run node by node {[round(t, 3) for t in times['program']]}, the eager pipeline "
                  f"{[round(t, 3) for t in times['eager']]} | {card}", flush=True)
            if tag == "bf16":
                require(diff.max() <= ENGINE_BF16_ATOL, f"{tag}: the compiled engine within the bf16 band of eager")
            else:
                require(diff.mean() <= ENGINE_INT8_TOL["trav_mean"] and diff.max() <= ENGINE_INT8_TOL["trav_max"],
                        f"{tag}: the compiled engine within the int8 band of eager")
            require(inf["refused"].startswith("AOTEngine expects (1, 3, 224, 224)"), f"{tag}: another shape refused")
            require(abs(flops_rel) < 0.01, f"{tag}: flops within 1 % of the analytic count")
            require(inf["launches"]["flash_attention"] == 12 and inf["k1_kernels"], f"{tag}: K1 12 launches per call")
            require(not inf["attention_kernels"], f"{tag}: no library attention kernel in a call")
            require(inf["kernel_builds"] == 0 and not inf["spawned"] and not inf["inductor_cache"],
                    f"{tag}: loading built and compiled nothing")
            require(inf["memory"] is not None and inf["memory"]["peak_bytes"] > 0, f"{tag}: memory analysis")
            results.setdefault("times", {})[tag] = times
            if tag == "bf16":
                results["engine_launches"] = inf["launches"]

    # K1's operator against the direct launch: per call on the host clock, and in the frame
    g = torch.Generator(device=dev).manual_seed(9)
    for shape in ((1, 6, 785, 64), (1, 6, 257, 64)):
        q, k, v = (torch.randn(shape, device=dev, generator=g).bfloat16() for _ in range(3))
        require(torch.equal(k1_mod.flash_attention_op(q, k, v, 0.125), k1_mod.flash_attention(q, k, v, 0.125)),
                f"the operator equals the direct launch at {shape}")
        per = {}
        for name in ["op", "direct", "direct", "op"]:
            fn = k1_mod.flash_attention_op if name == "op" else k1_mod.flash_attention
            for _ in range(50):
                fn(q, k, v, 0.125)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(300):
                fn(q, k, v, 0.125)
            host_us = (time.perf_counter() - t0) / 300 * 1e6
            torch.cuda.synchronize()
            per.setdefault(name, []).append(host_us)
        print(f"[engine] K1 at {shape} bf16, host time per call (enqueue, 300 calls, in turns): through the operator "
              f"wvn::flash_attention {[round(t, 2) for t in per['op']]} us, the direct launch "
              f"{[round(t, 2) for t in per['direct']]} us; overhead {np.mean(per['op']) - np.mean(per['direct']):.2f} "
              f"us per call, {12 * (np.mean(per['op']) - np.mean(per['direct'])) / 1e3:.4f} ms over a frame's 12 "
              f"| {card}", flush=True)
        results.setdefault("op_overhead_us", {})["x".join(map(str, shape))] = \
            float(np.mean(per["op"]) - np.mean(per["direct"]))
    from wild_visual_navigation_tpu_torch.feature_extractor.dino import DinoInterface
    from wild_visual_navigation_tpu_torch.models.registry import get_model
    from wild_visual_navigation_tpu_torch.runtime.fused import build_fused_frame_fn
    from wild_visual_navigation_tpu_torch.utils.confidence_generator import ConfidenceConfig, confidence_init

    dino = DinoInterface(backbone="dino", input_size=224, backbone_type="vit_small", patch_size=8, device=dev, seed=0)
    mlp = get_model({"name": "SimpleMLP", "simple_mlp_cfg": {"input_size": 384, "hidden_sizes": [256, 32, 1],
                                                             "reconstruction": True}}, device=dev).eval()
    frame = build_fused_frame_fn(dino.vit, mlp, ConfidenceConfig(), 224, num_segments=100)
    cg = confidence_init(dev)
    imgs = [(cg, torch.from_numpy(rng.random((1, 3, 64, 64), dtype=np.float32)).to(dev)) for _ in range(WARMUP + 15)]
    frame_ms = {}
    through_op = lambda q, k, v, s=1.0: k1_mod.flash_attention_op(q, k, v, float(s))  # noqa: E731
    for name in ["op", "direct", "direct", "op"]:
        vit_mod.flash_attention = through_op if name == "op" else k1_mod.flash_attention
        with torch.no_grad():
            frame_ms.setdefault(name, []).append(wall_ms(frame, imgs))
    vit_mod.flash_attention = k1_mod.flash_attention
    print(f"[engine] the frame B=1 (ViT-S/8 at 224, SLIC 100, per pixel) on the host clock, in turns: K1 through the "
          f"operator (the engine's route) {[round(t, 3) for t in frame_ms['op']]} ms, through the direct launch "
          f"{[round(t, 3) for t in frame_ms['direct']]} ms | {card}", flush=True)
    results["frame_ms"] = frame_ms
    print(f"[engine] phase done in {time.perf_counter() - t_phase:.1f} s", flush=True)
    return results


# The K1 variants the [switches] phase holds and times: every tile at the ViT shapes, and every head dim (the
# instantiated ones and two between them, zero-padded) at ViT-S/8's (1, 6, 785) with each tile it takes.
SWITCH_TILE_SHAPES = {(1, 6, 785, 64): "ViT-S/8 at 224, the main path", (1, 12, 3137, 64): "ViT-B/8 at 448",
                      (4, 12, 2117, 64): "ViT-B/14 at 644, config 5's 4 cameras", (1, 12, 2117, 64): "ViT-B/14 at 644"}
SWITCH_HEAD_DIMS = (32, 80, 128, 200, 256)
SWITCH_BENCH_SIZE = 448  # bench.py's SIZE: DINOv2 ViT-S/14, 1025 tokens
SWITCH_BF16_MAE = 2e-2  # a bf16 ViT against its CPU twin (tests/test_torch_port_attention_vit.py's bf16 limit)
SWITCH_INT8_REL = 0.04  # an int8 ViT against its CPU twin, relative mean (tests/test_torch_port_quant.py's)


def variant_source(name: str) -> str:
    """The source file of a K1 variant named as ops/flash_attention.py::
    variant_name names it ("flash_attention bf16 d128 64x64 ...")."""
    D = int(re.search(r" d(\d+)", name).group(1))
    return "flash_attention.cu" if D == 64 else f"flash_attention_d{D}.cu"


def switches_phase(dev, card: str, g) -> dict:
    """Phase 4l [switches]: the JAX package's implementation switches on the
    card. (a) This slice's path, with the launch counts set to 0 just
    before it and read just after: bench.py's backbone profile (DINOv2
    ViT-S/14 at 448, attention "flash", ln_dtype bf16, bf16 and int8_static
    calibrated on 2 batches) through build_fused_batch_fn on 2 frames
    against its CPU twin; the same ViT as "flash:<bq>:<bk>" for each other
    tile; "auto" at the main path's (1, 6, 785) (resolves "xla_bf16": no K1)
    and config 5's (4, 12, 2117) (resolves "flash": 12 K1 launches); and
    flash_attention at each head dim of SWITCH_HEAD_DIMS with each tile it
    takes. (b) Each variant against the plain version at bf16_atol (the
    plain version without the last kv tile fails it), timed beside the
    plain version and SDPA, with its bound. Returns the kernels line's
    entries for the variants."""
    import torch

    import wild_visual_navigation_tpu_torch as port
    from wild_visual_navigation_tpu_torch.models import vit as tvit
    from wild_visual_navigation_tpu_torch.models.registry import get_model
    from wild_visual_navigation_tpu_torch.ops.flash_attention import (
        TILES,
        bf16_atol,
        flash_attention,
        padded_head_dim,
        variant_name,
        xla_attention,
    )
    from wild_visual_navigation_tpu_torch.ops.resize import imagenet_normalize
    from wild_visual_navigation_tpu_torch.runtime.fused import build_fused_batch_fn

    t_phase = time.perf_counter()
    rng = np.random.default_rng(13)
    size = SWITCH_BENCH_SIZE
    frames = torch.from_numpy(rng.random((2, 3, size, size), dtype=np.float32))
    cal = [torch.from_numpy(rng.random((2, 3, size, size), dtype=np.float32)) for _ in range(2)]
    mlp = get_model({"name": "SimpleMLP", "simple_mlp_cfg": {"input_size": 384, "hidden_sizes": [256, 32, 1],
                                                             "reconstruction": True}},
                    generator=torch.Generator().manual_seed(1))
    mlp.eval().requires_grad_(False)
    mlp_dev = get_model({"name": "SimpleMLP", "simple_mlp_cfg": {"input_size": 384, "hidden_sizes": [256, 32, 1],
                                                                 "reconstruction": True}}, device=dev)
    mlp_dev.load_state_dict(mlp.state_dict())
    mlp_dev.eval().requires_grad_(False)
    # seeded weights with the layer scales at 1, as the reference's int8 band test sets them: at DINOv2's 1e-5 the
    # blocks would add next to nothing to the tokens, and any two ViTs would agree
    weights = {k: torch.ones_like(v) if k.endswith(".gamma") else v for k, v in tvit.make_vit(
        "dinov2", "vit_small", 14, generator=torch.Generator().manual_seed(0), device="cpu").state_dict().items()}

    def vit(impl, quant=None, device=dev):
        return tvit.make_vit("dinov2", "vit_small", 14, attention_impl=impl, ln_dtype=torch.bfloat16, quant=quant,
                             device=device, state_dict=weights).eval().requires_grad_(False)

    torch.cuda.synchronize()
    port.reset_launch_counts()
    # (a) bench.py's backbone profile, bf16 and int8_static, against the CPU twins (one CPU forward each: the twin's
    # traversability is build_fused_batch_fn's head on the twin's features)
    profile = {}
    x_cpu = imagenet_normalize(frames)
    for quant in (None, "int8_static"):
        card_vit = vit("flash", quant)
        if quant:
            tvit.calibrate_int8_static(card_vit, [imagenet_normalize(c.to(dev)) for c in cal])
        cpu_vit = tvit.make_vit("dinov2", "vit_small", 14, ln_dtype=torch.bfloat16, quant=quant, device="cpu",
                                state_dict={k: v.cpu() for k, v in card_vit.state_dict().items()})
        before = flash_attention.launches
        with torch.no_grad():
            got = tvit.dense_features(card_vit, imagenet_normalize(frames.to(dev))).cpu()
            want = tvit.dense_features(cpu_vit, x_cpu)
            trav_cpu = mlp(want.permute(0, 2, 3, 1).reshape(-1, 384))[:, 0].reshape(want.shape[0], *want.shape[2:])
        trav = build_fused_batch_fn(card_vit, mlp_dev)(frames.to(dev)).cpu()
        launched = flash_attention.launches - before
        err = float((got - want).abs().mean())
        rel = err / float(want.std())
        t_err = float((trav - trav_cpu).abs().max())
        name = quant or "bf16"
        profile[name] = {"mae": err, "rel": rel, "trav_max": t_err, "k1": launched, "vit": card_vit}
        ok = (err <= SWITCH_BF16_MAE) if quant is None else (rel <= SWITCH_INT8_REL)
        print(f"[switches] (a) bench.py's backbone (DINOv2 ViT-S/14 at {size}, flash, ln_dtype bf16, {name}, layer "
              f"scales 1) on 2 frames: features {tuple(got.shape)} against the CPU twin mean abs diff {err:.3e} "
              f"(relative {rel:.3e}; limit "
              f"{'mean ' + str(SWITCH_BF16_MAE) if quant is None else 'relative ' + str(SWITCH_INT8_REL)}), "
              f"build_fused_batch_fn's per-patch traversability max abs diff {t_err:.3e} (tol 5e-2); K1 launches "
              f"{launched} (24: 12 per forward)", flush=True)
        require(ok and t_err <= 5e-2 and bool(torch.isfinite(got).all()) and launched == 24,
                f"bench.py's backbone profile ({name}) on the card against its CPU twin")
        if quant is None:
            ref_feats = got
    # the other tiles through the ViT's own names
    for bq, bk in TILES[64][1:]:
        card_vit = vit(f"flash:{bq}:{bk}")
        before = dict(flash_attention.variant_launches)
        with torch.no_grad():
            got = tvit.dense_features(card_vit, imagenet_normalize(frames.to(dev))).cpu()
        launched = {k: v - before.get(k, 0) for k, v in flash_attention.variant_launches.items()
                    if v != before.get(k, 0)}
        err = float((got - ref_feats).abs().mean())
        print(f"[switches] (a) the same ViT as flash:{bq}:{bk}: K1 launches {launched}; features against the (64, 64) "
              f"tile's mean abs diff {err:.3e} (limit {SWITCH_BF16_MAE})", flush=True)
        require(launched == {f"bf16 d64 {bq}x{bk}": 12} and err <= SWITCH_BF16_MAE,
                f"flash:{bq}:{bk} runs K1 at its tile")
    # "auto" at the main path's and config 5's shapes
    for name, (backbone, typ, ps, B, px, want_impl) in {
            "main path": ("dino", "vit_small", 8, 1, 224, "xla_bf16"),
            "config 5": ("dinov2", "vit_base", 14, 4, 644, "flash")}.items():
        auto = tvit.make_vit(backbone, typ, ps, attention_impl="auto", device=dev,
                             generator=torch.Generator().manual_seed(2)).eval().requires_grad_(False)
        tvit._AUTO_RESOLVED_LOGGED.clear()
        before = flash_attention.launches
        with torch.no_grad():
            out = auto(torch.rand(B, 3, px, px, device=dev, generator=g))["patch_tokens"]
        torch.cuda.synchronize()
        resolved = sorted(tvit._AUTO_RESOLVED_LOGGED)
        H = auto.cfg.num_heads
        N = (px // ps) ** 2 + 1
        print(f"[switches] (a) auto at the {name}'s (B={B}, heads={H}, S={N}): resolved {resolved} -> {want_impl}; "
              f"K1 launches {flash_attention.launches - before}", flush=True)
        require(resolved == [(B, H, N)] and tvit.resolve_auto(B, H, N) == want_impl
                and flash_attention.launches - before == (12 if want_impl == "flash" else 0)
                and bool(torch.isfinite(out).all()), f"auto at the {name}'s shape")
    # every head dim with each tile it takes, through flash_attention
    dim_cases = [(D, t) for D in SWITCH_HEAD_DIMS for t in TILES[padded_head_dim(D)]]
    dim_inputs = {}
    for D, tile in dim_cases:
        q, k, v = dim_inputs.setdefault(D, tuple(torch.randn(1, 6, 785, D, device=dev, generator=g).bfloat16()
                                                 for _ in range(3)))
        flash_attention(q, k, v, D**-0.5, *tile)
    torch.cuda.synchronize()
    path_launches = dict(flash_attention.variant_launches)
    print(f"[switches] (a) launches of this slice's path by K1 variant: {path_launches}", flush=True)

    # (b) the backbone's host time, then each variant against the plain version, timed
    for name, p in profile.items():
        p["host_ms"] = wall_ms(build_fused_batch_fn(p.pop("vit"), mlp_dev), [(frames.to(dev),)] * (WARMUP + N_TIMED))
        print(f"[time] bench.py's backbone ({name}) through build_fused_batch_fn, B=2 at {size}: {p['host_ms']:.3f} ms "
              f"per call on the host clock | {card}", flush=True)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    timed = []
    for shape in SWITCH_TILE_SHAPES:
        for tile in TILES[64]:
            timed.append((shape, tile))
    for D, tile in dim_cases:
        timed.append(((1, 6, 785, D), tile))
    variants = {}
    for shape, tile in timed:
        B, H, S, D = shape
        q, k, v = (torch.randn(shape, device=dev, generator=g).bfloat16() for _ in range(3))
        scale = D**-0.5
        ref = xla_attention(q, k, v, scale).float()
        err, tol, tail = k1_bf16_check(flash_attention(q, k, v, scale, *tile), ref, q, k, v,
                                       lambda *a: xla_attention(*a[:3], scale), bf16_atol)
        require(err <= tol < tail, f"K1 {variant_name(D, torch.bfloat16, *tile)} at {shape}")
        qkvs = [tuple(torch.randn(shape, device=dev, generator=g).bfloat16() for _ in range(3))
                for _ in range(WARMUP + N_TIMED)]
        k_ms = device_ms(lambda q, k, v: flash_attention(q, k, v, scale, *tile), qkvs)
        p_ms = device_ms(lambda q, k, v: xla_attention(q, k, v, scale), qkvs)
        s_ms = device_ms(lambda q, k, v: sdpa(q, k, v, scale=scale), qkvs)
        b = bound(4 * B * H * S * D * 2, {"bf16_tensor": 4 * B * H * S * S * D})
        name = variant_name(D, torch.bfloat16, *tile)
        what = f" ({SWITCH_TILE_SHAPES[shape]})" if shape in SWITCH_TILE_SHAPES else ""
        print(f"[time] K1 {name} at {shape}{what}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, torch SDPA (reference line only) {s_ms:.4f} ms; bound "
              f"{b['bound_ms']:.6f} ms ({b['bound_by']}), share of the bound {b['bound_ms'] / k_ms:.3f}; max abs err "
              f"{err:.3e} (tol {tol:.3e}; without the last kv tile {tail:.3e}) | {card}", flush=True)
        entry = variants.setdefault((D, tile), {"name": f"flash_attention {name}",
                                                "launches": path_launches.get(name, 0), "max_abs_err": err, "shape": list(shape), "ms": k_ms, "plain_ms": p_ms,
                                                "library_ms": s_ms, **b, "at_shapes": {}})
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        entry["at_shapes"]["x".join(map(str, shape))] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": s_ms, **b}
    require(all(v["launches"] > 0 for v in variants.values()), "every K1 variant launched on this slice's path")
    print(f"[switches] phase done in {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"variants": list(variants.values()), "profile": profile}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import wild_visual_navigation_tpu_torch as port
    from wild_visual_navigation_tpu_torch.cfg.node_params import FeatureExtractorNodeParams
    from wild_visual_navigation_tpu_torch.feature_extractor.dino import DinoInterface
    from wild_visual_navigation_tpu_torch.models.registry import get_model
    from wild_visual_navigation_tpu_torch.ops import _cuda
    from wild_visual_navigation_tpu_torch.ops.flash_attention import bf16_atol, flash_attention, xla_attention
    from wild_visual_navigation_tpu_torch.ops.pixelwise_fused import fused_precompute, score_pixels, score_pixels_plain
    from wild_visual_navigation_tpu_torch.ops.rasterize import convex_hull
    from wild_visual_navigation_tpu_torch.ops.rasterize_fill import fill_hulls, fill_hulls_plain, hull_fill
    from wild_visual_navigation_tpu_torch.ops.slic import _init_index, pixel_features, rgb_to_lab, slic_batch, slic_geometry
    from wild_visual_navigation_tpu_torch.ops.slic_fused import (
        SlicScratch,
        cluster_slots,
        slic_step,
        slic_step_plain,
        step_layout,
        tile_candidates_plain,
    )
    from wild_visual_navigation_tpu_torch.runtime.fused import build_fused_batch_fn, build_fused_frame_fn
    from wild_visual_navigation_tpu_torch.utils.confidence_generator import ConfidenceConfig, confidence_load_state_dict
    from wild_visual_navigation_tpu_torch.utils.params import confidence_state_from_jax, load_head_npz, mlp_state_from_jax

    # ---- 1. the card
    t_main = time.perf_counter()

    def phase_done(label: str) -> None:
        print(f"[phase] {label} done at {time.perf_counter() - t_main:.1f} s", flush=True)

    card = card_line()
    print(card)
    kind = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    print(f"[card] {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}; TF32 off", flush=True)

    # ---- 2. build
    t0 = time.perf_counter()
    _cuda.library()
    built = f"nvcc {_cuda.build_seconds:.2f} s" if _cuda.build_seconds is not None else "cached library"
    print(f"[build] kernels ready in {time.perf_counter() - t0:.2f} s ({built})", flush=True)
    for line in kernel_resources(_cuda.resource_report()):
        print(f"[resources] {line}")
    tc = tensor_core_counts(_cuda.build())
    hgmma_k1 = count_in(tc, "flash_fwd_bf16_kernel", "HGMMA")
    hmma_k2 = count_in(tc, "pixelwise_score_kernel", "HMMA")
    print(f"[resources] tensor-core instructions in the SASS (cuobjdump -sass), by function: K1's bf16 body "
          f"{hgmma_k1} HGMMA (wgmma); K2 {hmma_k2} HMMA (mma.sync m16n8k16); the library in all "
          f"{sum(c['HGMMA'] for c in tc.values())} HGMMA, {sum(c['HMMA'] for c in tc.values())} HMMA")
    require(hgmma_k1 > 0, "K1 (bf16) runs on the tensor cores: HGMMA in its SASS")
    require(hmma_k2 > 0, "K2's 256 -> 32 layer runs on the tensor cores: HMMA in its SASS")

    g = torch.Generator(device=dev).manual_seed(0)
    head_params, head_cg, head_step = load_head_npz(ROOT / "assets/checkpoints/replay_demo_head_torch.npz")
    node = FeatureExtractorNodeParams()
    D = 384
    mlp = get_model({"name": "SimpleMLP",
                     "simple_mlp_cfg": {"input_size": D, "hidden_sizes": [256, 32, 1], "reconstruction": True}},
                    device=dev)
    mlp.load_state_dict(mlp_state_from_jax(head_params))
    mlp.eval().requires_grad_(False)
    cg_state = confidence_state_from_jax(head_cg, dev)
    results = {}

    # ---- 3. each kernel against its plain version at the main path's shapes
    attn_cases = []
    for B in (1, 4):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (torch.randn(B, 6, 785, 64, device=dev, generator=g).to(dtype) for _ in range(3))
            out, ref = flash_attention(q, k, v, 0.125).float(), xla_attention(q, k, v, 0.125).float()
            if dtype == torch.bfloat16:
                err, tol, tail = k1_bf16_check(out, ref, q, k, v, xla_attention, bf16_atol)
            else:
                err, tol, tail = float((out - ref).abs().max()), 1e-4, float("inf")
            print(f"[K1 flash_attention] (B={B}, 6, 785, 64) {str(dtype)[6:]}: max abs err {err:.3e} (tol {tol:.3e})")
            require(err <= tol < tail, f"K1 at B={B} {dtype}")
            attn_cases.append((B, dtype, err))
    for shape in list(ATTN_SHAPES)[2:]:
        q, k, v = (torch.randn(shape, device=dev, generator=g).to(torch.bfloat16) for _ in range(3))
        ref = xla_attention(q, k, v, 0.125).float()
        err, tol, tail = k1_bf16_check(flash_attention(q, k, v, 0.125), ref, q, k, v, xla_attention, bf16_atol)
        print(f"[K1 flash_attention] {shape} bfloat16 ({ATTN_SHAPES[shape]}): max abs err {err:.3e} (tol {tol:.3e}; "
              f"without the last kv tile the plain version errs by {tail:.3e})")
        require(err <= tol < tail, f"K1 at {shape}")
    for dtype in (torch.bfloat16, torch.float32):
        buf = torch.randn(2, 785, 3, 6, 64, device=dev, generator=g).to(dtype)  # (B, S, 3, H, Dh) as the ViT's qkv
        q, k, v = buf.permute(2, 0, 3, 1, 4).unbind(0)
        out = flash_attention(q, k, v, 0.125)
        ref = xla_attention(q, k, v, 0.125).float()
        if dtype == torch.bfloat16:
            err, tol, tail = k1_bf16_check(out, ref, q, k, v, xla_attention, bf16_atol)
        else:
            err, tol, tail = float((out.float() - ref).abs().max()), 1e-4, float("inf")
        print(f"[K1 flash_attention] strided views of a (2, 785, 3, 6, 64) {str(dtype)[6:]} qkv buffer: max abs err "
              f"{err:.3e} (tol {tol:.3e}); output strides {out.stride()} (a (B, S, H, D) buffer)")
        require(err <= tol < tail and out.stride() == (785 * 6 * 64, 64, 6 * 64, 1), f"K1 on strided views, {dtype}")
    results["flash_attention"] = {"max_abs_err": attn_cases[0][2]}

    for B, out in ((1, (224, 224)), (4, (224, 224)), (1, (23, 37))):
        feat = torch.randn(B, D, 28, 28, device=dev, generator=g)
        with torch.no_grad():
            ops = fused_precompute(mlp, feat, *out)
            trav, reco = score_pixels(ops, D)
            trav_p, reco_p = score_pixels_plain(ops, D)
        terr = float((trav - trav_p).abs().max())
        rerr = float((reco - reco_p).abs().max())
        rbound = float(((reco - reco_p).abs() - 1e-3 * reco_p.abs()).max())
        print(f"[K2 pixelwise_score] feat ({B}, 384, 28, 28) -> {out[0]}x{out[1]}, demo head (step {head_step}): trav "
              f"max abs err {terr:.3e} (tol 2e-3); reco max abs err {rerr:.3e} at max |reco| "
              f"{float(reco_p.abs().max()):.3e} (tol rtol 1e-3 + atol 1e-4)")
        require(terr <= 2e-3 and rbound <= 1e-4, f"K2 against its plain version at B={B}, {out}")
        if "pixelwise_score" not in results:
            results["pixelwise_score"] = {"max_abs_err": max(terr, rerr)}

    img = torch.rand(1, 3, 224, 224, device=dev, generator=g)
    ws, win2 = slic_geometry(100, 10.0, 224, 224)
    centre_errs = []
    for (H, W), K in (((224, 224), 100), ((61, 97), 12), ((448, 448), 100)):
        ws_k, win2_k = slic_geometry(K, 10.0, H, W)
        f = pixel_features(rgb_to_lab(torch.rand(1, 3, H, W, device=dev, generator=g)), ws_k)
        c = f[:, :, _init_index(K, H, W).to(dev)].transpose(1, 2)
        c = (c + 0.5 * torch.randn(c.shape, device=dev, generator=g)).contiguous()
        runs = [tuple(t.clone() for t in slic_step(f, c, W, ws_k, win2_k)) for _ in range(2)]
        ids_p, centers_p = slic_step_plain(f, c, W, ws_k, win2_k)
        differ = int((runs[0][0] != ids_p).sum())
        cerr = float((runs[0][1] - centers_p).abs().max())
        cbound = float(((runs[0][1] - centers_p).abs() - 1e-5 * centers_p.abs()).max())
        bitwise = torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1].view(torch.int32),
                                                                       runs[1][1].view(torch.int32))
        print(f"[K3 slic_step] {H}x{W}, K={K}: single-step ids differing {differ} of {H * W} (must be 0); new centres "
              f"max abs err {cerr:.3e} (tol atol 1e-3 + rtol 1e-5); two runs bitwise equal: {bitwise}")
        require(differ == 0 and cbound <= 1e-3 and bitwise, f"K3 at {H}x{W}")
        centre_errs.append(cerr)
    seg_k = slic_batch(img)
    seg_p = slic_batch(img.cpu())  # the whole Lloyd loop with the plain step
    agree = float((seg_k.cpu() == seg_p).float().mean())
    print(f"[K3 slic_step] 224x224, K=100, 10 iterations: label agreement with the plain loop {agree:.4f} (min 0.95)")
    require(agree >= 0.95, "K3 10-iteration agreement")
    results["slic_step"] = {"max_abs_err": centre_errs[0]}

    # K4 at the reprojection's shape: 32 footprints through 32 downward
    # cameras at 224 px, hulls of at most 32 vertices (33 edges with the gate)
    K224 = np.array([[134.4, 0, 112], [0, 134.4, 112], [0, 0, 1]])  # the demo camera scaled 64 -> 224
    rng = np.random.default_rng(0)
    p2d, valid_z = scene_points(dev, rng, 32, K224, 224)
    masks_f, hulls_f, hv_f = hull_fill(p2d, valid_z, 224, 224, 32)
    hulls, hull_valid = convex_hull(p2d, valid_z, max_hull=32)
    masks_p = fill_hulls_plain(hulls, hull_valid, 224, 224)
    hull_bitwise = torch.equal(hulls_f.view(torch.int32), hulls.view(torch.int32)) and torch.equal(hv_f, hull_valid)
    differ_f = int((masks_f != masks_p).sum())
    print(f"[K4 hull_fill] 32 footprints x 64 points -> hulls (32, 32, 2) and 32x224x224 masks in one launch: hulls "
          f"bitwise equal to convex_hull: {hull_bitwise}; {int(hv_f.sum())} hull vertices; {differ_f} of "
          f"{masks_f.numel()} pixels differ from convex_hull + fill_hulls_plain (must be 0)")
    require(hull_bitwise and differ_f == 0, "K4 from points identical to convex_hull + the plain fill")
    masks = fill_hulls(hulls, hull_valid, 224, 224)
    differ = int((masks != masks_p).sum())
    degenerate = fill_hulls(hulls, torch.zeros_like(hull_valid), 224, 224)
    nan_hulls = hulls.clone()
    nan_hulls[::4, 1, 0] = float("nan")  # a NaN edge: the per-pixel evaluation, NaN propagating
    nan_differ = int((fill_hulls(nan_hulls, hull_valid, 224, 224) != fill_hulls_plain(nan_hulls, hull_valid, 224,
                                                                                       224)).sum())
    print(f"[K4 fill_hulls] the fill alone, (32, 32, 2) hulls -> 32x224x224: {int(masks.sum())} pixels inside; "
          f"{differ} of {masks.numel()} pixels differ from the plain version (must be 0); with NaN vertices in 8 "
          f"hulls {nan_differ} differ (must be 0); degenerate hulls fill {int(degenerate.sum())} pixels (must be 0)")
    require(differ == 0 and nan_differ == 0, "K4's fill identical to its plain version")
    require(int(masks.sum()) > 0 and not bool(degenerate.any()), "K4 fills footprints and no degenerate hull")
    results["fill_hulls"] = {"max_abs_err": float((masks.float() - masks_p.float()).abs().max()),
                             "from_points_max_abs_err": float((masks_f.float() - masks_p.float()).abs().max())}

    # ---- 4. the main path
    size = node.network_input_image_height
    dino = DinoInterface(backbone=node.feature_type, input_size=size, backbone_type=node.dino_backbone,
                         patch_size=node.dino_patch_size, device=dev, seed=0)
    cg_cfg = ConfidenceConfig(std_factor=node.confidence_std_factor)
    frame = build_fused_frame_fn(dino.vit, mlp, cg_cfg, size, segmentation_type=node.segmentation_type,
                                 num_segments=node.slic_num_components,
                                 prediction_per_pixel=node.prediction_per_pixel)
    demo = np.load(ROOT / "assets/sequences/demo_mission.npz")["frame_images"]  # (50, 3, 64, 64)
    camera = np.random.default_rng(0).integers(0, 256, (1, 3, 480, 640), dtype=np.uint8)
    S = node.slic_num_components

    def check(res, batch: int | None = None):
        shape = (size, size) if batch is None else (batch, size, size)
        for name in ("traversability", "confidence"):
            m = getattr(res, name)
            require(tuple(m.shape) == shape, f"{name} shape {tuple(m.shape)}")
            require(bool(torch.isfinite(m).all()), f"{name} finite")
            require(float(m.min()) >= 0.0 and float(m.max()) <= 1.0, f"{name} in [0, 1]")
        require(tuple(res.segments.shape) == shape, "segments shape")
        require(int(res.segments.min()) >= 0 and int(res.segments.max()) < S, "segment ids in [0, S)")
        require(bool(torch.isfinite(res.features).all()), "pooled features finite")

    per_frame = {"flash_attention": 12, "pixelwise_score": 1, "slic_step": 11, "fill_hulls": 0}
    torch.cuda.synchronize()
    port.reset_launch_counts()
    for i in range(len(demo)):
        before = port.launch_counts()
        res = frame(cg_state, torch.from_numpy(demo[i : i + 1]).to(dev))
        check(res)
        delta = {k: v - before[k] for k, v in port.launch_counts().items()}
        require(delta == per_frame, f"launches of demo frame {i}: {delta}")
    before = port.launch_counts()
    res_cam = frame(cg_state, torch.from_numpy(camera).to(dev))
    check(res_cam)
    delta = {k: v - before[k] for k, v in port.launch_counts().items()}
    require(delta == per_frame, f"launches of the 480x640 frame: {delta}")
    before = port.launch_counts()
    res_b = frame.frames_batch(cg_state, torch.from_numpy(demo[:4]).to(dev))
    check(res_b, 4)
    delta_b = {k: v - before[k] for k, v in port.launch_counts().items()}
    torch.cuda.synchronize()
    launches = port.launch_counts()
    print(f"[main path] {len(demo)} demo frames + one 480x640 uint8 frame: every frame launched {per_frame}; "
          f"frames_batch at B=4 launched {delta_b}; totals {launches}")
    require(all(launches[k] > 0 for k in ("flash_attention", "pixelwise_score", "slic_step")),
            "every frame kernel launched on the frame path")

    # The same frame through the plain versions on the CPU (bf16 matmuls
    # round differently there, so maps agree to a bf16 tolerance).
    dino_cpu = DinoInterface(backbone=node.feature_type, input_size=size, backbone_type=node.dino_backbone,
                             patch_size=node.dino_patch_size, device="cpu", seed=0)
    mlp_cpu = get_model({"name": "SimpleMLP",
                         "simple_mlp_cfg": {"input_size": D, "hidden_sizes": [256, 32, 1], "reconstruction": True}})
    mlp_cpu.load_state_dict(mlp_state_from_jax(head_params))
    frame_cpu = build_fused_frame_fn(dino_cpu.vit, mlp_cpu, cg_cfg, size, num_segments=S)
    ref = frame_cpu(confidence_state_from_jax(head_cg), torch.from_numpy(camera))
    seg_agree = float((res_cam.segments.cpu() == ref.segments).float().mean())
    t_diff = float((res_cam.traversability.cpu() - ref.traversability).abs().max())
    c_diff = float((res_cam.confidence.cpu() - ref.confidence).abs().mean())
    f_diff = float((res_cam.features.cpu() - ref.features).abs().max())
    print(f"[main path] 480x640 frame against the plain versions on the CPU: segment agreement {seg_agree:.4f} "
          f"(min 0.95), trav max abs diff {t_diff:.3e} (tol 5e-2), conf mean abs diff {c_diff:.3e} (tol 5e-2), "
          f"pooled features max abs diff {f_diff:.3e} (tol 0.25)")
    require(seg_agree >= 0.95 and t_diff <= 5e-2 and c_diff <= 5e-2 and f_diff <= 0.25, "agreement with the CPU run")

    phase_done("kernel checks and the main path (3, 4)")

    # ---- 4b. the online learning loop on the recorded mission, at the product's settings
    seq = dict(np.load(ROOT / "assets/sequences/demo_mission.npz"))
    torch.cuda.synchronize()
    port.reset_launch_counts()
    t0 = time.perf_counter()
    est, rep = replay_learning(dev, frame, cg_state, seq, size, S, D)
    torch.cuda.synchronize()
    learn_launches = port.launch_counts()
    replay_s = time.perf_counter() - t0
    losses = rep["losses"]
    buf = est.buffer
    sig = buf.signal[buf.signal_valid]
    print(f"[learning] {len(seq['frame_stamps'])} frames + {len(seq['state_stamps'])} robot states in "
          f"{replay_s:.2f} s: {int(buf.valid.sum())} mission nodes in the buffer, {rep['valid_nodes']} valid, "
          f"{rep['flushes']} supervision flushes, {est.step} train steps; launches {learn_launches}")
    lo, hi = (float(sig.min()), float(sig.max())) if sig.numel() else (float("nan"), float("nan"))
    print(f"[learning] losses: first 5 {[round(x, 5) for x in losses[:5]]}, last 5 "
          f"{[round(x, 5) for x in losses[-5:]]}; {int(sig.numel())} supervised segments, signal in [{lo:.4f}, {hi:.4f}]")
    require(rep["valid_nodes"] >= 5, "at least 5 valid mission nodes")
    require(est.step > 0 and len(losses) == est.step and all(np.isfinite(losses)), "train steps with finite losses")
    require(len(losses) >= 10 and np.mean(losses[-5:]) < np.mean(losses[:5]), "the loss falls over the replay")
    require(sig.numel() > 0 and lo >= 0.0 and hi <= 1.0, "signals in [0, 1]")
    require(rep["flushes"] > 0 and all(k == (1, 1) for k in rep["k4_per_flush"]),
            f"K4 launched once per flush: {rep['k4_per_flush']}")
    require(learn_launches["fill_hulls"] == rep["flushes"] and all(v > 0 for v in learn_launches.values()),
            "every kernel launched on the learning path")
    launches["fill_hulls"] = learn_launches["fill_hulls"]

    # hot swap: the learnt head and its confidence statistics into the frame function
    hot = est.state_dict_for_hot_swap()
    mlp.load_state_dict(hot["params"])
    cg_hot = confidence_load_state_dict(cg_state, hot["confidence_generator"])
    res_hot = frame(cg_hot, torch.from_numpy(seq["frame_images"][-1:]).to(dev))
    check(res_hot)
    print(f"[learning] hot-swapped head (step {hot['step']}): last frame's mean traversability "
          f"{float(res_hot.traversability.mean()):.4f}, mean confidence {float(res_hot.confidence.mean()):.4f}")

    # the same replay on the CPU, through the plain versions, from the card's frame outputs
    frames_cpu = [tuple(t.cpu() for t in f) for f in rep["frames"]]
    est_cpu, rep_cpu = replay_learning(torch.device("cpu"), None, None, seq, size, S, D, frames_in=frames_cpu)
    occupied = buf.valid.cpu()
    m_gpu, m_cpu = buf.supervision_mask.cpu()[occupied], est_cpu.buffer.supervision_mask[occupied]
    mask_differ = int((m_gpu != m_cpu).sum())
    loss_diff = max((abs(a - b) / max(abs(b), 1e-12) for a, b in zip(losses, rep_cpu["losses"])),
                    default=float("nan"))
    print(f"[learning] CPU replay (plain versions, the card's frame outputs): {rep_cpu['valid_nodes']} valid nodes "
          f"(card {rep['valid_nodes']}); supervision masks differ in {mask_differ} of {m_gpu.numel()} pixels "
          f"(max {1e-4 * m_gpu.numel():.0f}); same sampled slots: {rep['samples'] == rep_cpu['samples']}; max relative "
          f"loss difference {loss_diff:.3e}")
    require(rep_cpu["valid_nodes"] == rep["valid_nodes"], "the same valid-node count on the CPU")
    require(mask_differ <= 1e-4 * m_gpu.numel(), "supervision masks agree with the CPU replay")
    phase_done("learning (4b)")

    # ---- 4c. the runtime: WVNRuntime's callbacks, learning thread and two-process nodes, at the product's settings
    learn = {"flushes": rep["flushes"], "valid_nodes": rep["valid_nodes"], "steps": est.step}
    runtime_launches = runtime_phase(dev, card, seq, ROOT / "assets/sequences/demo_mission.npz", learn)
    require(all(v > 0 for v in runtime_launches.values()), "every kernel launched on the runtime's path")
    launches = runtime_launches
    phase_done("runtime (4c)")

    # ---- 4d. SLIC at 448: the card's per-tile order against the plain whole-image loop
    slic_448_phase(dev, card, g, mlp, cg_state, demo)
    phase_done("slic 448 (4d)")

    # ---- 4e. the STEGO path: K2 at D = 90, the STEGO frame at 448, the Jackal runtime at 224
    stego = stego_phase(dev, card, g, demo, ROOT / "assets/sequences/demo_mission.npz")
    stego_launches = stego["launches"]
    require(stego_launches["slic_step"] == 0 and all(stego_launches[k] > 0 for k in
                                                     ("flash_attention", "pixelwise_score", "fill_hulls")),
            "the STEGO replay launched K1, K2 and K4, and K3 never")
    phase_done("stego (4e)")

    # ---- 4f. SIFT, histogram and LK; the anomaly and graph frames; the anomaly runtime; the golden replay
    features_launches = features_phase(dev, card)
    modes = modes_phase(dev, card, demo, ROOT / "assets/sequences/demo_mission.npz")
    require(all(modes["anomaly_launches"][k] > 0 for k in ("flash_attention", "slic_step", "fill_hulls"))
            and modes["anomaly_launches"]["pixelwise_score"] == 0,
            "the anomaly replay launched K1, K3 and K4, K2 never")
    require(all(modes["graph_launches"][k] > 0 for k in ("flash_attention", "slic_step")),
            "the graph frames launched K1 and K3")
    require(modes["golden_launches"]["fill_hulls"] > 0, "the golden replay launched K4")
    phase_done("features, modes, golden (4f)")

    # ---- 4g. the torchvision path; the grid map and the smart carrot; the closed-loop obstacle scenario
    tv = torchvision_phase(dev, card, demo, ROOT / "assets/sequences/demo_mission.npz")
    require(tv["torchvision_launches"]["slic_step"] > 0 and tv["torchvision_launches"]["fill_hulls"] > 0,
            "the torchvision replay launched K3 and K4")
    phase_done("torchvision (4g)")

    # ---- 4h. the offline tools: dataset generation, the ablation sweep, the parameter search, the soak
    offline = offline_phase(dev, card, g, demo)
    require(all(v > 0 for v in offline["offline_launches"].values()), "the offline tools launched every kernel")
    phase_done("offline (4h)")

    # ---- 4i. the parallel layer: the meshed runtime on 4 Gloo ranks, the distributed trainer, NCCL at world size 1,
    # and the quantised backbones on the mesh
    par = parallel_phase(dev, card, seq, rep["frames"], size, S, D)
    qmesh = quant_mesh_phase(dev, card)
    phase_done("parallel (4i)")

    # ---- 4j. the int8 backbones: the product runtime, BASELINE config 5, torch._int_mm's shape rules
    quant_launches = quant_phase(dev, card, ROOT / "assets/sequences/demo_mission.npz")
    phase_done("quant (4j)")

    # ---- 4k. the exported engine: the tool at its defaults, an int8_static engine, K1's operator
    engine = engine_phase(dev, card)
    phase_done("engine (4k)")

    # ---- 4l. the implementation switches: bench.py's backbone profile, K1 at every head dim and tile, "auto"
    switches = switches_phase(dev, card, g)
    phase_done("switches (4l)")

    # ---- 5. timings (device time from CUDA events; frame latency on the host clock)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for shape, what in ATTN_SHAPES.items():
        B, H, S, Dh = shape
        for dtype in (torch.bfloat16, torch.float32) if S == 785 else (torch.bfloat16,):
            qkvs = [tuple(torch.randn(shape, device=dev, generator=g).to(dtype) for _ in range(3))
                    for _ in range(WARMUP + N_TIMED)]
            k_ms = device_ms(lambda q, k, v: flash_attention(q, k, v, 0.125), qkvs)
            p_ms = device_ms(lambda q, k, v: xla_attention(q, k, v, 0.125), qkvs)
            s_ms = device_ms(lambda q, k, v: sdpa(q, k, v, scale=0.125), qkvs)
            bf16 = dtype == torch.bfloat16
            b = bound(4 * B * H * S * Dh * (2 if bf16 else 4),
                      {"bf16_tensor" if bf16 else "fp32": 4 * B * H * S * S * Dh})
            blocks = -(-S // 64) * B * H
            print(f"[time] K1 flash_attention {shape} {str(dtype)[6:]} ({what}): kernel {k_ms:.4f} ms, plain "
                  f"{p_ms:.4f} ms, torch SDPA (reference line only) {s_ms:.4f} ms; bound {b['bound_ms']:.6f} ms "
                  f"({b['bound_by']}), share of the bound {b['bound_ms'] / k_ms:.3f}; grid {blocks} blocks on "
                  f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs | {card}")
            if shape == (1, 6, 785, 64) and bf16:
                results["flash_attention"].update(ms=k_ms, plain_ms=p_ms, library_ms=s_ms, **b)

    with torch.no_grad():
        opss = [(fused_precompute(mlp, torch.randn(1, D, 28, 28, device=dev, generator=g), 224, 224),)
                for _ in range(WARMUP + N_TIMED)]
        k_ms = device_ms(lambda o: score_pixels(o, D), opss)
        p_ms = device_ms(lambda o: score_pixels_plain(o, D), opss)
        pre_ms = device_ms(lambda f: fused_precompute(mlp, f, 224, 224),
                           [(torch.randn(1, D, 28, 28, device=dev, generator=g),) for _ in range(WARMUP + N_TIMED)])
    hw_px = 224 * 224
    b2, k2_ops, k2_bytes = k2_bound(opss[0][0], hw_px)
    parts = ", ".join(f"{kind} {n / PEAK_FLOPS[kind] * 1e3:.6f} ms" for kind, n in k2_ops.items())
    print(f"[time] K2 pixelwise_score 224x224 from (1, 384, 28, 28): kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms "
          f"(torch precompute before either: {pre_ms:.4f} ms); bound {b2['bound_ms']:.6f} ms ({b2['bound_by']}: "
          f"{k2_bytes} bytes {k2_bytes / PEAK_BYTES_PER_S * 1e3:.6f} ms; {parts}), share of the bound "
          f"{b2['bound_ms'] / k_ms:.3f} | {card}")
    results["pixelwise_score"].update(ms=k_ms, plain_ms=p_ms, library_ms=None, **b2)

    steps = []
    for _ in range(WARMUP + N_TIMED):
        f = pixel_features(rgb_to_lab(torch.rand(1, 3, 224, 224, device=dev, generator=g)), ws)
        steps.append((f, f[:, :, _init_index(100, 224, 224).to(dev)].transpose(1, 2).contiguous()))
    scratch = SlicScratch.allocate(1, 224, 224, 100, dev)
    k_ms = device_ms(lambda f, c: slic_step(f, c, 224, ws, win2, scratch), steps)
    p_ms = device_ms(lambda f, c: slic_step_plain(f, c, 224, ws, win2), steps)
    steps4 = []
    for _ in range(WARMUP + N_TIMED):
        f = pixel_features(rgb_to_lab(torch.rand(4, 3, 224, 224, device=dev, generator=g)), ws)
        steps4.append((f, f[:, :, _init_index(100, 224, 224).to(dev)].transpose(1, 2).contiguous()))
    scratch4 = SlicScratch.allocate(4, 224, 224, 100, dev)
    k4_ms = device_ms(lambda f, c: slic_step(f, c, 224, ws, win2, scratch4), steps4)
    lay = step_layout(224, 224, 100, cluster_slots(dev))
    pairs, orphans = zip(*(slic_work(c, 224, 224, ws, win2) for _, c in steps[WARMUP:]))
    pairs, orphans = float(np.mean(pairs)), float(np.mean(orphans))
    # features (5 x HW fp32) and centres in, ids and new centres out; ~20 fp32 operations per (pixel,
    # candidate) pair and per (orphan, centre) pair, 6 sums per pixel
    k3_bytes = 5 * hw_px * 4 + 100 * 5 * 4 + hw_px * 4 + 100 * 5 * 4
    results["slic_step"].update(ms=k_ms, plain_ms=p_ms, library_ms=None,
                                **bound(k3_bytes, {"fp32": 20 * (pairs + orphans * 100) + 6 * hw_px}))
    dense = bound(k3_bytes, {"fp32": 20 * hw_px * 100 + 6 * hw_px})
    print(f"[time] K3 slic_step 224x224, K=100, one iteration with its centre update (11 launches per frame; {lay}, "
          f"{lay.variant}): kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms; bound {results['slic_step']['bound_ms']:.6f} "
          f"ms from {pairs:.0f} (pixel, candidate) pairs ({pairs / hw_px:.2f} per pixel) and {orphans:.0f} orphans x "
          f"100; dense bound over all K {dense['bound_ms']:.6f} ms | {card}")
    print(f"[time] K3 slic_step B=4 at 224x224, K=100 (each image {lay}): kernel {k4_ms:.4f} ms | {card}")
    results["slic_step"].update(ms_b4=k4_ms)

    for B in (1, 4):
        imgs = [(torch.rand(B, 3, 224, 224, device=dev, generator=g),) for _ in range(WARMUP + N_TIMED)]
        sb_dev = device_ms(slic_batch, imgs)
        sb_wall = wall_ms(slic_batch, imgs)
        print(f"[time] slic_batch B={B} at 224x224, K=100, 10 iterations (11 K3 launches): {sb_dev:.4f} ms between "
              f"CUDA events, {sb_wall:.4f} ms on the host clock | {card}")

    point_sets = [scene_points(dev, rng, 32, K224, 224) for _ in range(WARMUP + N_TIMED)]
    hull_sets = [convex_hull(p, v, max_hull=32) for p, v in point_sets]
    differ = [int((fill_hulls(h, v, 224, 224) != fill_hulls_plain(h, v, 224, 224)).sum()) for h, v in hull_sets]
    from_points = [int((hull_fill(p, v, 224, 224, 32)[0] != fill_hulls_plain(*hs, 224, 224)).sum())
                   for (p, v), hs in zip(point_sets, hull_sets)]
    print(f"[parallel] K4 on {len(hull_sets)} sets of 16 hulls at 224x224 (a dp rank's half of the fan-out): pixels "
          f"differing from fill_hulls_plain {sum(differ)} (must be 0), from points (hull and fill) {sum(from_points)} "
          f"(must be 0), of {len(hull_sets) * 16 * 224 * 224}")
    require(sum(differ) == 0 and sum(from_points) == 0, "K4 on 16 hulls identical to its plain version")
    fa_ms = device_ms(lambda h, v: fill_hulls(h, v, 224, 224), hull_sets)
    fap_ms = device_ms(lambda h, v: fill_hulls_plain(h, v, 224, 224), hull_sets)
    k_ms = device_ms(lambda p, v: hull_fill(p, v, 224, 224, 32), point_sets)
    p_ms = device_ms(lambda p, v: fill_hulls_plain(*convex_hull(p, v, max_hull=32), 224, 224), point_sets)
    # K4's bounds. From points: points and masks in (64 x (8 + 1) bytes per footprint), hulls (32 x (8 + 1)
    # bytes) and masks (one byte per pixel) out; the march's cross products at fp32, 3 operations each
    # (two products, a difference), N^2 per step, over the steps these footprints take (a hull of nv >= 3
    # vertices takes min(nv, 31) steps), plus some 9 per point and step. The fill alone: hulls in, masks out.
    N, E = 64, 32
    nv = torch.stack([hv.sum(1) for _, hv in hull_sets[WARMUP:]]).float()
    steps = float(torch.where(nv >= 3, nv.clamp(max=E - 1), 0.0).sum(1).mean())
    b4 = bound(32 * N * 9 + 32 * E * 9 + 32 * hw_px, {"fp32": steps * (3 * N * N + 9 * N)})
    b4_fill = bound(32 * E * 9 + 32 * hw_px, {"fp32": 32 * (E + 1) * 6})
    per_pixel = bound(32 * E * 9 + 32 * hw_px, {"fp32": 5 * 32 * hw_px * (E + 1)})
    print(f"[time] K4 hull_fill 32 footprints x 64 points -> hulls and 32x224x224 masks, one launch (one per supervision "
          f"flush): kernel {k_ms:.4f} ms, plain (convex_hull + fill_hulls_plain) {p_ms:.4f} ms; bound "
          f"{b4['bound_ms']:.6f} ms ({b4['bound_by']}; {steps:.0f} march steps over the 32 hulls), share of the bound "
          f"{b4['bound_ms'] / k_ms:.3f} | {card}")
    print(f"[time] K4 fill_hulls, the fill alone, (32, 32, 2) hulls -> 32x224x224: kernel {fa_ms:.4f} ms, plain "
          f"{fap_ms:.4f} ms; bound {b4_fill['bound_ms']:.6f} ms ({b4_fill['bound_by']}), share of the bound "
          f"{b4_fill['bound_ms'] / fa_ms:.3f}; note: a per-pixel evaluation of all 33 edges would be "
          f"5 x 32 x HW x 33 fp32 operations, {per_pixel['bound_ms']:.6f} ms at the fp32 peak | {card}")
    # ms, plain_ms and bound_ms are of the fill alone, the function that `replaces` names; the launch from
    # points (the flush's route, the gift wrap included) under from_points_*
    results["fill_hulls"].update(ms=fa_ms, plain_ms=fap_ms, library_ms=None, **b4_fill, from_points_ms=k_ms,
                                 from_points_plain_ms=p_ms, from_points_bound_ms=b4["bound_ms"],
                                 from_points_bound_by=b4["bound_by"])

    updates = [rep["updates"][i % len(rep["updates"])] for i in range(WARMUP + N_TIMED)]
    f_dev = device_ms(est._reproject_update, updates)
    f_wall = wall_ms(est._reproject_update, updates)
    samples = [(rep["samples"][i % len(rep["samples"])],) for i in range(WARMUP + N_TIMED)]
    t_dev = device_ms(est._train_step, samples)
    t_wall = wall_ms(est._train_step, samples)
    print(f"[time] supervision flush (one footprint over the fan-out of 32, 224x224, S=100): latency {f_wall:.3f} ms "
          f"on the host clock, {f_dev:.3f} ms between CUDA events | {card}")
    print(f"[time] train step (batch 8 x 100 segments, SimpleMLP [384, 256, 32, 1+384], Adam): latency "
          f"{t_wall:.3f} ms on the host clock, {t_dev:.3f} ms between CUDA events | {card}")

    frames_1 = [(cg_state, torch.from_numpy(demo[i : i + 1]).to(dev)) for i in range(WARMUP + N_TIMED)]
    lat1 = wall_ms(frame, frames_1)
    batches = [(cg_state, torch.from_numpy(demo[np.arange(i, i + 4) % len(demo)]).to(dev))
               for i in range(WARMUP + N_TIMED)]
    lat4 = wall_ms(frame.frames_batch, batches)
    print(f"[time] frame B=1 (64x64 demo frame -> 224x224): latency {lat1:.3f} ms on the host clock | {card}")
    print(f"[time] frames_batch B=4: latency {lat4:.3f} ms ({lat4 / 4:.3f} ms per frame) | {card}")
    profile_frames(frame, cg_state, demo, dev, card)

    # build_fused_batch_fn: the bare backbone and head on frames at network size, once, against its CPU twin (the
    # hot-swapped head, as the frame holds it now)
    mlp_cpu.load_state_dict({k: v.cpu() for k, v in mlp.state_dict().items()})
    batch_fn, batch_cpu = build_fused_batch_fn(dino.vit, mlp), build_fused_batch_fn(dino_cpu.vit, mlp_cpu)
    raw = torch.from_numpy(rng.integers(0, 256, (2, 3, size, size), dtype=np.uint8))
    torch.cuda.synchronize()
    port.reset_launch_counts()
    got = batch_fn(raw.to(dev))
    torch.cuda.synchronize()
    fused_batch_launches = port.launch_counts()
    fb_diff = float((got.cpu() - batch_cpu(raw)).abs().max())
    fb_ms = wall_ms(batch_fn, [(raw.to(dev),)] * (WARMUP + N_TIMED))
    print(f"[main path] build_fused_batch_fn on (2, 3, {size}, {size}) uint8 frames -> {tuple(got.shape)} per-patch "
          f"traversability: launches {fused_batch_launches}; against its CPU twin max abs diff {fb_diff:.3e} (tol "
          f"5e-2, the frame's); host {fb_ms:.3f} ms per call | {card}", flush=True)
    require(fused_batch_launches["flash_attention"] == 12 and sum(fused_batch_launches.values()) == 12,
            "build_fused_batch_fn launches K1 12 times and nothing else")
    require(got.shape == (2, size // 8, size // 8) and fb_diff <= 5e-2, "build_fused_batch_fn agrees with the CPU")

    sources = {
        "flash_attention": ("flash_attention.cu", "wild_visual_navigation_tpu/ops/flash_attention.py:132"),
        "pixelwise_score": ("pixelwise_score.cu", "wild_visual_navigation_tpu/ops/pixelwise_fused.py:210"),
        "slic_step": ("slic_step.cu", "wild_visual_navigation_tpu/ops/slic_fused.py:128"),
        "fill_hulls": ("fill_hulls.cu", "wild_visual_navigation_tpu/ops/rasterize_pallas.py:52"),
    }
    kernels = [{"name": name, "route": "cuda", "source": f"wild_visual_navigation_tpu_torch/csrc/{src}",
                "replaces": rep, "launches": launches[name], **results[name], "stego_launches": stego_launches[name],
                "anomaly_launches": modes["anomaly_launches"][name], "graph_launches": modes["graph_launches"][name],
                "golden_launches": modes["golden_launches"][name], "features_launches": features_launches[name],
                "torchvision_launches": tv["torchvision_launches"][name],
                "closed_loop_launches": tv["closed_loop_launches"][name],
                "offline_launches": offline["offline_launches"][name],
                "parallel_launches": par["launches"][name], "quant_mesh_launches": qmesh["launches"][name],
                "quant_launches": quant_launches[name],
                "engine_launches": engine["engine_launches"][name],
                "fused_batch_launches": fused_batch_launches[name]}
               for name, (src, rep) in sources.items()]
    kernels[0]["parallel_tp_rank"] = {"x".join(map(str, shape)): t for shape, t in par["k1"].items()}
    kernels[3]["parallel_dp_rank_16_hulls"] = par["k4_16"]
    kernels[0]["operator_overhead_us"] = engine["op_overhead_us"]
    # K1's other instantiations: launches on the [switches] path (counts set to 0 just before it), each timed at
    # its first shape (`at_shapes`: every shape it was timed at)
    kernels += [{"name": v["name"], "route": "cuda",
                 "source": f"wild_visual_navigation_tpu_torch/csrc/{variant_source(v['name'])}",
                 "replaces": sources["flash_attention"][1], **{k: x for k, x in v.items() if k != "name"}}
                for v in switches["variants"]]
    phase_done("timings (5)")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--engine-child"]:
        sys.exit(engine_child(*sys.argv[2:]))
    sys.exit(main())
