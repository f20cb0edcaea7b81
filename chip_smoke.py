#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        (from the root of the repository)

Builds the port's three CUDA kernels from wild_visual_navigation_tpu_torch/
csrc/, holds each against its plain PyTorch version at the main path's
shapes, drives the per-frame path (DINO ViT-S/8 at 224 px with seeded
weights, SLIC with 100 segments, the converted demo head, per-pixel
prediction) through DinoInterface and build_fused_frame_fn, checks its
outputs and that every frame went through the kernels, and times the
kernels and the frame. Every phase raises on failure.

The last line is {"ok": true, "device": {...}}; the line before it lists
the kernels with their launches on the main path, errors and times.
Without a CUDA device, or outside the repository, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
N_TIMED = 25  # timed runs, each on its own inputs, after WARMUP runs
WARMUP = 3


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


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


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
    from wild_visual_navigation_tpu_torch.ops.flash_attention import flash_attention, xla_attention
    from wild_visual_navigation_tpu_torch.ops.pixelwise_fused import fused_precompute, score_pixels, score_pixels_plain
    from wild_visual_navigation_tpu_torch.ops.slic import _init_index, pixel_features, rgb_to_lab, slic_batch, slic_geometry
    from wild_visual_navigation_tpu_torch.ops.slic_fused import slic_step, slic_step_plain
    from wild_visual_navigation_tpu_torch.runtime.fused import build_fused_frame_fn
    from wild_visual_navigation_tpu_torch.utils.confidence_generator import ConfidenceConfig
    from wild_visual_navigation_tpu_torch.utils.params import confidence_state_from_jax, load_head_npz, mlp_state_from_jax

    # ---- 1. the card
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
        for dtype, tol in ((torch.bfloat16, 3e-2), (torch.float32, 1e-4)):
            q, k, v = (torch.randn(B, 6, 785, 64, device=dev, generator=g).to(dtype) for _ in range(3))
            err = float((flash_attention(q, k, v, 0.125).float() - xla_attention(q, k, v, 0.125).float()).abs().max())
            print(f"[K1 flash_attention] (B={B}, 6, 785, 64) {str(dtype)[6:]}: max abs err {err:.3e} (tol {tol:.0e})")
            require(err <= tol, f"K1 at B={B} {dtype}")
            attn_cases.append((B, dtype, err))
    results["flash_attention"] = {"max_abs_err": attn_cases[0][2]}

    feat = torch.randn(1, D, 28, 28, device=dev, generator=g)
    with torch.no_grad():
        ops = fused_precompute(mlp, feat, 224, 224)
        trav, reco = score_pixels(ops, D)
        trav_p, reco_p = score_pixels_plain(ops, D)
    terr = float((trav - trav_p).abs().max())
    rerr = float((reco - reco_p).abs().max())
    rbound = float(((reco - reco_p).abs() - 1e-3 * reco_p.abs()).max())
    print(f"[K2 pixelwise_score] feat (1, 384, 28, 28) -> 224x224, demo head (step {head_step}): trav max abs err "
          f"{terr:.3e} (tol 2e-3); reco max abs err {rerr:.3e} at max |reco| {float(reco_p.abs().max()):.3e} "
          f"(tol rtol 1e-3 + atol 1e-4)")
    require(terr <= 2e-3 and rbound <= 1e-4, "K2 against its plain version")
    results["pixelwise_score"] = {"max_abs_err": max(terr, rerr)}

    img = torch.rand(1, 3, 224, 224, device=dev, generator=g)
    ws, win2 = slic_geometry(100, 10.0, 224, 224)
    feats = pixel_features(rgb_to_lab(img), ws)
    centers = feats[:, :, _init_index(100, 224, 224).to(dev)].transpose(1, 2)
    centers = (centers + 0.5 * torch.randn(centers.shape, device=dev, generator=g)).contiguous()
    ids, partials = slic_step(feats, centers, 224, ws, win2)
    ids_p, partials_p = slic_step_plain(feats, centers, 224, ws, win2)
    same = int((ids != ids_p).sum())
    perr = float((partials - partials_p).abs().max())
    seg_k = slic_batch(img)
    seg_p = slic_batch(img.cpu())  # the whole Lloyd loop with the plain step
    agree = float((seg_k.cpu() == seg_p).float().mean())
    print(f"[K3 slic_step] 224x224, K=100: single-step ids differing {same} of {224 * 224} (must be 0); partial sums "
          f"max abs err {perr:.3e}; 10-iteration label agreement with the plain loop {agree:.4f} (min 0.95)")
    require(same == 0, "K3 single-step ids identical")
    require(agree >= 0.95, "K3 10-iteration agreement")
    results["slic_step"] = {"max_abs_err": float((ids - ids_p).abs().max())}

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

    per_frame = {"flash_attention": 12, "pixelwise_score": 1, "slic_step": 11}
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
    require(all(v > 0 for v in launches.values()), "every kernel launched on the main path")

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

    # ---- 5. timings (device time from CUDA events; frame latency on the host clock)
    for B in (1, 4):
        for dtype in (torch.bfloat16, torch.float32):
            qkvs = [tuple(torch.randn(B, 6, 785, 64, device=dev, generator=g).to(dtype) for _ in range(3))
                    for _ in range(WARMUP + N_TIMED)]
            k_ms = device_ms(lambda q, k, v: flash_attention(q, k, v, 0.125), qkvs)
            p_ms = device_ms(lambda q, k, v: xla_attention(q, k, v, 0.125), qkvs)
            s_ms = device_ms(lambda q, k, v: torch.nn.functional.scaled_dot_product_attention(q, k, v, scale=0.125), qkvs)
            print(f"[time] K1 flash_attention (B={B}, 6, 785, 64) {str(dtype)[6:]}: kernel {k_ms:.4f} ms, plain "
                  f"{p_ms:.4f} ms, torch SDPA (reference line only) {s_ms:.4f} ms | {card}")
            if B == 1 and dtype == torch.bfloat16:
                results["flash_attention"].update(ms=k_ms, plain_ms=p_ms)

    with torch.no_grad():
        opss = [(fused_precompute(mlp, torch.randn(1, D, 28, 28, device=dev, generator=g), 224, 224),)
                for _ in range(WARMUP + N_TIMED)]
        k_ms = device_ms(lambda o: score_pixels(o, D), opss)
        p_ms = device_ms(lambda o: score_pixels_plain(o, D), opss)
        pre_ms = device_ms(lambda f: fused_precompute(mlp, f, 224, 224),
                           [(torch.randn(1, D, 28, 28, device=dev, generator=g),) for _ in range(WARMUP + N_TIMED)])
    print(f"[time] K2 pixelwise_score 224x224 from (1, 384, 28, 28): kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms "
          f"(torch precompute before either: {pre_ms:.4f} ms) | {card}")
    results["pixelwise_score"].update(ms=k_ms, plain_ms=p_ms)

    steps = []
    for _ in range(WARMUP + N_TIMED):
        f = pixel_features(rgb_to_lab(torch.rand(1, 3, 224, 224, device=dev, generator=g)), ws)
        steps.append((f, f[:, :, _init_index(100, 224, 224).to(dev)].transpose(1, 2).contiguous()))
    k_ms = device_ms(lambda f, c: slic_step(f, c, 224, ws, win2), steps)
    p_ms = device_ms(lambda f, c: slic_step_plain(f, c, 224, ws, win2), steps)
    print(f"[time] K3 slic_step 224x224, K=100 (one of 11 steps per frame): kernel {k_ms:.4f} ms, plain "
          f"{p_ms:.4f} ms | {card}")
    results["slic_step"].update(ms=k_ms, plain_ms=p_ms)

    frames_1 = [(cg_state, torch.from_numpy(demo[i : i + 1]).to(dev)) for i in range(WARMUP + N_TIMED)]
    lat1 = wall_ms(frame, frames_1)
    batches = [(cg_state, torch.from_numpy(demo[np.arange(i, i + 4) % len(demo)]).to(dev))
               for i in range(WARMUP + N_TIMED)]
    lat4 = wall_ms(frame.frames_batch, batches)
    print(f"[time] frame B=1 (64x64 demo frame -> 224x224): latency {lat1:.3f} ms on the host clock | {card}")
    print(f"[time] frames_batch B=4: latency {lat4:.3f} ms ({lat4 / 4:.3f} ms per frame) | {card}")

    sources = {
        "flash_attention": ("flash_attention.cu", "wild_visual_navigation_tpu/ops/flash_attention.py:132"),
        "pixelwise_score": ("pixelwise_score.cu", "wild_visual_navigation_tpu/ops/pixelwise_fused.py:210"),
        "slic_step": ("slic_step.cu", "wild_visual_navigation_tpu/ops/slic_fused.py:128"),
    }
    kernels = [{"name": name, "route": "cuda", "source": f"wild_visual_navigation_tpu_torch/csrc/{src}",
                "replaces": rep, "launches": launches[name], **results[name]}
               for name, (src, rep) in sources.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
