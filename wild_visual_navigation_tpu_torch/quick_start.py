"""Offline inference CLI of the torch port (counterpart of quick_start.py).

Runs the per-frame path that the runtime serves over a folder of images —
or, without --image_folder, over the frames of
assets/sequences/demo_mission.npz — and writes side-by-side
(input | traversability | confidence) PNGs, drawn with visu/'s
LearningVisualizer. Three paths: runtime/fused.py::build_fused_frame_fn
(DINO backbone, SLIC or grid segments), ::build_fused_stego_frame_fn
(stego features and segments: ViT-B/8, the STEGO head, k-means clusters),
and the FeatureExtractor facade for dense SIFT (SLIC, grid or pixel-wise
segments); each scores per pixel or per segment. `--config` applies YAML node-parameter profiles, e.g. the Jackal
robot's STEGO path:

    python -m wild_visual_navigation_tpu_torch.quick_start \
        --config configs/default.yaml --config configs/robots/jackal.yaml

The head defaults to the shipped replay-trained one, converted for the
port (assets/checkpoints/replay_demo_head_torch.npz, written by
tools/convert_head_to_torch.py) for dino/vit_small/8; other feature
types get a seeded random head. The backbone has seeded random weights:
pretrained DINO and STEGO weights are not in the repository.

Example:
    python -m wild_visual_navigation_tpu_torch.quick_start --output_folder results/torch_demo
"""

from __future__ import annotations

import argparse
import os
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
DEFAULT_HEAD = ROOT / "assets/checkpoints/replay_demo_head_torch.npz"
DEMO_FRAMES = ROOT / "assets/sequences/demo_mission.npz"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="WVN offline inference, PyTorch / CUDA port")
    p.add_argument("--model_name", type=str, default="indoor_mpi", help="label for the run")
    p.add_argument("--ckpt", type=str, default=None,
                   help="converted head (.npz from tools/convert_head_to_torch.py); defaults to the shipped "
                        "replay-trained head for dino/vit_small/8; pass --ckpt '' for a random head")
    p.add_argument("--image_folder", type=str, default=None,
                   help="folder of .png/.jpg frames; defaults to the frames of assets/sequences/demo_mission.npz")
    p.add_argument("--output_folder", type=str, default="results/torch_demo_data")
    p.add_argument("--network_input_image_height", type=int, default=224)
    p.add_argument("--network_input_image_width", type=int, default=224)
    p.add_argument("--segmentation_type", type=str, default="slic",
                   choices=["slic", "grid", "random", "stego", "none"])
    p.add_argument("--feature_type", type=str, default="dino", choices=["dino", "dinov2", "stego", "sift"])
    p.add_argument("--dino_patch_size", type=int, default=8, choices=[8, 14, 16])
    p.add_argument("--dino_backbone", type=str, default="vit_small")
    p.add_argument("--slic_num_components", type=int, default=100)
    p.add_argument("--compute_confidence", action="store_true", default=True)
    p.add_argument("--no-compute_confidence", dest="compute_confidence", action="store_false")
    p.add_argument("--prediction_per_pixel", action="store_true", default=True)
    p.add_argument("--no-prediction_per_pixel", dest="prediction_per_pixel", action="store_false")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--max_frames", type=int, default=None)
    p.add_argument("--config", action="append", default=[],
                   help="YAML node-parameter profile, applied in order (repeatable); its feature and segmentation "
                        "types, input size, backbone, SLIC segments and per-pixel prediction become the defaults, "
                        "which flags given on the command line override")
    args = p.parse_args(argv)
    if args.config:
        from .utils.loading import load_node_params

        fe, _ = load_node_params(*args.config)
        p.set_defaults(**{name: getattr(fe, name) for name in (
            "feature_type", "segmentation_type", "network_input_image_height", "network_input_image_width",
            "dino_patch_size", "dino_backbone", "slic_num_components", "prediction_per_pixel")})
        args = p.parse_args(argv)
    return args


def _frames(args):
    """(name, (3, H, W) float32 in [0, 1]) pairs."""
    if args.image_folder is None:
        imgs = np.load(DEMO_FRAMES)["frame_images"]
        return [(f"demo_{i:03d}", img) for i, img in enumerate(imgs)]
    from PIL import Image

    paths = sorted(p for p in Path(args.image_folder).iterdir() if p.suffix.lower() in (".png", ".jpg", ".jpeg"))
    if not paths:
        raise SystemExit(f"no images found in {args.image_folder}")
    return [(p.stem, np.asarray(Image.open(p).convert("RGB"), np.float32).transpose(2, 0, 1) / 255.0)
            for p in paths]


def _sift_frame(fe, mlp, cg_cfg, H: int, W: int, per_pixel: bool):
    """frame(cg_state, img) through the facade: dense SIFT, its segments,
    the head scored per pixel or per segment."""
    from types import SimpleNamespace

    from .ops.resize import resize_image
    from .runtime.fused import _score_rows

    def frame(cg_state, img):
        ex = fe.extract(resize_image(img, H, None if H == W else W), return_dense_features=per_pixel)
        if per_pixel:
            trav, conf = _score_rows(mlp, cg_cfg, cg_state, ex.dense_features.reshape(fe.feature_dim, -1).T)
            return SimpleNamespace(traversability=trav.reshape(H, W), confidence=conf.reshape(H, W))
        trav, conf = _score_rows(mlp, cg_cfg, cg_state, ex.features)
        sid = ex.segments.long().clamp(0, ex.features.shape[0] - 1)
        return SimpleNamespace(traversability=trav[sid], confidence=conf[sid])

    return frame


def main(argv=None):
    args = parse_args(argv)
    stego = (args.feature_type, args.segmentation_type) == ("stego", "stego")
    sift = args.feature_type == "sift"
    if sift and args.segmentation_type not in ("slic", "grid", "none"):
        raise SystemExit("sift features go with slic, grid or none (pixel-wise) segments")
    if not (stego or sift) and (args.segmentation_type not in ("slic", "grid")
                                or args.feature_type not in ("dino", "dinov2")):
        raise SystemExit("the torch port serves dino/dinov2 features with slic or grid segments, stego features "
                         "with stego segments and sift features (torchvision: ROADMAP.md Queue 1, item 21)")
    import torch
    from PIL import Image

    from .feature_extractor.dino import DinoInterface
    from .feature_extractor.feature_extractor import FeatureExtractor
    from .feature_extractor.stego import StegoInterface
    from .models.registry import get_model
    from .ops.resize import resize_image
    from .runtime.fused import build_fused_frame_fn, build_fused_stego_frame_fn
    from .utils.confidence_generator import ConfidenceConfig, confidence_init
    from .utils.params import confidence_state_from_jax, load_head_npz, mlp_state_from_jax
    from .visu import LearningVisualizer

    H, W = args.network_input_image_height, args.network_input_image_width
    device = torch.device(args.device)
    if stego:
        backbone = StegoInterface(input_size=H, device=device, seed=0)
        D = 90
    elif sift:
        backbone = FeatureExtractor(segmentation_type=args.segmentation_type, feature_type="sift", input_size=H,
                                    slic_num_components=args.slic_num_components, device=device)
        D = backbone.feature_dim
    else:
        backbone = DinoInterface(backbone=args.feature_type, input_size=H, backbone_type=args.dino_backbone,
                                 patch_size=args.dino_patch_size, device=device, seed=0)
        D = backbone.feature_dim
    mlp = get_model({"name": "SimpleMLP",
                     "simple_mlp_cfg": {"input_size": D, "hidden_sizes": [256, 32, 1], "reconstruction": True}},
                    device=device, generator=torch.Generator().manual_seed(1))
    cg_state = confidence_init(device)
    if args.ckpt is None and (args.feature_type, args.dino_backbone, args.dino_patch_size) == ("dino", "vit_small", 8):
        args.ckpt = str(DEFAULT_HEAD)
    if args.ckpt:
        if not args.ckpt.endswith(".npz"):
            raise SystemExit(f"{args.ckpt}: convert flax checkpoints with tools/convert_head_to_torch.py first")
        params, cg, step = load_head_npz(args.ckpt)
        mlp.load_state_dict(mlp_state_from_jax(params))
        cg_state = confidence_state_from_jax(cg, device)
        print(f"loaded head {args.ckpt} (step {step})")
    mlp.eval().requires_grad_(False)
    if sift:
        frame = _sift_frame(backbone, mlp, ConfidenceConfig(std_factor=0.5), H, W, args.prediction_per_pixel)
    elif stego:
        frame = build_fused_stego_frame_fn(backbone, mlp, ConfidenceConfig(std_factor=0.5), H,
                                           prediction_per_pixel=args.prediction_per_pixel,
                                           input_width=None if H == W else W)
    else:
        frame = build_fused_frame_fn(backbone.vit, mlp, ConfidenceConfig(std_factor=0.5), H,
                                     segmentation_type=args.segmentation_type,
                                     num_segments=args.slic_num_components,
                                     prediction_per_pixel=args.prediction_per_pixel,
                                     input_width=None if H == W else W)
    os.makedirs(args.output_folder, exist_ok=True)
    frames = _frames(args)[: args.max_frames]
    visu = LearningVisualizer()
    print(f"device: {device}" + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))
    for i, (name, img) in enumerate(frames):
        x = torch.from_numpy(np.ascontiguousarray(img))[None].to(device)
        t0 = time.perf_counter()
        res = frame(cg_state, x)
        trav = res.traversability.cpu().numpy()
        conf = res.confidence.cpu().numpy()
        dt = time.perf_counter() - t0
        base = resize_image(x, H, None if H == W else W)[0].permute(1, 2, 0).cpu().numpy()
        panels = [base, visu.plot_detectron_classification(base, trav, alpha=0.6)]
        if args.compute_confidence:
            panels.append(visu.plot_detectron_classification(base, conf, alpha=0.6))
        out_path = os.path.join(args.output_folder, f"{name}_{args.model_name}_trav.png")
        Image.fromarray((np.clip(np.concatenate(panels, axis=1), 0, 1) * 255).astype(np.uint8)).save(out_path)
        print(f"[{i + 1}/{len(frames)}] {name}: {dt * 1e3:.1f} ms -> {out_path}")


if __name__ == "__main__":
    main()
