"""Image folder -> graph-dataset generator.

Port of the repository's tools/generate_dataset.py, the equivalent of the
reference's dataset-generation scripts:

  * ``create_gnn_dataset.py``: SLIC superpixels -> per-segment backbone
    features -> STEGO linear-probe semantic labels (majority vote inside
    each superpixel) -> segment adjacency graph, one record per image;
  * ``extract_features_for_dataset.py``: per-frame features plus KLT
    optical-flow correspondences of the segment centres between
    consecutive frames (ops/optical_flow.py::track_points);
  * ``create_train_val_test_lists.py``: ``{name}_{train,val,test}.txt``
    split lists: the first 80 % train, the rest val (the reference's
    temporal split), every Nth record also test.

Each record is one ``graph_{i:04d}.npz``, key for key the JAX tool's:
feat (S, D), seg (H, W), edges (2, E) + edge_valid, centers (S, 2) +
center_valid, label (S,) int32 semantic class (-1 with --labels none or for
an empty segment), flow_next (S, 2) + flow_good (S,) KLT correspondences
into the next image (zeros for the last), source.

`generate` is the whole loop on decoded images and built extractors;
`main` adds argument parsing and `load_images`.

Usage:
  python -m wild_visual_navigation_tpu_torch.tools.generate_dataset --images DIR --name my_mission \\
      --feature dinov2 --labels stego --size 448 [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

import numpy as np
import torch

from ..feature_extractor.feature_extractor import FeatureExtractor
from ..feature_extractor.stego import StegoInterface
from ..ops import segment_ops
from ..ops.optical_flow import track_points
from ..utils.devices import torch_device


def load_images(folder: str, size: int):
    """(names, [(3, size, size) float32 in [0, 1]]) of the folder's images,
    in name order (PIL is imported here)."""
    from PIL import Image

    paths = sorted(p for p in Path(folder).iterdir() if p.suffix.lower() in (".png", ".jpg", ".jpeg"))
    if not paths:
        raise SystemExit(f"no images under {folder}")
    out = []
    for p in paths:
        img = Image.open(p).convert("RGB").resize((size, size), Image.BILINEAR)
        out.append(np.asarray(img, dtype=np.float32).transpose(2, 0, 1) / 255.0)
    return [str(p) for p in paths], out


def majority_labels(seg: torch.Tensor, linear: torch.Tensor, n_segments: int, n_classes: int = 27) -> torch.Tensor:
    """Per-superpixel majority vote over the STEGO linear-probe classes (the
    reference's most often predicted class in each segment); -1 where a
    segment has no pixel."""
    onehot = torch.nn.functional.one_hot(linear.long(), n_classes).permute(2, 0, 1).float()  # (C, H, W)
    pooled, counts = segment_ops.segment_mean_pool(onehot, seg, n_segments)
    label = torch.argmax(pooled, dim=-1).to(torch.int32)
    return torch.where(counts > 0, label, -1)


def build_extractors(feature: str = "dinov2", seg: str = "slic", size: int = 448, slic_components: int = 100,
                     labels: str = "stego", device="cuda", dtype: torch.dtype = torch.bfloat16,
                     backbone_params=None, stego_backbone_params=None, stego_head_params=None):
    """The tool's extractors: the facade from seed 0 and, for stego labels,
    StegoInterface from seed 1 without clustering (the JAX tool's keys 0 and
    1). The params arguments are state dicts that replace seeded weights."""
    dev = torch_device(device, "generate_dataset")
    fe = FeatureExtractor(seed=0, segmentation_type=seg, feature_type=feature, input_size=size,
                          slic_num_components=slic_components, device=dev, dtype=dtype,
                          backbone_params=backbone_params)
    stego = None
    if labels == "stego":
        stego = StegoInterface(seed=1, input_size=size, run_clustering=False, dtype=dtype, device=dev,
                               backbone_params=stego_backbone_params, head_params=stego_head_params)
    return fe, stego


def generate(images, names, fe: FeatureExtractor, stego: StegoInterface | None, out: str, name: str,
             percentage: float = 0.8, every_n_test: int = 2) -> dict:
    """Extract, label and track every image, write the records, the split
    lists and meta.json under out/name; returns the meta dict."""
    dev = fe.device
    imgs = [torch.as_tensor(np.asarray(img, np.float32)).to(dev) for img in images]
    base = Path(out) / name
    os.makedirs(base, exist_ok=True)
    extractions = []
    for img in imgs:
        ex = fe.extract(img[None])
        S = ex.features.shape[0]
        if stego is not None:
            stego.inference(img[None])
            label = majority_labels(ex.segments, stego.linear_segments[0], S)
        else:
            label = torch.full((S,), -1, dtype=torch.int32, device=dev)
        extractions.append((ex, label))

    records = []
    for i, (ex, label) in enumerate(extractions):
        S = ex.features.shape[0]
        if i + 1 < len(imgs):
            nxt, good = track_points(imgs[i], imgs[i + 1], ex.centers)
        else:
            nxt = torch.zeros_like(ex.centers)
            good = torch.zeros((S,), dtype=torch.bool, device=dev)
        rec = base / f"graph_{i:04d}.npz"
        np.savez_compressed(
            rec,
            source=names[i],
            feat=ex.features.float().cpu().numpy(),
            seg=ex.segments.to(torch.int32).cpu().numpy(),
            edges=ex.edges.to(torch.int32).cpu().numpy(),
            edge_valid=ex.edge_valid.bool().cpu().numpy(),
            centers=ex.centers.float().cpu().numpy(),
            center_valid=ex.center_valid.bool().cpu().numpy(),
            label=label.to(torch.int32).cpu().numpy(),
            flow_next=nxt.float().cpu().numpy(),
            flow_good=good.bool().cpu().numpy(),
        )
        records.append(rec.name)
        print(f"{rec.name}: {names[i]}  S={S} D={ex.features.shape[1]} "
              f"classes={int((label >= 0).sum())} seg valid", flush=True)

    # the split lists (create_train_val_test_lists.py's semantics)
    n_train = int(len(records) * percentage)
    splits = {"train": records[:n_train], "val": records[n_train:], "test": records[::every_n_test]}
    for mode, items in splits.items():
        with open(base / f"{name}_{mode}.txt", "w") as f:
            f.write("\n".join(items) + ("\n" if items else ""))

    meta = {
        "name": name, "images": len(records), "size": int(imgs[0].shape[-1]) if imgs else 0,
        "seg": fe.segmentation_type, "feature": fe.feature_type, "labels": "stego" if stego is not None else "none",
        "feature_dim": int(fe.feature_dim),
        "splits": {k: len(v) for k, v in splits.items()},
    }
    with open(base / "meta.json", "w") as f:
        json.dump(meta, f, indent=1)
    return meta


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--images", type=str, required=True, help="folder of .png / .jpg images, read in name order")
    ap.add_argument("--name", type=str, default="reference_images")
    ap.add_argument("--out", type=str, default="results/datasets_torch")
    ap.add_argument("--size", type=int, default=448)
    ap.add_argument("--seg", type=str, default="slic")
    ap.add_argument("--feature", type=str, default="dinov2")
    ap.add_argument("--labels", type=str, default="stego", choices=["stego", "none"])
    ap.add_argument("--slic_components", type=int, default=100)
    ap.add_argument("--percentage", type=float, default=0.8, help="head fraction -> train, tail -> val")
    ap.add_argument("--every_n_test", type=int, default=2, help="every Nth record also lands in the test list")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    fe, stego = build_extractors(args.feature, args.seg, args.size, args.slic_components, args.labels, args.device)
    names, images = load_images(args.images, args.size)
    meta = generate(images, names, fe, stego, args.out, args.name, args.percentage, args.every_n_test)
    print(json.dumps(meta))
    return 0


if __name__ == "__main__":
    sys.exit(main())
