"""Overlay a traversability map onto its camera image.

Equivalent of the reference's overlay_images node
(the reference repository's wild_visual_navigation_ros/scripts/overlay_images.py:14-51):
synchronized (image, traversability) -> colormapped overlay. Offline
CLI form: pairs of PNGs (or an image + .npy map) in, overlay PNGs out.

A copy of wild_visual_navigation_tpu/scripts/overlay_images.py, drawing
with the port's visu/. Run: `python -m
wild_visual_navigation_tpu_torch.scripts.overlay_images --image a.png
--trav t.npy --out o.png` (needs PIL).
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path

import numpy as np


def overlay(image: np.ndarray, traversability: np.ndarray, alpha: float = 0.5) -> np.ndarray:
    from ..visu import LearningVisualizer

    return LearningVisualizer().plot_detectron_classification(image, traversability, alpha=alpha)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--image", required=True)
    ap.add_argument("--trav", required=True, help="PNG (grayscale) or .npy traversability map")
    ap.add_argument("--out", required=True)
    ap.add_argument("--alpha", type=float, default=0.5)
    args = ap.parse_args()

    from PIL import Image

    img = np.asarray(Image.open(args.image).convert("RGB"), dtype=np.float32) / 255.0
    if args.trav.endswith(".npy"):
        trav = np.load(args.trav)
    else:
        trav = np.asarray(Image.open(args.trav).convert("L"), dtype=np.float32) / 255.0
    out = overlay(img, trav, alpha=args.alpha)
    Path(os.path.dirname(args.out) or ".").mkdir(parents=True, exist_ok=True)
    Image.fromarray((np.clip(out, 0, 1) * 255).astype(np.uint8)).save(args.out)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
