"""Misc utilities: experiment folders, dict flattening, confidence
normalisation, the test-image fixture.

Port of wild_visual_navigation_tpu/utils/misc.py. Folders are made under
the checkout's results/ unless a root is given; `load_test_image` returns
a torch tensor.
"""

from __future__ import annotations

import datetime
import os
from pathlib import Path
from typing import Optional

import numpy as np
import torch

ROOT_DIR = str(Path(__file__).resolve().parents[2])  # the checkout holding the package

# the reference's standard fixture; not in the repository, so load_test_image falls back to its seeded image
TEST_IMAGE_PATH = os.path.join(ROOT_DIR, "assets", "images", "forest_clean.png")


def create_experiment_folder(name: str = "debug/debug", timestamp: bool = True, root: Optional[str] = None) -> str:
    """A mission or experiment folder, timestamped unless asked otherwise."""
    root = root or os.path.join(ROOT_DIR, "results")
    path = os.path.join(root, name, datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")) if timestamp \
        else os.path.join(root, name)
    os.makedirs(path, exist_ok=True)
    return path


def flatten_dict(d: dict, parent_key: str = "", sep: str = "_") -> dict:
    items = []
    for k, v in d.items():
        new_key = f"{parent_key}{sep}{k}" if parent_key else str(k)
        if isinstance(v, dict):
            items.extend(flatten_dict(v, new_key, sep=sep).items())
        else:
            items.append((new_key, v))
    return dict(items)


def get_confidence(x: np.ndarray) -> np.ndarray:
    """Min-max normalised confidence (zeros for a constant input)."""
    x = np.asarray(x, dtype=np.float32)
    lo, hi = x.min(), x.max()
    if hi - lo < 1e-12:
        return np.zeros_like(x)
    return (x - lo) / (hi - lo)


def load_test_image(path: str = TEST_IMAGE_PATH) -> torch.Tensor:
    """(1, 3, H, W) float32 in [0, 1]: the image at `path`, or, where it
    cannot be read, the JAX package's seeded 224 x 224 stand-in
    (np.random.RandomState(0).rand(3, 224, 224))."""
    try:
        from PIL import Image

        img = np.asarray(Image.open(path).convert("RGB"), dtype=np.float32) / 255.0
        return torch.from_numpy(np.ascontiguousarray(img.transpose(2, 0, 1)))[None]
    except (ImportError, OSError):
        img = np.random.RandomState(0).rand(3, 224, 224).astype(np.float32)
        return torch.from_numpy(img)[None]


def make_results_folder(name: str) -> str:
    path = os.path.join(ROOT_DIR, "results", name)
    os.makedirs(path, exist_ok=True)
    return path
