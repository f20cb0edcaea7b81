"""Mission postprocessing: log replay outputs + plot learning curves.

Equivalent of the reference's postprocessing scripts
(the reference repository's wild_visual_navigation_ros/scripts/postprocessing/
{postprocess_logger.py, plot_learning_curves_step.py}): subscribe to the
runtime outputs during a mission/replay, store overlay images and a CSV
of learning curves, then render step plots.

A copy of wild_visual_navigation_tpu/scripts/postprocess_logger.py, but
for its image panel: the JAX package draws it with visu/ (ROADMAP.md
Queue 1, Slice 5, not ported yet); here it is the input beside the two
maps in a red-to-green ramp, in numpy.
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


def _ramp(m: np.ndarray) -> np.ndarray:
    """(H, W) in [0, 1] -> (H, W, 3): red at 0, green at 1."""
    m = np.clip(np.asarray(m, np.float32), 0, 1)
    return np.stack([1.0 - m, m, np.zeros_like(m)], axis=-1)


def prediction_panel(image: np.ndarray, traversability: np.ndarray, confidence: Optional[np.ndarray]) -> np.ndarray:
    """(3, H, W) or (H, W, 3) image in [0, 1] beside the traversability
    and confidence maps: (H, 3W, 3) float in [0, 1]."""
    img = np.asarray(image, np.float32)
    if img.shape[0] == 3 and img.ndim == 3:
        img = img.transpose(1, 2, 0)
    if img.dtype == np.uint8 or img.max() > 1.0:
        img = img / 255.0
    tiles = [img, _ramp(traversability)] + ([_ramp(confidence)] if confidence is not None else [])
    h = min(t.shape[0] for t in tiles)
    return np.concatenate([t[:h] for t in tiles], axis=1)


@dataclass
class MissionLogger:
    folder: str
    store_images: bool = True
    rows: List[dict] = field(default_factory=list)
    _img_count: int = 0

    def __post_init__(self):
        os.makedirs(self.folder, exist_ok=True)
        if self.store_images:
            os.makedirs(os.path.join(self.folder, "images"), exist_ok=True)

    def log_system_state(self, step: int, loss_total: float, loss_trav: float, loss_reco: float,
                         num_valid_nodes: int, stamp: float = 0.0):
        self.rows.append({
            "stamp": stamp, "step": step, "loss_total": loss_total,
            "loss_trav": loss_trav, "loss_reco": loss_reco, "num_valid_nodes": num_valid_nodes,
        })

    def log_inference(self, image: np.ndarray, traversability: np.ndarray,
                      confidence: Optional[np.ndarray], stamp: float):
        if not self.store_images:
            return
        panel = prediction_panel(image, traversability, confidence)
        from PIL import Image

        path = os.path.join(self.folder, "images", f"{self._img_count:06d}_{stamp:.3f}.png")
        Image.fromarray((np.clip(panel, 0, 1) * 255).astype(np.uint8)).save(path)
        self._img_count += 1

    def store(self) -> str:
        path = os.path.join(self.folder, "learning_curves.csv")
        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=["stamp", "step", "loss_total", "loss_trav", "loss_reco", "num_valid_nodes"])
            w.writeheader()
            for r in self.rows:
                w.writerow(r)
        return path

    def plot_learning_curves(self) -> Optional[str]:
        """plot_learning_curves_step.py equivalent."""
        if not self.rows:
            return None
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        steps = [r["step"] for r in self.rows if r["loss_total"] > 0]
        keys = ["loss_total", "loss_trav", "loss_reco"]
        fig, axs = plt.subplots(len(keys) + 1, 1, figsize=(7, 9), sharex=True)
        for ax, k in zip(axs, keys):
            ax.plot(steps, [r[k] for r in self.rows if r["loss_total"] > 0])
            ax.set_ylabel(k)
        axs[-1].plot([r["step"] for r in self.rows], [r["num_valid_nodes"] for r in self.rows])
        axs[-1].set_ylabel("valid nodes")
        axs[-1].set_xlabel("step")
        fig.tight_layout()
        path = os.path.join(self.folder, "learning_curves.png")
        fig.savefig(path, dpi=120)
        plt.close(fig)
        return path
