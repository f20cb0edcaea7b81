"""Mission postprocessing: log replay outputs + plot learning curves.

Equivalent of the reference's postprocessing scripts
(the reference repository's wild_visual_navigation_ros/scripts/postprocessing/
{postprocess_logger.py, plot_learning_curves_step.py}): subscribe to the
runtime outputs during a mission/replay, store overlay images and a CSV
of learning curves, then render step plots.

A copy of wild_visual_navigation_tpu/scripts/postprocess_logger.py; the
image panel is visu/'s `LearningVisualizer.plot_mission_node_prediction`.
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


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
        from ..visu import LearningVisualizer

        visu = LearningVisualizer()
        panel = visu.plot_mission_node_prediction(image, traversability, confidence)
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
