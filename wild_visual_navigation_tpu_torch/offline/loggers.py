"""Metric-logger factory for offline training.

Copy of wild_visual_navigation_tpu/offline/loggers.py: the reference's
Neptune / W&B / TensorBoard factory by name, with the cloud loggers mapped
to a CSV logger. TensorBoard's writer is imported when that logger is
built, so a machine without the `tensorboard` package only lacks that
logger; the port's own paths log to CSV.
"""

from __future__ import annotations

import csv
import os
from typing import Dict


class CSVLogger:
    def __init__(self, folder: str, name: str = "metrics.csv"):
        os.makedirs(folder, exist_ok=True)
        self.path = os.path.join(folder, name)
        self._fieldnames = None

    def log_metrics(self, metrics: Dict, step: int = 0):
        row = {"step": step, **metrics}
        new = self._fieldnames is None
        if new:
            self._fieldnames = list(row.keys())
        with open(self.path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self._fieldnames, extrasaction="ignore")
            if new:
                w.writeheader()
            w.writerow(row)

    def finalize(self):
        pass


class TensorBoardLogger:
    def __init__(self, folder: str):
        from torch.utils.tensorboard import SummaryWriter

        self._writer = SummaryWriter(log_dir=folder)

    def log_metrics(self, metrics: Dict, step: int = 0):
        for k, v in metrics.items():
            try:
                self._writer.add_scalar(k, float(v), step)
            except (TypeError, ValueError):
                continue

    def finalize(self):
        self._writer.flush()


def get_logger(logger_name: str, folder: str):
    """Name registry like the reference's get_logger."""
    registry = {
        "csv": CSVLogger,
        "tensorboard": TensorBoardLogger,
        # the reference's cloud loggers map to local equivalents here
        "neptune": CSVLogger,
        "wandb": CSVLogger,
    }
    if logger_name not in registry:
        raise ValueError(f"logger [{logger_name}] not registered; have {sorted(registry)}")
    return registry[logger_name](folder)
