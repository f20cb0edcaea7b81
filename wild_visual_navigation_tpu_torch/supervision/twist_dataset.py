"""Time-aligned twist-log dataset.

Port of wild_visual_navigation_tpu/supervision/twist_dataset.py (the
reference's TwistDataset / TwistDataModule): CSV logs of the current and
desired robot twists (columns #sec, nsec, vx..wz), nearest-timestamp
alignment within 10 ms, windowed sequence access and a train / val split.
Host-side, numpy out, as in the JAX package. pandas is imported where a
log is read, so importing this module needs none.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

_HEADER_RENAME = {
    "#sec": "sec",
    "vx [m/s]": "vx",
    "vy [m/s]": "vy",
    "vz [m/s]": "vz",
    "wx [rad/s]": "wx",
    "wy [rad/s]": "wy",
    "wz [rad/s]": "wz",
}
_VELOCITIES = ["vx", "vy", "vz", "wx", "wy", "wz"]


def _load_twist_csv(path: str):
    import pandas as pd

    df = pd.read_csv(path).rename(columns=_HEADER_RENAME)
    df["ts"] = df["sec"].astype(np.float64) + df["nsec"].astype(np.float64) * 1e-9
    return df.sort_values("ts").reset_index(drop=True)


class TwistDataset:
    def __init__(
        self,
        root: str,
        current_filename: str,
        desired_filename: str,
        mode: str = "train",
        percentage: float = 0.8,
        seq_size: int = 8,
        velocities: List[str] = _VELOCITIES,
        ts_matching_thr: str = "10ms",
    ):
        import pandas as pd

        cur = _load_twist_csv(os.path.join(root, current_filename))
        des = _load_twist_csv(os.path.join(root, desired_filename))
        cur.index = pd.to_datetime(cur["ts"], unit="s")
        des.index = pd.to_datetime(des["ts"], unit="s")
        merged = pd.merge_asof(left=cur, right=des, left_index=True, right_index=True, direction="nearest",
                               tolerance=pd.Timedelta(ts_matching_thr))
        merged = merged.reset_index(drop=True)
        size = len(merged)
        if mode == "train":
            lo, hi = 0, int(size * percentage)
        elif mode == "val":
            lo, hi = int(size * percentage), size
        else:
            raise ValueError(f"Mode unknown [{mode}]")

        self.timestamps = merged["ts_x"].to_numpy()[lo:hi, None]
        self.current_twist = merged[[f"{v}_x" for v in velocities]].to_numpy(np.float32)[lo:hi]
        # a desired twist with no match within the tolerance is NaN: zeros, as a dropped message
        self.desired_twist = np.nan_to_num(merged[[f"{v}_y" for v in velocities]].to_numpy(np.float32)[lo:hi])
        self.size = self.current_twist.shape[0]
        self.seq_size = min(seq_size, self.size)

    def __len__(self) -> int:
        return self.size

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        if idx + self.seq_size > self.size:
            idx = self.size - self.seq_size
        sl = slice(idx, idx + self.seq_size)
        return self.timestamps[sl], self.current_twist[sl], self.desired_twist[sl]


class TwistDataModule:
    """The train / val pair; batches are numpy windows (the offline
    trainer reads numpy, as the JAX package's does)."""

    def __init__(self, root: str, current_filename: str, desired_filename: str, batch_size: int = 32, **kwargs):
        self.train = TwistDataset(root, current_filename, desired_filename, mode="train", **kwargs)
        self.val = TwistDataset(root, current_filename, desired_filename, mode="val", **kwargs)
        self.batch_size = batch_size

    def train_batches(self):
        for i in range(0, len(self.train), self.batch_size):
            yield self.train[i]

    def val_batches(self):
        for i in range(0, len(self.val), self.batch_size):
            yield self.val[i]
