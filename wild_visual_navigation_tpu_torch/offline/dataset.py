"""Offline mission-graph dataset.

Copy of wild_visual_navigation_tpu/offline/dataset.py (numpy only): loads
the npz files written by TraversabilityEstimator.save_graph (per-node
features, supervision signal, validity, segments) and serves fixed-shape
train/val batches.
"""

from __future__ import annotations

import glob
import os
from dataclasses import dataclass
from typing import Iterator, Tuple

import numpy as np


@dataclass
class GraphTravDataset:
    features: np.ndarray  # (N, S, D)
    signal: np.ndarray  # (N, S)
    signal_valid: np.ndarray  # (N, S)
    sample_valid: np.ndarray  # (N, S)

    @classmethod
    def from_folder(cls, folder: str, mode: str = "train", percentage: float = 0.8,
                    shuffle_seed: int | None = None) -> "GraphTravDataset":
        """shuffle_seed: seeded random node split instead of the temporal
        (file-order) split; on short missions the temporal tail is all
        obstacle-region nodes, leaving the val set single-class (used by
        tools/ablation_sweep.py)."""
        files = sorted(glob.glob(os.path.join(folder, "graph_*.npz")))
        if not files:
            raise FileNotFoundError(f"no graph_*.npz exports under {folder}")
        feats, sig, sv, fv = [], [], [], []
        for f in files:
            d = np.load(f)
            feats.append(d["features"])
            sig.append(d["signal"])
            sv.append(d["signal_valid"])
            # feat_valid marks real segment rows against zero padding; the
            # online trainer masks samples with it; older exports lack it
            fv.append(d["feat_valid"] if "feat_valid" in d.files
                      else np.ones_like(d["signal_valid"], dtype=bool))
        features = np.stack(feats)
        signal = np.stack(sig)
        signal_valid = np.stack(sv)
        feat_valid = np.stack(fv)
        n = len(files)
        cut = int(n * percentage)
        if shuffle_seed is not None:
            perm = np.random.RandomState(shuffle_seed).permutation(n)
            sl = perm[:cut] if mode == "train" else perm[cut:]
        else:
            sl = slice(0, cut) if mode == "train" else slice(cut, n)
        return cls(
            features=features[sl],
            signal=signal[sl],
            signal_valid=signal_valid[sl],
            sample_valid=feat_valid[sl],
        )

    def subset(self, idx: np.ndarray) -> "GraphTravDataset":
        """Node-index subset: the k-fold building block
        (tools/ablation_sweep.py --kfold)."""
        return GraphTravDataset(
            features=self.features[idx],
            signal=self.signal[idx],
            signal_valid=self.signal_valid[idx],
            sample_valid=self.sample_valid[idx],
        )

    def shuffled_labels(self, seed: int = 0) -> "GraphTravDataset":
        """Label-shuffle control: permute (signal, signal_valid) jointly
        across all (node, segment) positions, breaking the feature-label
        association while keeping the label marginal. A model trained on
        this must score about chance, the floor every real ablation row has
        to beat (tools/ablation_sweep.py)."""
        rng = np.random.RandomState(seed)
        perm = rng.permutation(self.signal.size)
        shape = self.signal.shape
        return GraphTravDataset(
            features=self.features,
            signal=self.signal.reshape(-1)[perm].reshape(shape),
            signal_valid=self.signal_valid.reshape(-1)[perm].reshape(shape),
            sample_valid=self.sample_valid,
        )

    def __len__(self) -> int:
        return self.features.shape[0]

    def batches(self, batch_size: int, rng: np.random.RandomState, shuffle: bool = True) -> Iterator[Tuple]:
        idx = np.arange(len(self))
        if shuffle:
            rng.shuffle(idx)
        for i in range(0, len(idx) - batch_size + 1, batch_size):
            b = idx[i : i + batch_size]
            yield self.features[b], self.signal[b], self.signal_valid[b], self.sample_valid[b]
