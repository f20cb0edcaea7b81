"""Evaluation metrics for offline training.

Copy of wild_visual_navigation_tpu/offline/metrics.py (numpy only). The
reference logs ROC/AUC through torchmetrics in its Lightning module; here
ROC and AUC are small numpy routines, plus threshold selection by Youden's
J like the reference's threshold update.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# numpy 2 renamed trapz; either computes the same trapezoid rule
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def roc_curve(scores: np.ndarray, labels: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (fpr, tpr, thresholds); labels are boolean."""
    order = np.argsort(-scores)
    s, y = scores[order], labels[order].astype(bool)
    P = max(int(y.sum()), 1)
    N = max(int((~y).sum()), 1)
    tps = np.cumsum(y)
    fps = np.cumsum(~y)
    # unique threshold points
    distinct = np.r_[np.where(np.diff(s))[0], len(s) - 1]
    tpr = tps[distinct] / P
    fpr = fps[distinct] / N
    thr = s[distinct]
    return np.r_[0.0, fpr], np.r_[0.0, tpr], np.r_[np.inf, thr]


def auroc(scores: np.ndarray, labels: np.ndarray) -> float:
    fpr, tpr, _ = roc_curve(scores, labels)
    return float(_trapezoid(tpr, fpr))


def optimal_threshold(scores: np.ndarray, labels: np.ndarray) -> float:
    """Youden's J statistic (tpr - fpr) maximizer."""
    fpr, tpr, thr = roc_curve(scores, labels)
    j = tpr - fpr
    i = int(np.argmax(j))
    t = thr[i]
    return float(t if np.isfinite(t) else 0.5)


def accuracy(scores: np.ndarray, labels: np.ndarray, threshold: float = 0.5) -> float:
    return float(((scores >= threshold) == labels.astype(bool)).mean())
