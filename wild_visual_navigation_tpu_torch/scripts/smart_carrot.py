"""Local goal selection on a traversability/SDF grid ("smart carrot").

Re-design of the reference's smart_carrot node
(the reference repository's wild_visual_navigation_ros/scripts/smart_carrot.py:15-172),
which consumes the elevation-mapping SDF layer fused with WVN's
traversability: combines a distance force (prefer far), a center force
(prefer straight ahead), a yaw-dependent search-pattern mask, and an
invalid-cell dilation mask, then argmaxes for the carrot. Grid-map
messages are replaced by plain numpy grids; the math is identical in
structure and fully vectorized.

A copy of wild_visual_navigation_tpu/scripts/smart_carrot.py (numpy only).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


@dataclass
class CarrotConfig:
    distance_weight: float = 1.0
    center_weight: float = 1.0
    sdf_weight: float = 2.0
    search_half_angle: float = np.deg2rad(60)  # yaw cone (reference :71-87)
    invalid_dilation: int = 2  # cells (reference :89-94)
    min_distance_cells: int = 3


def _dilate_invalid(invalid: np.ndarray, n: int) -> np.ndarray:
    out = invalid.copy()
    for _ in range(n):
        out = (
            out
            | np.roll(out, 1, 0)
            | np.roll(out, -1, 0)
            | np.roll(out, 1, 1)
            | np.roll(out, -1, 1)
        )
    return out


def select_carrot(
    sdf: np.ndarray,
    yaw: float,
    valid: Optional[np.ndarray] = None,
    cfg: CarrotConfig = CarrotConfig(),
) -> Tuple[Optional[Tuple[int, int]], np.ndarray]:
    """Pick the local goal cell on a robot-centered grid.

    sdf: (H, W) signed-distance-to-untraversable layer (higher =
        safer), robot at the center, x forward along +columns.
    yaw: current heading relative to the grid (radians).
    valid: (H, W) bool of observed cells (None = all valid).

    Returns ((row, col) or None, score_map) — mirroring the reference's
    argmax + PoseWithCovarianceStamped publication (:96-160).
    """
    H, W = sdf.shape
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    ys = np.arange(H)[:, None] - cy
    xs = np.arange(W)[None, :] - cx
    dist = np.sqrt(ys**2 + xs**2)

    # distance force: prefer far cells (normalized)
    f_dist = dist / max(dist.max(), 1e-6)
    # center force: prefer cells near the heading ray
    ang = np.arctan2(ys, xs)
    ang_err = np.abs(np.arctan2(np.sin(ang - yaw), np.cos(ang - yaw)))
    f_center = 1.0 - ang_err / np.pi
    # search-pattern mask: the yaw cone
    cone = ang_err <= cfg.search_half_angle
    # invalid dilation
    if valid is None:
        valid = np.ones_like(sdf, dtype=bool)
    invalid = _dilate_invalid(~valid, cfg.invalid_dilation)

    sdf_n = sdf / max(np.abs(sdf).max(), 1e-6)
    score = cfg.distance_weight * f_dist + cfg.center_weight * f_center + cfg.sdf_weight * sdf_n
    score = np.where(cone & ~invalid & (dist >= cfg.min_distance_cells) & (sdf > 0), score, -np.inf)

    if not np.isfinite(score).any():
        return None, score
    idx = np.unravel_index(int(np.argmax(score)), score.shape)
    return (int(idx[0]), int(idx[1])), score


def carrot_to_pose(cell: Tuple[int, int], resolution: float, grid_center_world: np.ndarray) -> np.ndarray:
    """Grid cell -> world (x, y) goal position."""
    H_half = 0.0  # grid is robot-centered; caller passes center world coords
    row, col = cell
    return grid_center_world[:2] + np.array([col, row]) * resolution - np.array([0.0, 0.0])
