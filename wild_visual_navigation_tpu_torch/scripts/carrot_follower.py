"""Carrot-follower P-controller.

Equivalent of the reference's sim-demo follower
(the reference repository's wild_visual_navigation_jackal/scripts/carrot_follower.py:30-89):
a proportional controller that turns the current pose + carrot goal
into a commanded twist (vx, wz), saturated — the consumer that closes
runtime.get_carrot() into motion commands.

A copy of wild_visual_navigation_tpu/scripts/carrot_follower.py (numpy only).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


@dataclass
class FollowerConfig:
    k_linear: float = 0.8
    k_angular: float = 1.5
    max_linear: float = 1.0
    max_angular: float = 1.0
    goal_tolerance: float = 0.15  # meters
    slow_down_radius: float = 1.0


def follow_carrot(
    pose_base_in_world: np.ndarray,
    goal_xy: Optional[Tuple[float, float]],
    cfg: FollowerConfig = FollowerConfig(),
) -> np.ndarray:
    """(pose 4x4, goal world (x, y)) -> commanded twist (6,)
    [vx 0 0 0 0 wz]; zero twist when no goal or within tolerance."""
    twist = np.zeros(6)
    if goal_xy is None:
        return twist
    pos = pose_base_in_world[:3, 3]
    dx = goal_xy[0] - pos[0]
    dy = goal_xy[1] - pos[1]
    dist = float(np.hypot(dx, dy))
    if dist < cfg.goal_tolerance:
        return twist
    yaw = float(np.arctan2(pose_base_in_world[1, 0], pose_base_in_world[0, 0]))
    heading_err = float(np.arctan2(dy, dx)) - yaw
    heading_err = float(np.arctan2(np.sin(heading_err), np.cos(heading_err)))

    v = cfg.k_linear * min(dist, cfg.slow_down_radius) / cfg.slow_down_radius * cfg.max_linear
    # slow forward motion while turning hard (reference behavior)
    v *= max(0.0, np.cos(heading_err))
    w = np.clip(cfg.k_angular * heading_err, -cfg.max_angular, cfg.max_angular)
    twist[0] = np.clip(v, 0.0, cfg.max_linear)
    twist[5] = w
    return twist
