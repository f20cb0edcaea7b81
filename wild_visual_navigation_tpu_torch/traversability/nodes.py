"""Pose-graph node types (host-side metadata + device payloads).

A copy of wild_visual_navigation_tpu/traversability/nodes.py, which is
numpy only; the port keeps its own copy so that it never imports the JAX
package. Upstream WVN's node classes live in its
traversability_estimator/nodes.py:21-664. Nodes here are light host objects: poses/timestamps live in numpy (the
graph gating math runs at callback rate on the host — pushing 4x4
matrix ops through the device per node would cost a dispatch each),
while the bulk training payload (features, masks, signals) lives in the
estimator's device-resident ring buffer, indexed by `buffer_slot`.

SE(3)-log distance (reference nodes.py:76-93) is computed in numpy with
the same Jinv formula as utils/lie.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np


def _so3_log_np(R: np.ndarray) -> np.ndarray:
    tr = np.clip((np.trace(R) - 1.0) * 0.5, -1.0, 1.0)
    theta = np.arccos(tr)
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    if tr < -1.0 + 1e-5:
        # theta ~ pi: vee(R - R^T) degenerates; recover the axis from
        # (R + R^T)/2 - cos(t) I = (1 - cos t) a a^T (dominant column),
        # sign from the residual skew part (immaterial at exactly pi).
        S = 0.5 * (R + R.T) - tr * np.eye(3)
        col = S[:, int(np.argmax(np.diag(S)))]
        axis = col / (np.linalg.norm(col) + 1e-12)
        if float(axis @ w) < 0.0:
            axis = -axis
        return theta * axis
    if theta < 1e-6:
        scale = 0.5 + theta * theta / 12.0
    else:
        scale = theta / (2.0 * np.sin(theta))
    return scale * w


def _hat_np(v):
    return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])


def se3_log_translation_np(T: np.ndarray) -> np.ndarray:
    """rho component of SE(3) log (what distance_to norms)."""
    R, t = T[:3, :3], T[:3, 3]
    phi = _so3_log_np(R)
    theta2 = float(phi @ phi)
    K = _hat_np(phi)
    if theta2 < 1e-8:
        cot_coeff = 1.0 / 12.0 + theta2 / 720.0
    else:
        theta = np.sqrt(theta2)
        half = theta * 0.5
        cot_coeff = (1.0 - half * np.cos(half) / np.sin(half)) / theta2
    Jinv = np.eye(3) - 0.5 * K + cot_coeff * (K @ K)
    return Jinv @ t


def pose_distance_np(T_a: np.ndarray, T_b: np.ndarray) -> float:
    rel = np.linalg.inv(T_a) @ T_b
    return float(np.linalg.norm(se3_log_translation_np(rel)))


def _so3_log_batch_np(R: np.ndarray) -> np.ndarray:
    """Vectorized _so3_log_np over a batch (N, 3, 3) -> (N, 3), with the
    same theta~0 series and theta~pi axis-recovery branches."""
    tr = np.clip((R[:, 0, 0] + R[:, 1, 1] + R[:, 2, 2] - 1.0) * 0.5, -1.0, 1.0)
    theta = np.arccos(tr)
    theta2 = theta * theta
    w = np.stack(
        [R[:, 2, 1] - R[:, 1, 2], R[:, 0, 2] - R[:, 2, 0], R[:, 1, 0] - R[:, 0, 1]], axis=-1
    )
    small = theta2 < 1e-12
    near_pi = tr < -1.0 + 1e-5
    sin_safe = np.where(small | near_pi, 1.0, np.sin(theta))
    scale = np.where(small, 0.5 + theta2 / 12.0, theta / (2.0 * sin_safe))
    out = scale[:, None] * w
    if near_pi.any():
        S = 0.5 * (R + np.swapaxes(R, -1, -2)) - tr[:, None, None] * np.eye(3)
        diag = np.stack([S[:, 0, 0], S[:, 1, 1], S[:, 2, 2]], axis=-1)
        k = np.argmax(diag, axis=-1)
        col = S[np.arange(R.shape[0]), :, k]
        axis = col / (np.linalg.norm(col, axis=-1, keepdims=True) + 1e-12)
        sgn = np.where(np.sum(axis * w, axis=-1) < 0.0, -1.0, 1.0)
        out = np.where(near_pi[:, None], (theta * sgn)[:, None] * axis, out)
    return out


def se3_trans_dist_batch_np(T0: np.ndarray, Ts: np.ndarray) -> np.ndarray:
    """||se3_log(T0^{-1} T_n)[:3]|| for a pose batch, fully vectorized.

    T0: (4, 4); Ts: (N, 4, 4) -> (N,). Matches pose_distance_np
    elementwise — this is the hot radius-range / window-eviction query
    (reference graphs.py:154-184 ran per-pair liegroups on host)."""
    if Ts.shape[0] == 0:
        return np.zeros((0,))
    R0, t0 = T0[:3, :3], T0[:3, 3]
    R = Ts[:, :3, :3]
    t = Ts[:, :3, 3]
    R_rel = np.einsum("ji,njk->nik", R0, R)  # R0^T R_n
    t_rel = (t - t0) @ R0  # row-vector form of R0^T (t_n - t0)
    phi = _so3_log_batch_np(R_rel)
    theta2 = np.sum(phi * phi, axis=-1)
    small = theta2 < 1e-12
    theta2_safe = np.where(small, 1.0, theta2)
    theta = np.sqrt(theta2_safe)
    half = theta * 0.5
    cot_coeff = np.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * np.cos(half) / np.where(small, 1.0, np.sin(half))) / theta2_safe,
    )
    x, y, z = phi[:, 0], phi[:, 1], phi[:, 2]
    zero = np.zeros_like(x)
    K = np.stack(
        [
            np.stack([zero, -z, y], axis=-1),
            np.stack([z, zero, -x], axis=-1),
            np.stack([-y, x, zero], axis=-1),
        ],
        axis=-2,
    )
    Jinv = np.eye(3) - 0.5 * K + cot_coeff[:, None, None] * (K @ K)
    rho = np.einsum("nij,nj->ni", Jinv, t_rel)
    return np.linalg.norm(rho, axis=-1)


@dataclass(eq=False)
class BaseNode:
    """reference nodes.py:21-114.

    eq=False: identity equality + default hashing. The generated
    field-tuple __eq__ would compare numpy pose arrays (ambiguous
    truth value -> ValueError for distinct nodes with equal
    timestamps, e.g. a synced camera rig) and set __hash__ = None,
    making nodes unusable as graph/dict keys."""

    timestamp: float = 0.0
    pose_base_in_world: np.ndarray = field(default_factory=lambda: np.eye(4, dtype=np.float64))
    _name: str = "base_node"

    def __str__(self):
        return f"{self._name}_{self.timestamp}"

    def __lt__(self, other):
        return self.timestamp < other.timestamp

    def is_valid(self) -> bool:
        return True

    def pose_between(self, other: "BaseNode") -> np.ndarray:
        return np.linalg.inv(other.pose_base_in_world) @ self.pose_base_in_world

    def distance_to(self, other: "BaseNode") -> float:
        return pose_distance_np(self.pose_base_in_world, other.pose_base_in_world)


@dataclass(eq=False)
class MissionNode(BaseNode):
    """Camera frame node (reference nodes.py:116-440). The heavy
    per-frame tensors are stored in the estimator's device ring buffer;
    this object carries the slot index plus camera geometry."""

    _name: str = "mission_node"
    camera_name: str = "cam"
    pose_cam_in_base: np.ndarray = field(default_factory=lambda: np.eye(4, dtype=np.float64))
    pose_cam_in_world: Optional[np.ndarray] = None
    buffer_slot: int = -1  # index into the MissionBuffer
    use_for_training: bool = True
    # bookkeeping mirrors of buffer state (filled lazily for visu)
    _has_supervision: bool = False

    def __post_init__(self):
        if self.pose_cam_in_world is None:
            self.pose_cam_in_world = self.pose_base_in_world @ self.pose_cam_in_base

    def is_valid(self) -> bool:
        # True once the buffer holds any valid supervision signal for
        # this slot (reference nodes.py:243-251); maintained by the
        # estimator after each reprojection update.
        return self._has_supervision


@dataclass(eq=False)
class SupervisionNode(BaseNode):
    """Proprioception node (reference nodes.py:443-618)."""

    _name: str = "supervision_node"
    pose_footprint_in_base: np.ndarray = field(default_factory=lambda: np.eye(4, dtype=np.float64))
    pose_footprint_in_world: Optional[np.ndarray] = None
    twist_in_base: Optional[np.ndarray] = None
    desired_twist_in_base: Optional[np.ndarray] = None
    length: float = 0.1
    width: float = 0.1
    height: float = 0.1
    traversability: float = 0.0
    traversability_var: float = 1.0
    is_untraversable: bool = False

    def __post_init__(self):
        if self.pose_footprint_in_world is None:
            self.pose_footprint_in_world = self.pose_base_in_world @ self.pose_footprint_in_base

    def is_valid(self) -> bool:
        return self.twist_in_base is not None

    def get_side_points(self) -> np.ndarray:
        """Two lateral footprint points in world (reference :516-519)."""
        pts = np.array([[0.0, -self.width / 2, 0.0, 1.0], [0.0, self.width / 2, 0.0, 1.0]])
        return (self.pose_footprint_in_world @ pts.T).T[:, :3]

    def get_untraversable_plane(self, grid_size: int = 5) -> np.ndarray:
        """Vertical 'collision wall' in the motion direction
        (reference :521-551)."""
        v = self.twist_in_base[:2] if self.twist_in_base is not None else np.array([1.0, 0.0])
        n = np.linalg.norm(v)
        motion = v / n if n > 1e-9 else np.array([1.0, 0.0])
        z_angle = np.arctan2(motion[1], motion[0])
        c, s = np.cos(z_angle), np.sin(z_angle)
        T_bp = np.eye(4)
        T_bp[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        T_bp[:3, 3] = [0.5 * self.length * motion[0], 0.5 * self.length * motion[1], -self.height / 2]
        T_wp = self.pose_base_in_world @ T_bp
        ys = np.linspace(-0.25 * self.width, 0.25 * self.width, grid_size)
        zs = np.linspace(-self.height / 2, self.height / 2, grid_size)
        yy, zz = np.meshgrid(ys, zs, indexing="xy")
        pts = np.stack([np.zeros_like(yy).ravel(), yy.ravel(), zz.ravel(), np.ones(yy.size)], axis=-1)
        return (T_wp @ pts.T).T[:, :3]

    def make_footprint_with_node(self, other: "SupervisionNode", grid_size: int = 10) -> np.ndarray:
        """Footprint polygon between two supervision nodes, or the
        collision wall when untraversable (reference :553-572). Returns
        (P, 3) world points; duplicates are fine (consumers hull)."""
        if self.is_untraversable:
            return self.get_untraversable_plane(grid_size=grid_size)
        tsp = self.get_side_points()[::-1]  # swap to make counterclockwise
        osp = other.get_side_points()
        corners = np.concatenate([tsp, osp], axis=0)  # (4, 3)
        w = np.linspace(0, 1, grid_size)[None, :, None]
        nxt = np.roll(corners, -1, axis=0)
        interp = corners[:, None, :] * (1 - w) + nxt[:, None, :] * w
        return interp.reshape(-1, 3)

    def update_traversability(self, traversability: float, traversability_var: float):
        """Pessimistic update (reference :574-578)."""
        if traversability < self.traversability:
            self.traversability = traversability
            self.traversability_var = traversability_var


@dataclass(eq=False)
class TwistNode(BaseNode):
    """reference nodes.py:620-664."""

    _name: str = "twist_node"
    desired_twist: Optional[np.ndarray] = None
    current_twist: Optional[np.ndarray] = None

    def is_valid(self) -> bool:
        return self.desired_twist is not None and self.current_twist is not None
