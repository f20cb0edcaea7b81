"""Marshaling between robot-side message payloads and framework arrays.

A copy of wild_visual_navigation_tpu/runtime/converters.py (it imports no JAX).

Equivalent of the reference's ros_converter.py
(the reference repository's wild_visual_navigation_ros/src/wild_visual_navigation_ros/ros_converter.py:23-171):
odometry/pose/twist <-> matrices, CameraInfo -> (K, H, W), image
conversions. ROS types are replaced by plain dicts/arrays at the same
field granularity, so a thin rospy (or DDS) shim only needs to copy
fields — all geometry goes through utils/lie + numpy, no tf2.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from ..traversability.nodes import _so3_log_np  # noqa: F401 (re-export convenience)


def _quat_to_rot_np(q: np.ndarray) -> np.ndarray:
    x, y, z, w = q / (np.linalg.norm(q) + 1e-12)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def _rot_to_quat_np(R: np.ndarray) -> np.ndarray:
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([(R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s, 0.25 * s])
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(R[i, i] - R[j, j] - R[k, k] + 1.0) * 2
    q = np.zeros(4)
    q[i] = 0.25 * s
    q[j] = (R[j, i] + R[i, j]) / s
    q[k] = (R[k, i] + R[i, k]) / s
    q[3] = (R[k, j] - R[j, k]) / s
    return q


def pose_to_se3(position: np.ndarray, orientation_xyzw: np.ndarray) -> np.ndarray:
    """geometry_msgs/Pose fields -> 4x4 (reference ros_converter.py:95-110)."""
    T = np.eye(4)
    T[:3, :3] = _quat_to_rot_np(np.asarray(orientation_xyzw, dtype=np.float64))
    T[:3, 3] = np.asarray(position, dtype=np.float64)
    return T


def se3_to_pose(T: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """4x4 -> (position, quaternion xyzw) (reference :159-171)."""
    return T[:3, 3].copy(), _rot_to_quat_np(T[:3, :3])


def pose7_to_se3(pose7: np.ndarray) -> np.ndarray:
    """[x y z qx qy qz qw] (the native codec layout) -> 4x4."""
    return pose_to_se3(pose7[:3], pose7[3:7])


def se3_to_pose7(T: np.ndarray) -> np.ndarray:
    p, q = se3_to_pose(T)
    return np.concatenate([p, q])


def twist_to_array(linear: np.ndarray, angular: np.ndarray) -> np.ndarray:
    """geometry_msgs/Twist -> (6,) [vx vy vz wx wy wz] (reference :44-60)."""
    return np.concatenate([np.asarray(linear, dtype=np.float64), np.asarray(angular, dtype=np.float64)])


def odometry_to_state(position, orientation_xyzw, linear, angular) -> Tuple[np.ndarray, np.ndarray]:
    """nav_msgs/Odometry fields -> (pose 4x4, twist (6,)) (reference :23-41)."""
    return pose_to_se3(position, orientation_xyzw), twist_to_array(linear, angular)


def camera_info_to_K(camera_info: Dict) -> Tuple[np.ndarray, int, int]:
    """sensor_msgs/CameraInfo-like dict {K: 9 floats row-major, height,
    width} -> ((3,3), H, W) (reference :86-92)."""
    K = np.asarray(camera_info["K"], dtype=np.float64).reshape(3, 3)
    return K, int(camera_info["height"]), int(camera_info["width"])


def anymal_state_to_robot_state(anymal_state: Dict) -> Dict:
    """ANYmal-state-like dict -> RobotState fields — the python twin of
    the reference's C++ converter node (anymal_msg_converter_cpp_node.cpp
    and anymal_msg_converter_node.py:14-60), including the 13-dim
    vector_state [pose7 || twist6] label layout."""
    pose = np.asarray(anymal_state["pose"], dtype=np.float64)  # (7,) xyz+xyzw
    twist = np.asarray(anymal_state["twist"], dtype=np.float64)  # (6,)
    out = {
        "stamp": float(anymal_state.get("stamp", 0.0)),
        "pose": pose,
        "twist": twist,
        "vector_state": np.concatenate([pose, twist]),
        "states": {},
    }
    for key, val in anymal_state.items():
        if key in ("stamp", "pose", "twist"):
            continue
        arr = np.asarray(val, dtype=np.float64)
        if arr.ndim >= 1:
            # joint states, policy latents, etc. — the reference's
            # with-latent converter variant forwards these as
            # CustomStates too (anymal_msg_with_latent_converter_node.py)
            out["states"][key] = arr
    return out


def jackal_state_to_robot_state(odometry: Dict, cmd_vel: Dict) -> Dict:
    """Jackal adapter (reference jackal_state_converter_node.py:69-78):
    Odometry + cmd_vel -> RobotState fields + desired twist."""
    pose, twist = odometry_to_state(
        odometry["position"], odometry["orientation"], odometry["linear"], odometry["angular"]
    )
    desired = twist_to_array(cmd_vel["linear"], cmd_vel["angular"])
    return {
        "stamp": float(odometry.get("stamp", 0.0)),
        "pose": se3_to_pose7(pose),
        "pose_se3": pose,
        "twist": twist,
        "desired_twist": desired,
    }


def policy_debug_info_to_twist(debug_info: np.ndarray, stamp: float = 0.0) -> Dict:
    """Learned-policy debug vector -> desired-twist fields (reference
    policy_debug_info_converter_node.py:13-18): data[0]=vx, data[1]=vy,
    data[2]=wz, everything else zero. Feeds the same desired-twist slot
    jackal_state_to_robot_state fills from cmd_vel."""
    data = np.asarray(debug_info, dtype=np.float64).ravel()
    if data.size < 3:
        raise ValueError(f"debug_info needs >= 3 entries (vx, vy, wz), got {data.size}")
    return {
        "stamp": float(stamp),
        "desired_twist": np.array([data[0], data[1], 0.0, 0.0, 0.0, data[2]]),
    }
