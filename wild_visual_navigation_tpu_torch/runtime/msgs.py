"""Message types + binary serialization for process-separated deployment.

A copy of wild_visual_navigation_tpu/runtime/msgs.py (it imports no JAX).

Equivalent of the reference's wild_visual_navigation_msgs package
(msg/{CustomState,RobotState,SystemState,ImageFeatures}.msg and
srv/{SaveCheckpoint,LoadCheckpoint}.srv) without ROS IDL: plain
dataclasses with compact binary codecs suitable for the native ring
buffer or any socket. The ImageFeatures codec replaces the reference's
Float32MultiArray python-list serialization hot spot
(wvn_feature_extractor_node.py:390) with raw little-endian buffers.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import List

import numpy as np


@dataclass
class CustomState:
    """reference CustomState.msg: name + arbitrary float vector."""

    name: str = ""
    values: np.ndarray = field(default_factory=lambda: np.zeros(0))


@dataclass
class RobotState:
    """reference RobotState.msg: header + pose + twist + custom states."""

    stamp: float = 0.0
    pose: np.ndarray = field(default_factory=lambda: np.array([0, 0, 0, 0, 0, 0, 1.0]))  # xyz + quat xyzw
    twist: np.ndarray = field(default_factory=lambda: np.zeros(6))
    states: List[CustomState] = field(default_factory=list)


@dataclass
class SystemStateMsg:
    """reference SystemState.msg."""

    mode: int = 1
    mission_graph_num_valid_node: int = 0
    step: int = 0
    loss_total: float = -1.0
    loss_trav: float = -1.0
    loss_reco: float = -1.0
    pause_learning: bool = False

    _FMT = "<iii ddd ?"

    def pack(self) -> bytes:
        return struct.pack(self._FMT, self.mode, self.mission_graph_num_valid_node, self.step,
                           self.loss_total, self.loss_trav, self.loss_reco, self.pause_learning)

    @classmethod
    def unpack(cls, buf: bytes) -> "SystemStateMsg":
        vals = struct.unpack(cls._FMT, buf[: struct.calcsize(cls._FMT)])
        return cls(*vals)


@dataclass
class ImageFeatures:
    """reference ImageFeatures.msg: header + segments image + (n, D)
    feature matrix + camera geometry (carried alongside in the
    reference via separate CameraInfo messages)."""

    stamp: float = 0.0
    camera: str = ""
    segments: np.ndarray = field(default_factory=lambda: np.zeros((0, 0), np.int32))  # (H, W)
    features: np.ndarray = field(default_factory=lambda: np.zeros((0, 0), np.float32))  # (S, D)
    feat_valid: np.ndarray = field(default_factory=lambda: np.zeros(0, bool))  # (S,)
    K_scaled: np.ndarray = field(default_factory=lambda: np.eye(3, dtype=np.float32))
    pose_base_in_world: np.ndarray = field(default_factory=lambda: np.eye(4))
    pose_cam_in_base: np.ndarray = field(default_factory=lambda: np.eye(4))

    def pack(self) -> bytes:
        cam = self.camera.encode()
        seg = np.ascontiguousarray(self.segments, dtype=np.int32)
        feat = np.ascontiguousarray(self.features, dtype=np.float32)
        fv = np.ascontiguousarray(self.feat_valid, dtype=np.uint8)
        K = np.ascontiguousarray(self.K_scaled, dtype=np.float32)
        pb = np.ascontiguousarray(self.pose_base_in_world, dtype=np.float64)
        pc = np.ascontiguousarray(self.pose_cam_in_base, dtype=np.float64)
        header = struct.pack(
            "<dI4i", self.stamp, len(cam), seg.shape[0], seg.shape[1], feat.shape[0], feat.shape[1]
        )
        return b"".join([header, cam, seg.tobytes(), feat.tobytes(), fv.tobytes(), K.tobytes(),
                         pb.tobytes(), pc.tobytes()])

    @classmethod
    def unpack(cls, buf: bytes) -> "ImageFeatures":
        off = struct.calcsize("<dI4i")
        stamp, cam_len, h, w, s, d = struct.unpack("<dI4i", buf[:off])
        camera = buf[off : off + cam_len].decode()
        off += cam_len
        seg = np.frombuffer(buf, np.int32, h * w, off).reshape(h, w)
        off += 4 * h * w
        feat = np.frombuffer(buf, np.float32, s * d, off).reshape(s, d)
        off += 4 * s * d
        fv = np.frombuffer(buf, np.uint8, s, off).astype(bool)
        off += s
        K = np.frombuffer(buf, np.float32, 9, off).reshape(3, 3)
        off += 36
        pb = np.frombuffer(buf, np.float64, 16, off).reshape(4, 4)
        off += 128
        pc = np.frombuffer(buf, np.float64, 16, off).reshape(4, 4)
        return cls(stamp=stamp, camera=camera, segments=seg.copy(), features=feat.copy(),
                   feat_valid=fv, K_scaled=K.copy(), pose_base_in_world=pb.copy(), pose_cam_in_base=pc.copy())


@dataclass
class SaveCheckpointRequest:
    """reference srv/SaveCheckpoint.srv."""

    mission_path: str = ""
    checkpoint_name: str = "last_checkpoint.ckpt"


@dataclass
class LoadCheckpointRequest:
    """reference srv/LoadCheckpoint.srv."""

    checkpoint_path: str = ""


@dataclass
class ServiceResponse:
    success: bool = False
    message: str = ""
