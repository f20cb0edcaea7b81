"""Device-resident ring buffer of mission-node training state.

Port of wild_visual_navigation_tpu/traversability/mission_buffer.py:
per-node features, segments, fused supervision masks and per-segment
signals live as fixed-shape stacked tensors on the estimator's device,
so the reprojection update and the training-batch gather are a few
tensor ops with no host marshalling. Where the JAX package rebuilds the
arrays functionally, the port writes its tensors in place.

An unset supervision-mask pixel is +inf (the reference's NaN with fmin
becomes min with an isfinite test).

Rows whose slot is out of range (== capacity: a gated frame or a camera
not used for training) are dropped on the host side of the index. An
out-of-range index on the card is a device-side assert that kills the
CUDA context, so it must never reach `index_put_`.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

UNSET = math.inf


class MissionBuffer(NamedTuple):
    """All tensors share the leading capacity axis N."""

    features: torch.Tensor  # (N, S, D)
    feat_valid: torch.Tensor  # (N, S) bool: the segment exists in the image
    seg: torch.Tensor  # (N, H, W) int32
    supervision_mask: torch.Tensor  # (N, H, W) f32, +inf = unset
    signal: torch.Tensor  # (N, S)
    signal_valid: torch.Tensor  # (N, S) bool
    K: torch.Tensor  # (N, 3, 3) scaled intrinsics
    pose_cam_in_world: torch.Tensor  # (N, 4, 4)
    valid: torch.Tensor  # (N,) bool: slot occupied

    @property
    def capacity(self) -> int:
        return self.features.shape[0]

    @property
    def num_segments(self) -> int:
        return self.features.shape[1]


def buffer_init(capacity: int, num_segments: int, feature_dim: int, height: int, width: int,
                device=None) -> MissionBuffer:
    def eye(n):
        return torch.eye(n, dtype=torch.float32, device=device)[None].repeat(capacity, 1, 1)

    return MissionBuffer(
        features=torch.zeros((capacity, num_segments, feature_dim), dtype=torch.float32, device=device),
        feat_valid=torch.zeros((capacity, num_segments), dtype=torch.bool, device=device),
        seg=torch.zeros((capacity, height, width), dtype=torch.int32, device=device),
        supervision_mask=torch.full((capacity, height, width), UNSET, dtype=torch.float32, device=device),
        signal=torch.zeros((capacity, num_segments), dtype=torch.float32, device=device),
        signal_valid=torch.zeros((capacity, num_segments), dtype=torch.bool, device=device),
        K=eye(3),
        pose_cam_in_world=eye(4),
        valid=torch.zeros((capacity,), dtype=torch.bool, device=device),
    )


def _write(buf: MissionBuffer, slots: torch.Tensor, features, feat_valid, seg, K, pose_cam_in_world) -> MissionBuffer:
    """Rows of the given tensors (on the buffer's device) into `slots`."""
    buf.features[slots] = features.float()
    buf.feat_valid[slots] = feat_valid.bool()
    buf.seg[slots] = seg.to(torch.int32)
    buf.supervision_mask[slots] = UNSET
    buf.signal[slots] = 0.0
    buf.signal_valid[slots] = False
    buf.K[slots] = K.float()
    buf.pose_cam_in_world[slots] = pose_cam_in_world.float()
    buf.valid[slots] = True
    return buf


def buffer_insert(buf: MissionBuffer, slot: int, features, feat_valid, seg, K, pose_cam_in_world) -> MissionBuffer:
    """Write one mission node into `slot`, in place, with a fully unset
    supervision mask; returns the buffer."""
    slot = int(slot)
    if not 0 <= slot < buf.capacity:
        raise IndexError(f"slot {slot} outside the buffer's capacity {buf.capacity}")
    dev = buf.features.device
    return _write(buf, torch.tensor([slot], device=dev),
                  *(torch.as_tensor(a, device=dev)[None] for a in (features, feat_valid, seg, K, pose_cam_in_world)))


def buffer_insert_batch_impl(buf: MissionBuffer, slots, features, feat_valid, seg, K, pose_cam_in_world) -> MissionBuffer:
    """Write B mission nodes in one scatter per field, in place.

    slots: (B,) host integers (a sequence, numpy array or CPU tensor);
    rows whose slot equals the capacity are dropped here, on the host,
    before any index reaches the device. features (B, S, D), feat_valid
    (B, S), seg (B, H, W), K (B, 3, 3), pose_cam_in_world (B, 4, 4)."""
    slots = np.asarray(slots.cpu() if isinstance(slots, torch.Tensor) else slots, dtype=np.int64)
    if ((slots < 0) | (slots > buf.capacity)).any():
        raise IndexError(f"slots {slots.tolist()} outside [0, {buf.capacity}]")
    keep = np.flatnonzero(slots < buf.capacity)
    if keep.size == 0:
        return buf
    dev = buf.features.device
    rows = torch.as_tensor(keep, device=dev)
    return _write(buf, torch.as_tensor(slots[keep], device=dev),
                  *(torch.as_tensor(a, device=dev)[rows] for a in (features, feat_valid, seg, K, pose_cam_in_world)))
