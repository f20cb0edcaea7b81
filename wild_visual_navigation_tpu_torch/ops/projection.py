"""Batched pinhole camera projection.

Port of wild_visual_navigation_tpu/ops/projection.py: no distortion
model, fixed shapes, invalid projections reported by masks. The small
products are written out elementwise in fp32 (utils/lie.py), so no TF32
path is ever taken.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..utils.lie import _matvec, se3_inverse, transform_points


class Camera(NamedTuple):
    """Batched pinhole intrinsics: K (B, 3, 3), image height and width."""

    K: torch.Tensor
    height: int
    width: int


def scale_intrinsics(K, h: int, w: int, new_h: Optional[int] = None, new_w: Optional[int] = None) -> torch.Tensor:
    """Rescale intrinsics for a resized (and centre-cropped) image.

    Keeps the reference projector's quirk for a square output (new_w None
    or equal to new_h): fx and cx are taken from fy and cy scaled by sy,
    as the horizontal centre crop after the aspect-preserving resize
    re-centres the principal point. K: (..., 3, 3) or (..., 4, 4) ->
    (..., 3, 3) float32."""
    K = torch.as_tensor(K, dtype=torch.float32)
    if K.shape[-1] == 4:
        K = K[..., :3, :3]
    if new_h is None:
        new_h = h
    sy = new_h / h
    sx = (new_w / w) if new_w is not None else sy

    fx, fy = K[..., 0, 0], K[..., 1, 1]
    cx, cy = K[..., 0, 2], K[..., 1, 2]
    if new_w is None or new_w == new_h:
        nfx, ncx = fy * sy, cy * sy
    else:
        nfx, ncx = fx * sx, cx * sx
    nfy, ncy = fy * sy, cy * sy

    sK = torch.zeros(K.shape[:-2] + (3, 3), dtype=torch.float32, device=K.device)
    sK[..., 0, 0] = nfx
    sK[..., 1, 1] = nfy
    sK[..., 0, 2] = ncx
    sK[..., 1, 2] = ncy
    sK[..., 2, 2] = 1.0
    return sK


def make_camera(K, h: int, w: int, new_h: Optional[int] = None, new_w: Optional[int] = None) -> Camera:
    """A scaled Camera, batched to (B, 3, 3)."""
    sK = scale_intrinsics(K, h, w, new_h=new_h, new_w=new_w)
    out_h = new_h if new_h is not None else h
    out_w = new_w if new_w is not None else out_h
    return Camera(K=sK if sK.ndim == 3 else sK[None], height=int(out_h), width=int(out_w))


def project_points(camera: Camera, pose_camera_in_world: torch.Tensor, points_world: torch.Tensor):
    """World points (B, N, 3) -> image plane through poses (B, 4, 4).

    Returns points_2d (B, N, 2) pixel coordinates (x, y); valid (B, N),
    in front of the camera and inside [0, W] x [0, H]; valid_z (B, N), in
    front of the camera only, which is what masks the polygon vertices."""
    points_c = transform_points(se3_inverse(pose_camera_in_world), points_world)  # (B, N, 3)
    z = points_c[..., 2]
    # guard the divide; invalid points are masked downstream
    z_safe = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    uvw = _matvec(camera.K[:, None], points_c)  # (B, N, 3)
    pts2d = uvw[..., :2] / z_safe[..., None]

    valid_z = z >= 0
    valid_x = (pts2d[..., 0] >= 0) & (pts2d[..., 0] <= camera.width)
    valid_y = (pts2d[..., 1] >= 0) & (pts2d[..., 1] <= camera.height)
    return pts2d, valid_z & valid_x & valid_y, valid_z
