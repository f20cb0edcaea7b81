"""Convex-polygon rasterization for the supervision reprojection.

Port of wild_visual_navigation_tpu/ops/rasterize.py:

  1. `convex_hull`: a fixed-iteration gift wrap (Jarvis march) of the
     masked projected footprint points, O(max_hull · N²) cross products,
     no data-dependent shapes; batched over leading dimensions.
  2. The hull is filled by a half-plane test: a pixel is inside when it
     lies on the inner side of every hull edge. For CUDA tensors
     `rasterize_points_hull` runs both steps in one launch of kernel K4
     (ops/rasterize_fill.py::hull_masks), bitwise equal to `convex_hull`
     and the plain fill, which serve CPU tensors; `fill_convex_hull`, the
     reference's scan over edges, stays as a second form to test against.

Masks are boolean; callers fuse them with a +inf "unset" sentinel
(traversability/estimator.py).
"""

from __future__ import annotations

import torch

from .projection import Camera, project_points
from .rasterize_fill import fill_hulls_plain, hull_masks

_EPS = 1e-6
_BIG = 1e30


def convex_hull(points: torch.Tensor, valid: torch.Tensor, max_hull: int = 32):
    """Fixed-size convex hull of masked 2-d points.

    points (..., N, 2) float32, valid (..., N) bool (invalid or non-finite
    points are ignored) -> hull (..., max_hull, 2) vertices in march order
    and hull_valid (..., max_hull) bool. The march starts at the lowest-y
    (then lowest-x) point; once it returns to the start, the start vertex
    repeats, which gives zero-length edges that never constrain the fill.
    Ties go to the first index, as in the reference."""
    lead = points.shape[:-2]
    N = points.shape[-2]
    pts = points.reshape(-1, N, 2).float()
    valid = valid.reshape(-1, N) & torch.isfinite(pts).all(-1)
    rows = torch.arange(pts.shape[0], device=pts.device)
    num_valid = valid.sum(-1)
    safe = torch.where(valid[..., None], pts, _BIG)
    key = safe[..., 1] * 1e6 + safe[..., 0]
    start_idx = torch.argmin(key, dim=-1)
    start = pts[rows, start_idx]

    cur_idx, cur, done = start_idx, start, num_valid < 3
    verts, vvalid = [], []
    for _ in range(max_hull - 1):
        d = pts - cur[:, None, :]  # (B, N, 2)
        dist = torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])
        cand = valid & (dist > _EPS)
        # C[j, k] = cross(d_j, d_k): j is the next hull vertex iff no valid
        # candidate k lies clockwise of the ray cur -> j
        C = d[:, :, None, 0] * d[:, None, :, 1] - d[:, :, None, 1] * d[:, None, :, 0]
        min_cross = torch.where(cand[:, None, :], C, _BIG).amin(-1)
        is_hull_dir = cand & (min_cross >= -_EPS * (1.0 + dist * dist))
        # collinear candidates: take the farthest
        nxt_idx = torch.argmax(torch.where(is_hull_dir, dist, -1.0), dim=-1)
        any_cand = is_hull_dir.any(-1)
        nxt_idx = torch.where(any_cand, nxt_idx, cur_idx)
        nxt = pts[rows, nxt_idx]
        closed = (nxt_idx == start_idx) | ~any_cand
        verts.append(torch.where(done[:, None], start, nxt))
        vvalid.append(~done & ~closed)  # the closing vertex repeats the start
        cur_idx = nxt_idx
        cur = torch.where(done[:, None], cur, nxt)
        done = done | closed

    hull = torch.cat([start[:, None], torch.stack(verts, 1)], dim=1)
    hull_valid = torch.cat([(num_valid >= 3)[:, None], torch.stack(vvalid, 1)], dim=1)
    hull = torch.where(hull_valid[..., None], hull, start[:, None])
    return hull.reshape(*lead, max_hull, 2), hull_valid.reshape(*lead, max_hull)


def fill_convex_hull(hull: torch.Tensor, hull_valid: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """One hull (E, 2) -> (height, width) bool by the reference's scan over
    edges: min_e cross(v1 - v0, q - v0) >= -eps at integer pixels."""
    ys = torch.arange(height, dtype=torch.float32, device=hull.device)[:, None]
    xs = torch.arange(width, dtype=torch.float32, device=hull.device)[None, :]
    nxt = torch.roll(hull, -1, dims=0)
    acc = torch.full((height, width), _BIG, dtype=torch.float32, device=hull.device)
    for v0, v1 in zip(hull, nxt):
        ex, ey = v1[0] - v0[0], v1[1] - v0[1]
        acc = torch.minimum(acc, ex * (ys - v0[1]) - ey * (xs - v0[0]))
    return (acc >= -_EPS) & (torch.sum(hull_valid) >= 3)


def rasterize_points_hull(points2d: torch.Tensor, valid: torch.Tensor, height: int, width: int,
                          max_hull: int = 32) -> torch.Tensor:
    """Masks of the convex hulls of the valid projected points:
    (B, N, 2), (B, N) -> (B, height, width) bool. CUDA tensors take K4 from
    the points (one launch runs the gift wrap and the fill); CPU tensors
    take convex_hull and the plain fill."""
    if points2d.device.type == "cpu":
        hulls, hull_valid = convex_hull(points2d, valid, max_hull=max_hull)
        return fill_hulls_plain(hulls, hull_valid, height, width)
    return hull_masks(points2d, valid, height, width, max_hull)


def project_and_render(camera: Camera, pose_camera_in_world: torch.Tensor, points_world: torch.Tensor,
                       max_hull: int = 32):
    """Project world points and fill their convex hull. Vertices behind the
    camera are dropped before the hull.

    Returns inside (B, H, W) bool, points_2d (B, N, 2) and valid (B, N)
    (in front of the camera and in bounds)."""
    pts2d, valid, valid_z = project_points(camera, pose_camera_in_world, points_world)
    inside = rasterize_points_hull(pts2d, valid_z, camera.height, camera.width, max_hull=max_hull)
    return inside, pts2d, valid
