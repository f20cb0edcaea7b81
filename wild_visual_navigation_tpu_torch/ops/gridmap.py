"""Ground-plane traversability grid map and its signed-distance field.

Port of wild_visual_navigation_tpu/ops/gridmap.py, the consumer-side
fusion that closes the navigation loop:

  per-pixel traversability -> flat-ground ray casting -> weighted
  scatter-add into a robot-centric grid -> chamfer signed-distance field
  -> scripts/smart_carrot.py::select_carrot.

The grid's sums live on the device; its origin is a float32 pair on the
host, so recentring knows its whole-cell shift without reading the
device. Rays that miss the ground, leave the range or fall outside the
grid scatter with weight 0 into a spare last cell that is sliced off (the
JAX package's dropped pad index; an out-of-range index on the card would
be a device-side assert, and dropping rows on the host would read the
device every frame). The SDF is a fixed number of min-plus relaxations on
the device, mins and adds only, so it is deterministic.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F


class GridMap(NamedTuple):
    """Accumulated traversability grid (world-anchored)."""

    value_sum: torch.Tensor  # (G, G) weighted sum of traversability
    weight: torch.Tensor  # (G, G) accumulated weights
    origin_xy: np.ndarray  # (2,) float32 world coords of cell (0, 0), on the host
    resolution: float

    @property
    def traversability(self) -> torch.Tensor:
        return torch.where(self.weight > 0, self.value_sum / torch.clamp_min(self.weight, 1e-6), 0.5)

    @property
    def valid(self) -> torch.Tensor:
        return self.weight > 0


def gridmap_init(size: int = 64, resolution: float = 0.1, center_xy=(0.0, 0.0), device=None) -> GridMap:
    half = size * resolution / 2.0
    return GridMap(
        value_sum=torch.zeros((size, size), dtype=torch.float32, device=device),
        weight=torch.zeros((size, size), dtype=torch.float32, device=device),
        origin_xy=np.asarray([center_xy[0] - half, center_xy[1] - half], np.float32),
        resolution=resolution,
    )


def project_traversability_to_grid(
    grid: GridMap,
    trav: torch.Tensor,
    K: torch.Tensor,
    pose_cam_in_world,
    confidence: torch.Tensor | None = None,
    max_range: float = 8.0,
    stride: int = 2,
) -> GridMap:
    """Fuse one traversability image into the grid.

    Pixels are back-projected as rays through the camera and intersected
    with the ground plane z = 0; hits within `max_range` (the Euclidean
    camera-to-hit distance) scatter-add confidence-weighted
    traversability into their cells.

    trav: (H, W) in [0, 1]; K: (3, 3) intrinsics for (H, W);
    pose_cam_in_world: (4, 4), numpy or torch. `stride` subsamples pixels.
    """
    dev = grid.weight.device
    H, W = trav.shape
    ys = torch.arange(0, H, stride, dtype=torch.float32, device=dev) + 0.5
    xs = torch.arange(0, W, stride, dtype=torch.float32, device=dev) + 0.5
    vv, uu = torch.meshgrid(ys, xs, indexing="ij")
    pix = torch.stack([uu, vv, torch.ones_like(uu)], dim=-1).reshape(-1, 3)  # (P, 3)

    Kinv = torch.linalg.inv_ex(torch.as_tensor(K, dtype=torch.float32, device=dev))[0]  # no singularity check: no sync
    pose = torch.as_tensor(pose_cam_in_world, dtype=torch.float32, device=dev)
    R, origin = pose[:3, :3], pose[:3, 3]
    dirs = (R @ (Kinv @ pix.T)).T  # (P, 3) world-frame ray directions

    dz = dirs[:, 2]
    t = -origin[2] / torch.where(dz.abs() < 1e-6, -1e-6, dz)
    hit = (t > 0) & (t * torch.linalg.vector_norm(dirs, dim=-1) < max_range)
    world_xy = origin[None, :2] + t[:, None] * dirs[:, :2]

    ox, oy = (float(v) for v in grid.origin_xy)
    # a divisor on the device: CUDA divides by a host scalar as a product with its reciprocal
    res = torch.full((), grid.resolution, dtype=torch.float32, device=dev)
    cx = torch.floor((world_xy[:, 0] - ox) / res).to(torch.int32)
    cy = torch.floor((world_xy[:, 1] - oy) / res).to(torch.int32)
    G = grid.weight.shape[0]
    ok = hit & (cx >= 0) & (cx < G) & (cy >= 0) & (cy < G)
    flat = torch.where(ok, cy * G + cx, G * G).long()  # the spare cell G*G is sliced off

    vals = trav[::stride, ::stride].reshape(-1).float()
    w = confidence[::stride, ::stride].reshape(-1).float() if confidence is not None else torch.ones_like(vals)
    w = torch.where(ok, w, 0.0)

    def add(field: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
        # into the running sums themselves, as the JAX scatter adds, so the
        # CPU rounds in the same order
        buf = torch.cat([field.reshape(-1), field.new_zeros(1)]).index_add_(0, flat, src)
        return buf[: G * G].reshape(G, G)

    return grid._replace(value_sum=add(grid.value_sum, vals * w), weight=add(grid.weight, w))


def gridmap_recenter(grid: GridMap, new_center_xy) -> GridMap:
    """Shift the grid so `new_center_xy` is at its centre (a robot-centric
    rolling map). The shift snaps to whole cells, rounding half to even;
    cells shifted in from outside are cleared. The shift and the new origin
    are computed on the host in float32, as the JAX package computes them."""
    G = grid.weight.shape[0]
    res = np.float32(grid.resolution)
    target = np.asarray(new_center_xy, np.float32) - res * np.float32(G / 2)
    shift = np.round((target - grid.origin_xy) / res).astype(np.int32)
    # origin + shift * res rounded once, as the JAX package's compiled
    # multiply-add does (the product is exact in float64)
    new_origin = (grid.origin_xy.astype(np.float64) + shift.astype(np.float64) * np.float64(res)).astype(np.float32)
    sx, sy = int(shift[0]), int(shift[1])
    if sx == 0 and sy == 0:
        return grid._replace(origin_xy=new_origin)

    def shift2d(a: torch.Tensor) -> torch.Tensor:
        # content moves by -shift: new[y, x] = old[y + sy, x + sx] where that lies inside
        out = torch.zeros_like(a)
        if abs(sx) < G and abs(sy) < G:
            out[max(0, -sy) : G - max(0, sy), max(0, -sx) : G - max(0, sx)] = \
                a[max(0, sy) : G - max(0, -sy), max(0, sx) : G - max(0, -sx)]
        return out

    return grid._replace(value_sum=shift2d(grid.value_sum), weight=shift2d(grid.weight), origin_xy=new_origin)


def traversability_sdf(
    trav: torch.Tensor,
    valid: torch.Tensor,
    threshold: float = 0.5,
    resolution: float = 0.1,
    iterations: int = 64,
) -> torch.Tensor:
    """Signed distance to the untraversable set via chamfer relaxation.

    Positive inside traversable space (distance to the nearest
    untraversable or unknown cell), negative inside untraversable space.
    `iterations` 4-neighbour min-plus steps, padded with 1e6 so nothing
    wraps; both distances relax together as one (2, G, G) stack.
    """
    blocked = (~valid) | (trav < threshold)
    big = 1e6
    dist = torch.stack([torch.where(blocked, 0.0, big), torch.where(blocked, big, 0.0)])  # (to blocked, to free)
    for _ in range(iterations):
        p = F.pad(dist, (1, 1, 1, 1), value=big)
        n = torch.minimum(torch.minimum(p[:, :-2, 1:-1], p[:, 2:, 1:-1]),
                          torch.minimum(p[:, 1:-1, :-2], p[:, 1:-1, 2:]))
        dist = torch.minimum(dist, n + resolution)
    return torch.where(blocked, -dist[1], dist[0])
