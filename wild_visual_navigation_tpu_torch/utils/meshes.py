"""3-D samples of footprint and collision geometry.

Port of wild_visual_navigation_tpu/utils/meshes.py on utils/lie.py. Every
function returns a fixed-shape float32 point set for a given `grid_size`:
duplicates are kept where the reference deduplicated with `torch.unique`,
since every consumer rasterises the point set's convex hull. `pose` is a
(4, 4) transform (identity when None); points come back in its frame's
parent.
"""

from __future__ import annotations

import math

import torch

from .lie import transform_points


def _pose(pose) -> torch.Tensor:
    return torch.eye(4) if pose is None else torch.as_tensor(pose, dtype=torch.float32)


def _transform(pose, points: torch.Tensor) -> torch.Tensor:
    T = _pose(pose).to(points.device)
    return transform_points(T[None] if T.dim() == 2 else T, points[None])[0]


def make_superquadric(A, B, C, r, s, t, pose=None, grid_size: int = 10) -> torch.Tensor:
    """Superquadric surface sample, (grid_size², 3) points."""
    eta_s = torch.linspace(-math.pi / 2, math.pi / 2, grid_size)
    w_s = torch.linspace(-math.pi, math.pi, grid_size)
    eta, w = torch.meshgrid(eta_s, w_s, indexing="xy")

    def spow(base, p):
        return torch.sign(base) * torch.abs(base) ** p

    x = A * spow(torch.cos(eta), r) * spow(torch.cos(w), r)
    y = B * spow(torch.cos(eta), s) * spow(torch.sin(w), s)
    z = C * spow(torch.sin(eta), s)
    return _transform(pose, torch.stack([x.reshape(-1), y.reshape(-1), z.reshape(-1)], dim=-1))


def make_box(length, width, height, pose=None, grid_size: int = 11) -> torch.Tensor:
    return make_superquadric(length / 2, width / 2, height / 2, 0.01, 0.01, 0.01, pose=pose, grid_size=grid_size)


def make_rounded_box(length, width, height, pose=None, grid_size: int = 11) -> torch.Tensor:
    return make_superquadric(length / 2, width / 2, height / 2, 0.2, 0.2, 0.2, pose=pose, grid_size=grid_size)


def make_ellipsoid(length, width, height, pose=None, grid_size: int = 11) -> torch.Tensor:
    return make_superquadric(length / 2, width / 2, height / 2, 1.0, 1.0, 1.0, pose=pose, grid_size=grid_size)


def _plane_corners(x=None, y=None, z=None) -> torch.Tensor:
    """The 4 corners of an axis-aligned plane given two of its extents."""
    if x is None:
        pts = [[0.0, y / 2, z / 2], [0.0, -y / 2, z / 2], [0.0, -y / 2, -z / 2], [0.0, y / 2, -z / 2]]
    elif y is None:
        pts = [[x / 2, 0.0, z / 2], [x / 2, 0.0, -z / 2], [-x / 2, 0.0, -z / 2], [-x / 2, 0.0, z / 2]]
    elif z is None:
        pts = [[x / 2, y / 2, 0.0], [x / 2, -y / 2, 0.0], [-x / 2, -y / 2, 0.0], [-x / 2, y / 2, 0.0]]
    else:
        raise ValueError("make_plane requires exactly 2 of x, y, z")
    return torch.tensor(pts, dtype=torch.float32)


def make_plane(x=None, y=None, z=None, pose=None, grid_size: int = 10) -> torch.Tensor:
    """The plane's boundary: 4 corners, then `grid_size` lerp steps along
    each edge, (4 + 4·grid_size, 3)."""
    corners = _plane_corners(x=x, y=y, z=z)
    pieces = [corners]
    if grid_size > 0:
        w = torch.linspace(0.0, 1.0, grid_size)[:, None]
        for i in range(4):
            a, b = corners[i], corners[(i + 1) % 4]
            pieces.append(a[None] * (1 - w) + b[None] * w)
    return _transform(pose, torch.cat(pieces, dim=0))


def make_side_points(width: float, pose=None) -> torch.Tensor:
    """The two lateral footprint points, (0, -width/2, 0) then (0, +width/2, 0)."""
    return _transform(pose, torch.tensor([[0.0, -width / 2, 0.0], [0.0, width / 2, 0.0]], dtype=torch.float32))


def make_dense_plane(x=None, y=None, z=None, pose=None, grid_size: int = 5) -> torch.Tensor:
    """A dense grid over a plane given two of its extents, (grid_size², 3)."""
    if x is None:
        a, b = torch.meshgrid(torch.linspace(-y / 2, y / 2, grid_size), torch.linspace(-z / 2, z / 2, grid_size),
                              indexing="xy")
        points = torch.stack([torch.zeros_like(a).reshape(-1), a.reshape(-1), b.reshape(-1)], dim=-1)
    elif y is None:
        a, b = torch.meshgrid(torch.linspace(-x / 2, x / 2, grid_size), torch.linspace(-z / 2, z / 2, grid_size),
                              indexing="xy")
        points = torch.stack([a.reshape(-1), torch.zeros_like(a).reshape(-1), b.reshape(-1)], dim=-1)
    elif z is None:
        a, b = torch.meshgrid(torch.linspace(-x / 2, x / 2, grid_size), torch.linspace(-y / 2, y / 2, grid_size),
                              indexing="xy")
        points = torch.stack([a.reshape(-1), b.reshape(-1), torch.zeros_like(a).reshape(-1)], dim=-1)
    else:
        raise ValueError("make_dense_plane requires exactly 2 of x, y, z")
    return _transform(pose, points)


def make_polygon_from_points(points: torch.Tensor, grid_size: int = 10) -> torch.Tensor:
    """Lerp along the closed boundary through the ordered (B, 3) vertices:
    (B · grid_size, 3)."""
    B = points.shape[0]
    w = torch.linspace(0.0, 1.0, grid_size, device=points.device)[None, :, None]
    a = points[:, None, :]
    b = torch.roll(points, -1, dims=0)[:, None, :]
    return (a * (1 - w) + b * w).reshape(B * grid_size, 3)
