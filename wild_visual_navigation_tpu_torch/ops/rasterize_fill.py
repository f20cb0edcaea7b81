"""Convex hull and hull fill whose kernel is K4 (csrc/fill_hulls.cu).

Port of wild_visual_navigation_tpu/ops/rasterize_pallas.py. The plain
version builds the hull's edge lines in torch, exactly as the reference
builds them: for the edge v0 -> v1 of a hull in march order,

    a = -(v1y - v0y),  b = v1x - v0x,  c = (v1y - v0y)·v0x - (v1x - v0x)·v0y

plus one gate edge (a = b = 0, c = +1e30 for a hull of at least 3 valid
vertices, -1e30 otherwise), so a degenerate hull fills nothing without a
side flag. A pixel (x, y) at integer coordinates is inside when
min_e(a·x + b·y + c) >= -1e-6.

K4 has these entry points, all counted in `fill_hulls.launches`:
  * `fill_hulls(hulls, hull_valid, H, W)`, the fill alone, as the TPU
    kernel takes it;
  * `hull_masks(points, valid, H, W, max_hull)`, the supervision flush's
    route: one launch runs the gift wrap of ops/rasterize.py::convex_hull
    and then the fill;
  * `hull_fill(...)`, the same launch, which also writes the hull out.
The kernel builds the edges and evaluates a·x + b·y + c as ((a·x) + (b·y))
+ c with a rounding after every operation, as the plain version does, and
finds each row's span exactly (the proof is in the source's header), so
the masks are identical to `fill_hulls_plain`'s and the hull is bitwise
`convex_hull`'s. CPU tensors take the plain versions; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import _cuda

_EPS = 1e-6
_BIG = 1e30
MAX_HULL = 64  # = kMaxHull of csrc/fill_hulls.cu (65 edges with the gate)
MAX_POINTS = 256  # = kMaxPoints of csrc/fill_hulls.cu: points per hull in the march


def hull_edges(hulls: torch.Tensor, hull_valid: torch.Tensor) -> torch.Tensor:
    """hulls (B, E, 2) in march order, hull_valid (B, E) -> edge lines
    (B, E + 1, 3) float32: one (a, b, c) per edge, then the gate edge."""
    B = hulls.shape[0]
    v0 = hulls.float()
    v1 = torch.roll(v0, -1, dims=1)
    ex = v1[..., 0] - v0[..., 0]
    ey = v1[..., 1] - v0[..., 1]
    edges = torch.stack([-ey, ex, ey * v0[..., 0] - ex * v0[..., 1]], dim=-1)
    ok = torch.sum(hull_valid, dim=1) >= 3
    gate_c = torch.where(ok, _BIG, -_BIG).float()
    zeros = torch.zeros((B,), dtype=torch.float32, device=hulls.device)
    gate = torch.stack([zeros, zeros, gate_c], dim=-1)
    return torch.cat([edges, gate[:, None, :]], dim=1)


def fill_edges_plain(edges: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """The plain fill from edge lines (B, E + 1, 3) -> (B, height, width) bool."""
    ys = torch.arange(height, dtype=torch.float32, device=edges.device)[:, None]
    xs = torch.arange(width, dtype=torch.float32, device=edges.device)[None, :]
    acc = torch.full((edges.shape[0], height, width), _BIG, dtype=torch.float32, device=edges.device)
    for e in range(edges.shape[1]):
        a, b, c = (edges[:, e, k, None, None] for k in range(3))
        acc = torch.minimum(acc, a * xs + b * ys + c)
    return acc >= -_EPS


def fill_hulls_plain(hulls: torch.Tensor, hull_valid: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Plain version of K4's fill: (B, E, 2), (B, E) -> (B, height, width) bool."""
    return fill_edges_plain(hull_edges(hulls, hull_valid), height, width)


def _check(name: str, pts: torch.Tensor, valid: torch.Tensor, height: int, width: int) -> None:
    if pts.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {pts.device}")
    if pts.ndim != 3 or pts.shape[2] != 2 or valid.shape != pts.shape[:2]:
        raise ValueError(f"{name}: expected (B, N, 2) and (B, N), got {tuple(pts.shape)}, {tuple(valid.shape)}")
    if height <= 0 or width <= 0:
        raise ValueError(f"{name}: empty image {height}x{width}")


def fill_hulls(hulls: torch.Tensor, hull_valid: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Fill B convex hulls: K4's fill for CUDA tensors, the plain version
    for CPU tensors. hulls (B, E, 2), hull_valid (B, E) -> (B, height, width) bool."""
    if hulls.device.type == "cpu":
        return fill_hulls_plain(hulls, hull_valid, height, width)
    _check("fill_hulls", hulls, hull_valid, height, width)
    B, E, _ = hulls.shape
    if E > MAX_HULL:
        raise ValueError(f"fill_hulls: the kernel takes at most {MAX_HULL} hull vertices, got {E}")
    hulls, hull_valid = hulls.float().contiguous(), hull_valid.to(torch.bool).contiguous()
    out = torch.empty((B, height, width), dtype=torch.bool, device=hulls.device)
    _cuda.require_cuda("fill_hulls", hulls, hull_valid, out)
    with torch.cuda.device(hulls.device):
        err = _cuda.library().wvn_fill_hulls(hulls.data_ptr(), hull_valid.data_ptr(), out.data_ptr(), B, E, height,
                                             width, _cuda.stream_of(hulls))
    _cuda.check(err, "fill_hulls")
    _cuda.count_launch(fill_hulls)
    return out


fill_hulls.launches = 0


def _hull_fill(name: str, points: torch.Tensor, valid: torch.Tensor, height: int, width: int, max_hull: int,
               write_hulls: bool):
    """One launch of K4 from points -> (masks, hulls, hull_valid), the hulls
    None unless `write_hulls`."""
    _check(name, points, valid, height, width)
    B, N, _ = points.shape
    if not 1 <= max_hull <= MAX_HULL or not 1 <= N <= MAX_POINTS:
        raise ValueError(f"{name}: the kernel takes 1 to {MAX_POINTS} points and a max_hull of 1 to {MAX_HULL}, "
                         f"got {N} and {max_hull}")
    points, valid = points.float().contiguous(), valid.to(torch.bool).contiguous()
    dev = points.device
    masks = torch.empty((B, height, width), dtype=torch.bool, device=dev)
    hulls = hull_valid = None
    if write_hulls:
        hulls = torch.empty((B, max_hull, 2), dtype=torch.float32, device=dev)
        hull_valid = torch.empty((B, max_hull), dtype=torch.bool, device=dev)
    _cuda.require_cuda(name, points, valid, masks, *((hulls, hull_valid) if write_hulls else ()))
    with torch.cuda.device(dev):
        err = _cuda.library().wvn_hull_fill(points.data_ptr(), valid.data_ptr(),
                                            hulls.data_ptr() if write_hulls else None,
                                            hull_valid.data_ptr() if write_hulls else None, masks.data_ptr(), B, N,
                                            max_hull, height, width, _cuda.stream_of(points))
    _cuda.check(err, name)
    _cuda.count_launch(fill_hulls)
    return masks, hulls, hull_valid


def hull_masks(points: torch.Tensor, valid: torch.Tensor, height: int, width: int, max_hull: int = 32) -> torch.Tensor:
    """K4 from points, for CUDA tensors, as the supervision flush runs it:
    one launch runs the gift wrap of ops/rasterize.py::convex_hull and then
    the fill. points (B, N, 2), valid (B, N) -> masks (B, height, width)
    bool, what convex_hull and fill_hulls_plain give. Counted in
    `fill_hulls.launches`."""
    return _hull_fill("hull_masks", points, valid, height, width, max_hull, write_hulls=False)[0]


def hull_fill(points: torch.Tensor, valid: torch.Tensor, height: int, width: int, max_hull: int = 32):
    """`hull_masks` that also writes the hull: -> masks (B, height, width)
    bool, hulls (B, max_hull, 2) float32 and hull_valid (B, max_hull) bool,
    bitwise what convex_hull gives. Counted in `fill_hulls.launches`."""
    return _hull_fill("hull_fill", points, valid, height, width, max_hull, write_hulls=True)
