"""Convex-hull fill whose kernel is K4 (csrc/fill_hulls.cu).

Port of wild_visual_navigation_tpu/ops/rasterize_pallas.py. The hull's
edge lines are built here in torch, exactly as the reference builds them:
for the edge v0 -> v1 of a hull in march order,

    a = -(v1y - v0y),  b = v1x - v0x,  c = (v1y - v0y)·v0x - (v1x - v0x)·v0y

plus one gate edge (a = b = 0, c = +1e30 for a hull of at least 3 valid
vertices, -1e30 otherwise), so a degenerate hull fills nothing without a
side flag. A pixel (x, y) at integer coordinates is inside when
min_e(a·x + b·y + c) >= -1e-6.

`fill_hulls` launches K4 for CUDA tensors and takes `fill_hulls_plain`
for CPU tensors. Both evaluate a·x + b·y + c as ((a·x) + (b·y)) + c with
a rounding after every operation, and a minimum that propagates NaN, so
their masks are identical.
"""

from __future__ import annotations

import torch

from . import _cuda

_EPS = 1e-6
_BIG = 1e30
MAX_EDGES = 65  # = kMaxEdges of csrc/fill_hulls.cu: 64 hull vertices + the gate


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
    """Plain version of K4: (B, E, 2), (B, E) -> (B, height, width) bool."""
    return fill_edges_plain(hull_edges(hulls, hull_valid), height, width)


def launch_fill(edges: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Launch K4 on edge lines (B, E + 1, 3) fp32 on the card, counted in
    `fill_hulls.launches`. `fill_hulls` checks the shapes before it comes
    here; timing calls the launch alone."""
    out = torch.empty((edges.shape[0], height, width), dtype=torch.bool, device=edges.device)
    _cuda.require_cuda("fill_hulls", edges, out)
    with torch.cuda.device(edges.device):
        err = _cuda.library().wvn_fill_hulls(edges.data_ptr(), out.data_ptr(), edges.shape[0], edges.shape[1],
                                             height, width, _cuda.stream_of(edges))
    _cuda.check(err, "fill_hulls")
    fill_hulls.launches += 1
    return out


def fill_hulls(hulls: torch.Tensor, hull_valid: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Fill B convex hulls: K4 for CUDA tensors, the plain version for CPU
    tensors. hulls (B, E, 2), hull_valid (B, E) -> (B, height, width) bool."""
    if hulls.device.type == "cpu":
        return fill_hulls_plain(hulls, hull_valid, height, width)
    if hulls.device.type != "cuda":
        raise ValueError(f"fill_hulls: unsupported device {hulls.device}")
    B, E, two = hulls.shape
    if two != 2 or hull_valid.shape != (B, E):
        raise ValueError(f"fill_hulls: expected hulls (B, E, 2) and hull_valid (B, E), got {hulls.shape}, "
                         f"{hull_valid.shape}")
    if E + 1 > MAX_EDGES:
        raise ValueError(f"fill_hulls: the kernel takes at most {MAX_EDGES - 1} hull vertices, got {E}")
    if height <= 0 or width <= 0:
        raise ValueError(f"fill_hulls: empty image {height}x{width}")
    return launch_fill(hull_edges(hulls, hull_valid), height, width)


fill_hulls.launches = 0
