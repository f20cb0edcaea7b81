"""Segment (superpixel) ops: pooling, adjacency, centroids, grid.

Port of wild_visual_navigation_tpu/ops/segment_ops.py. Outputs keep the
reference's fixed padded shapes — `num_segments` rows and `max_edges`
edge slots with validity masks — so FrameResult fields compare 1:1.
Ids of -1 (unassigned) or >= num_segments are ignored, as the
reference's one-hot ignores them.
"""

from __future__ import annotations

import numpy as np
import torch

from .resize import bilinear_matrix

_INT32_MAX = 2**31 - 1


def _one_hot(ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """(...,) int ids -> (..., S) float32; out-of-range ids give zero rows."""
    return (ids[..., None] == torch.arange(num_segments, device=ids.device)).float()


def segment_mean_pool(dense_features: torch.Tensor, seg: torch.Tensor, num_segments: int):
    """dense_features (D, H, W), seg (H, W) -> ((S, D) means, (S,) counts)."""
    D = dense_features.shape[0]
    X = dense_features.reshape(D, -1).T.float()  # (HW, D)
    onehot = _one_hot(seg.reshape(-1), num_segments)  # (HW, S)
    sums = onehot.T @ X
    counts = onehot.sum(0)
    return sums / counts.clamp_min(1.0)[:, None], counts


def segment_mean_pool_upsampled(feat: torch.Tensor, seg: torch.Tensor, num_segments: int, out_h: int, out_w: int):
    """Per-segment mean of the bilinear-upsampled patch features without
    the upsampled map: the per-segment pixel sum of up(feat) contracts
    the adjoint-downsampled one-hot masks against feat.

    feat (D, Hp, Wp), seg (out_h, out_w) -> ((S, D) means, (S,) counts)."""
    D, Hp, Wp = feat.shape
    Mh = bilinear_matrix(out_h, Hp, feat.device)
    Mw = bilinear_matrix(out_w, Wp, feat.device)
    onehot = _one_hot(seg, num_segments)  # (H, W, S)
    t = torch.einsum("hws,hp->pws", onehot, Mh)
    A = torch.einsum("pws,wq->spq", t, Mw)
    sums = torch.einsum("spq,dpq->sd", A, feat.float())
    counts = onehot.sum((0, 1))
    return sums / counts.clamp_min(1.0)[:, None], counts


def segment_centers(seg: torch.Tensor, num_segments: int):
    """Per-segment centroid in (x, y) pixels: ((S, 2), (S,) valid)."""
    H, W = seg.shape
    ys = torch.arange(H, dtype=torch.float32, device=seg.device)[:, None].expand(H, W)
    xs = torch.arange(W, dtype=torch.float32, device=seg.device)[None, :].expand(H, W)
    onehot = _one_hot(seg.reshape(-1), num_segments)
    coords = torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=-1)  # (HW, 2)
    sums = onehot.T @ coords
    counts = onehot.sum(0)
    return sums / counts.clamp_min(1.0)[:, None], counts > 0


def adjacency_list(seg: torch.Tensor, num_segments: int, max_edges: int = 512):
    """Undirected 4-neighbourhood adjacency of segments, fixed size.

    Returns edges (2, max_edges) int32 and edge_valid (max_edges,) bool:
    valid pair keys `a + b·(S+1)` first, in ascending order, truncated
    to the smallest keys, then padding. S <= 256 counts a co-occurrence
    matrix; larger S dedups pair keys with `torch.unique`."""
    S = num_segments
    div = S + 1
    if div * div > _INT32_MAX:
        raise ValueError(f"adjacency_list supports at most 46339 segments (got {S})")
    s = seg.to(torch.int64)
    pairs = [(s[:, :-1], s[:, 1:]), (s[:-1, :], s[1:, :])]
    if S <= 256:
        # pair counts; out-of-range ids land in a spare last slot
        m = torch.zeros(S * S + 1, dtype=torch.int64, device=seg.device)
        for a, b in pairs:
            ok = (a >= 0) & (a < S) & (b >= 0) & (b < S)
            idx = torch.where(ok, a * S + b, S * S).reshape(-1)
            m.index_add_(0, idx, torch.ones_like(idx))
        m = m[: S * S].reshape(S, S)
        m = m + m.T
        m.fill_diagonal_(0)
        ai = torch.arange(S, device=seg.device)[:, None]
        bi = torch.arange(S, device=seg.device)[None, :]
        keys = torch.where(m > 0, ai + bi * div, _INT32_MAX).reshape(-1)
        keys = torch.sort(keys).values[:max_edges]
    else:
        found = []
        for a, b in pairs:
            d = (a != b) & (a >= 0) & (b >= 0)
            found += [(a + b * div)[d], (b + a * div)[d]]
        keys = torch.unique(torch.cat(found))[:max_edges]
    if keys.numel() < max_edges:
        keys = torch.cat([keys, torch.full((max_edges - keys.numel(),), _INT32_MAX, dtype=keys.dtype, device=keys.device)])
    valid = keys < _INT32_MAX
    le = torch.where(valid, keys % div, 0)
    ri = torch.where(valid, keys // div, 0)
    return torch.stack([le, ri]).to(torch.int32), valid


def segment_grid(height: int, width: int, cell_size: int = 32, device=None) -> torch.Tensor:
    """Grid segmentation: row-major cell ids, (H, W) int32."""
    ys = torch.arange(height, device=device) // cell_size
    xs = torch.arange(width, device=device) // cell_size
    ncols = -(-width // cell_size)
    return (ys[:, None] * ncols + xs[None, :]).to(torch.int32)


def grid_constants(height: int, width: int, cell_size: int, num_segments: int, max_edges: int = 512, device=None):
    """adjacency_list + segment_centers of a segment_grid map, computed
    once in numpy: (edges, edge_valid, centers, center_valid)."""
    ncols = -(-width // cell_size)
    nrows = -(-height // cell_size)
    ncells = nrows * ncols
    if num_segments < ncells:
        raise ValueError(
            f"grid of {height}x{width}/{cell_size} has {ncells} cells but num_segments={num_segments}; "
            f"ids would alias in the pooling one-hot and the adjacency pair hash"
        )
    div = num_segments + 1
    ys = np.arange(height) // cell_size
    xs = np.arange(width) // cell_size
    seg = (ys[:, None] * ncols + xs[None, :]).astype(np.int64)
    key_list = []
    for a, b in ((seg[:, :-1], seg[:, 1:]), (seg[:-1, :], seg[1:, :])):
        d = a != b
        key_list += [a[d] + b[d] * div, b[d] + a[d] * div]
    keys = np.unique(np.concatenate(key_list))[:max_edges]
    uniq = np.concatenate([keys, np.full(max_edges - keys.size, -1, np.int64)])
    valid = uniq >= 0
    edges = np.stack([np.where(valid, uniq % div, 0), np.where(valid, uniq // div, 0)]).astype(np.int32)
    cnt = np.zeros(num_segments, np.float64)
    sx = np.zeros(num_segments, np.float64)
    sy = np.zeros(num_segments, np.float64)
    yy, xx = np.mgrid[0:height, 0:width]
    np.add.at(cnt, seg.ravel(), 1.0)
    np.add.at(sx, seg.ravel(), xx.ravel().astype(np.float64))
    np.add.at(sy, seg.ravel(), yy.ravel().astype(np.float64))
    centers = np.stack([sx, sy], axis=-1) / np.maximum(cnt[:, None], 1.0)
    return (
        torch.as_tensor(edges, device=device),
        torch.as_tensor(valid, device=device),
        torch.as_tensor(centers, dtype=torch.float32, device=device),
        torch.as_tensor(cnt > 0, device=device),
    )
