"""Segment (superpixel) ops: pooling, masked means, adjacency, centroids, grid.

Port of wild_visual_navigation_tpu/ops/segment_ops.py. Outputs keep the
reference's fixed padded shapes — `num_segments` rows and `max_edges`
edge slots with validity masks — so FrameResult fields compare 1:1.
Ids of -1 (unassigned) or >= num_segments are ignored, as the
reference's one-hot ignores them.
"""

from __future__ import annotations

import functools

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


def segment_masked_mean(values: torch.Tensor, value_valid: torch.Tensor, seg: torch.Tensor, num_segments: int):
    """Per-segment mean of a masked scalar field, batched over leading dims.

    values (..., H, W) float, value_valid (..., H, W) bool, seg (..., H, W)
    ids -> (mean (..., S), valid (..., S) bool): the mean over valid
    pixels (0 where there is none) and the reference's `mean > 0`
    validity. Sums and counts go through `index_add_` over the flat ids
    `image · S + seg`, so no (pixels, S) one-hot is formed (at the
    reprojection's 32 views × 224² × 100 segments it would take 642 MB);
    ids outside [0, S) fall into a spare last bin."""
    lead = values.shape[:-2]
    S = num_segments
    v = torch.where(value_valid, values, 0.0).reshape(-1, values.shape[-2] * values.shape[-1]).float()
    m = value_valid.reshape(v.shape).float()
    ids = seg.reshape(v.shape).long()
    n = v.shape[0]
    base = torch.arange(n, device=ids.device)[:, None] * S
    flat = torch.where((ids >= 0) & (ids < S), base + ids, n * S).reshape(-1)
    sums = torch.zeros(n * S + 1, dtype=torch.float32, device=v.device).index_add_(0, flat, (v * m).reshape(-1))
    counts = torch.zeros(n * S + 1, dtype=torch.float32, device=v.device).index_add_(0, flat, m.reshape(-1))
    sums, counts = sums[: n * S].reshape(*lead, S), counts[: n * S].reshape(*lead, S)
    mean = torch.where(counts > 0, sums / torch.clamp_min(counts, 1.0), 0.0)
    return mean, mean > 0


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

    seg (H, W) or a batch (B, H, W) -> edges (2, max_edges) int32 and
    edge_valid (max_edges,) bool, or (B, 2, max_edges) and (B, max_edges):
    valid pair keys `a + b·(S+1)` first, in ascending order, truncated
    to the smallest keys, then padding. S <= 256 counts a co-occurrence
    matrix per image; larger S dedups pair keys with `torch.unique` over
    the batch at once."""
    if seg.ndim == 2:
        edges, valid = adjacency_list(seg[None], num_segments, max_edges)
        return edges[0], valid[0]
    S = num_segments
    div = S + 1
    if div * div > _INT32_MAX:
        raise ValueError(f"adjacency_list supports at most 46339 segments (got {S})")
    B = seg.shape[0]
    dev = seg.device
    s = seg.to(torch.int64)
    pairs = [(s[:, :, :-1], s[:, :, 1:]), (s[:, :-1, :], s[:, 1:, :])]
    if S <= 256:
        # pair counts per image; out-of-range ids land in a spare last slot
        base = (torch.arange(B, device=dev) * (S * S))[:, None, None]
        m = torch.zeros(B * S * S + 1, dtype=torch.int64, device=dev)
        for a, b in pairs:
            ok = (a >= 0) & (a < S) & (b >= 0) & (b < S)
            idx = torch.where(ok, base + a * S + b, B * S * S).reshape(-1)
            m.index_add_(0, idx, torch.ones_like(idx))
        m = m[: B * S * S].reshape(B, S, S)
        m = m + m.transpose(1, 2)
        m.diagonal(dim1=1, dim2=2).zero_()
        ai = torch.arange(S, device=dev)[:, None]
        bi = torch.arange(S, device=dev)[None, :]
        keys = torch.where(m > 0, ai + bi * div, _INT32_MAX).reshape(B, -1)
        keys = torch.sort(keys, dim=-1).values[:, :max_edges]
        if keys.shape[1] < max_edges:
            keys = torch.cat([keys, torch.full((B, max_edges - keys.shape[1]), _INT32_MAX, dtype=keys.dtype,
                                               device=dev)], dim=1)
    else:
        img = torch.arange(B, device=dev)[:, None, None].expand_as(s)
        found = []
        for a, b in pairs:
            d = (a != b) & (a >= 0) & (b >= 0)
            owner = img[:, : a.shape[1], : a.shape[2]][d]
            found += [torch.stack([owner, (a + b * div)[d]], 1), torch.stack([owner, (b + a * div)[d]], 1)]
        u = torch.unique(torch.cat(found), dim=0)  # (image, key) rows, sorted by image, then by key
        owner, key = u[:, 0], u[:, 1]
        counts = torch.bincount(owner, minlength=B)
        pos = torch.arange(u.shape[0], device=dev) - (torch.cumsum(counts, 0) - counts)[owner]
        keep = pos < max_edges
        keys = torch.full((B, max_edges), _INT32_MAX, dtype=torch.int64, device=dev)
        keys[owner[keep], pos[keep]] = key[keep]
    valid = keys < _INT32_MAX
    le = torch.where(valid, keys % div, 0)
    ri = torch.where(valid, keys // div, 0)
    return torch.stack([le, ri], dim=1).to(torch.int32), valid


@functools.lru_cache(maxsize=32)
def _upsampled_cell_sums(out_h: int, out_w: int, hp: int, wp: int, device) -> torch.Tensor:
    """(hp·wp, 3) per patch cell: the pixel sums of x and y and the pixel
    count of the cell's block under the integer nearest upsample
    `r = (y · hp) // out_h`. Built once per shape and device."""

    def block_sums(n_out, n_in):
        idx = (np.arange(n_out) * n_in) // n_out  # pixel -> patch row
        w = np.zeros(n_in, np.float64)
        s = np.zeros(n_in, np.float64)
        np.add.at(w, idx, 1.0)
        np.add.at(s, idx, np.arange(n_out, dtype=np.float64))
        return w.astype(np.float32), s.astype(np.float32)

    w_y, s_y = block_sums(out_h, hp)
    w_x, s_x = block_sums(out_w, wp)
    cnt = (w_y[:, None] * w_x[None, :]).reshape(-1)
    sx = (w_y[:, None] * s_x[None, :]).reshape(-1)
    sy = (s_y[:, None] * w_x[None, :]).reshape(-1)
    return torch.as_tensor(np.stack([sx, sy, cnt], axis=-1), device=device)


def upsampled_adjacency_and_centers(seg_p: torch.Tensor, num_segments: int, out_h: int, out_w: int,
                                    max_edges: int = 512):
    """adjacency_list + segment_centers of the nearest-upsampled label map
    (the integer rule `r = (y · hp) // out_h`), computed at patch resolution.

    The rule sends each patch cell to a contiguous pixel block, so two
    labels touch at pixel resolution exactly when they touch at patch
    resolution, and a label's pixel centroid is its cells' block-weighted
    centroid. seg_p (hp, wp) -> (edges, edge_valid, centers, center_valid)."""
    hp, wp = seg_p.shape
    if out_h < hp or out_w < wp:
        # downsampling merges cells: patch-resolution adjacency would report pairs the pixel map never has
        raise ValueError(f"upsampled_adjacency_and_centers requires out >= patch grid "
                         f"(got {out_h}x{out_w} from {hp}x{wp})")
    edges, edge_valid = adjacency_list(seg_p, num_segments, max_edges=max_edges)
    stacked = _upsampled_cell_sums(out_h, out_w, hp, wp, seg_p.device)
    agg = _one_hot(seg_p.reshape(-1), num_segments).T @ stacked
    counts = agg[:, 2]
    return edges, edge_valid, agg[:, :2] / counts.clamp_min(1.0)[:, None], counts > 0


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


def segment_pixelwise(height: int, width: int, device=None) -> torch.Tensor:
    """Pixel-wise segmentation: every pixel its own id, (H, W) int32."""
    return torch.arange(height * width, dtype=torch.int32, device=device).reshape(height, width)


def pixelwise_edges(height: int, width: int, device=None) -> torch.Tensor:
    """4-neighbour edges of the pixel-wise segmentation, (2, E) int32:
    the horizontal pairs row by row, then the vertical ones."""
    seg = segment_pixelwise(height, width, device)
    hor = torch.stack([seg[:, :-1].reshape(-1), seg[:, 1:].reshape(-1)])
    ver = torch.stack([seg[:-1, :].reshape(-1), seg[1:, :].reshape(-1)])
    return torch.cat([hor, ver], dim=1)


def segment_random(generator: torch.Generator, height: int, width: int, n_random_pixels: int = 100,
                   device=None) -> torch.Tensor:
    """Random-pixel segmentation: `n` distinct pixels drawn from
    `generator` get ids 0..n-1, the rest -1 (unassigned). The JAX package
    draws with `jax.random.permutation`, which torch cannot reproduce:
    the structure is the same, the pixels are not."""
    perm = torch.randperm(height * width, generator=generator)[:n_random_pixels]
    seg = torch.full((height * width,), -1, dtype=torch.int32)
    seg[perm] = torch.arange(n_random_pixels, dtype=torch.int32)
    return seg.reshape(height, width).to(device)
