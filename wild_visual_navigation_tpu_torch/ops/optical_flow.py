"""Pyramidal Lucas-Kanade optical flow / KLT point tracking.

Port of wild_visual_navigation_tpu/ops/optical_flow.py: fixed pyramid
levels, a fixed window and a fixed number of iterations, every point of
a level tracked at once (the JAX package's `vmap` of a `fori_loop`
becomes batched gathers inside a loop over the iterations).
"""

from __future__ import annotations

import torch


def _to_gray(img: torch.Tensor) -> torch.Tensor:
    """(3, H, W) or (H, W) -> (H, W) luma."""
    if img.ndim == 3:
        r, g, b = img[0], img[1], img[2]
        return 0.299 * r + 0.587 * g + 0.114 * b
    return img


def _downsample2(img: torch.Tensor) -> torch.Tensor:
    """2x2 average pool; an odd row or column is cropped first."""
    H, W = img.shape
    H2, W2 = H // 2 * 2, W // 2 * 2
    return img[:H2, :W2].reshape(H2 // 2, 2, W2 // 2, 2).mean(dim=(1, 3))


def _bilinear_sample(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Sample (H, W) at float coordinates, borders clamped. The weights
    come from the clipped corner, as in the JAX package."""
    H, W = img.shape
    y0 = torch.clamp(torch.floor(ys).to(torch.int32), 0, H - 1)
    x0 = torch.clamp(torch.floor(xs).to(torch.int32), 0, W - 1)
    y1 = torch.clamp(y0 + 1, 0, H - 1)
    x1 = torch.clamp(x0 + 1, 0, W - 1)
    wy = torch.clamp(ys - y0, 0.0, 1.0)
    wx = torch.clamp(xs - x0, 0.0, 1.0)
    y0, x0, y1, x1 = (t.long() for t in (y0, x0, y1, x1))
    a = img[y0, x0]
    b = img[y0, x1]
    c = img[y1, x0]
    d = img[y1, x1]
    return (a * (1 - wx) + b * wx) * (1 - wy) + (c * (1 - wx) + d * wx) * wy


def _lk_level(prev: torch.Tensor, nxt: torch.Tensor, pts: torch.Tensor, flow: torch.Tensor, window: int,
              iters: int):
    """One pyramid level of iterative LK for (N, 2) points (x, y) ->
    ((N, 2) flow, (N,) invertible structure tensor)."""
    half = (window - 1) / 2.0
    dy = torch.arange(window, dtype=torch.float32, device=prev.device) - half
    oy, ox = torch.meshgrid(dy, dy, indexing="ij")  # (w, w)

    # central differences with replicated borders
    pad_x = torch.cat([prev[:, :1], prev, prev[:, -1:]], dim=1)
    pad_y = torch.cat([prev[:1], prev, prev[-1:]], dim=0)
    gx_img = (pad_x[:, 2:] - pad_x[:, :-2]) * 0.5
    gy_img = (pad_y[2:, :] - pad_y[:-2, :]) * 0.5

    ys = pts[:, 1, None, None] + oy  # (N, w, w)
    xs = pts[:, 0, None, None] + ox
    T = _bilinear_sample(prev, ys, xs)  # template
    gx = _bilinear_sample(gx_img, ys, xs)
    gy = _bilinear_sample(gy_img, ys, xs)
    # structure tensor (2x2), constant per point
    Gxx = torch.sum(gx * gx, dim=(1, 2))
    Gxy = torch.sum(gx * gy, dim=(1, 2))
    Gyy = torch.sum(gy * gy, dim=(1, 2))
    det = Gxx * Gyy - Gxy * Gxy
    good = torch.abs(det) >= 1e-8
    det_safe = torch.where(good, det, 1.0)

    f = flow
    for _ in range(iters):
        I = _bilinear_sample(nxt, ys + f[:, 1, None, None], xs + f[:, 0, None, None])
        diff = I - T
        bx = torch.sum(diff * gx, dim=(1, 2))
        by = torch.sum(diff * gy, dim=(1, 2))
        du = -(Gyy * bx - Gxy * by) / det_safe
        dv = -(-Gxy * bx + Gxx * by) / det_safe
        f = f + torch.where(good[:, None], torch.stack([du, dv], dim=-1), 0.0)
    return f, good


def track_points(prev_img: torch.Tensor, next_img: torch.Tensor, points: torch.Tensor, levels: int = 3,
                 window: int = 15, iters: int = 10):
    """Track (N, 2) (x, y) points from prev to next image, on the images'
    device.

    Returns (new_points (N, 2), valid (N,) bool): valid where the structure
    tensor is invertible at every level and the point stays in bounds."""
    prev = _to_gray(torch.as_tensor(prev_img).float())
    nxt = _to_gray(torch.as_tensor(next_img).float().to(prev.device))
    points = torch.as_tensor(points, dtype=torch.float32).to(prev.device)

    pyr_prev, pyr_next = [prev], [nxt]
    for _ in range(levels - 1):
        pyr_prev.append(_downsample2(pyr_prev[-1]))
        pyr_next.append(_downsample2(pyr_next[-1]))

    N = points.shape[0]
    flow = torch.zeros((N, 2), dtype=torch.float32, device=prev.device)
    good = torch.ones((N,), dtype=torch.bool, device=prev.device)
    for lvl in reversed(range(levels)):
        scale = 2.0**lvl
        flow, good_l = _lk_level(pyr_prev[lvl], pyr_next[lvl], points / scale, flow / scale, window, iters)
        flow = flow * scale
        good = good & good_l

    new_pts = points + flow
    H, W = prev.shape
    inb = (new_pts[:, 0] >= 0) & (new_pts[:, 0] <= W - 1) & (new_pts[:, 1] >= 0) & (new_pts[:, 1] <= H - 1)
    return new_pts, good & inb


def dense_flow(prev_img: torch.Tensor, next_img: torch.Tensor, stride: int = 8, levels: int = 3, window: int = 15,
               iters: int = 10):
    """Flow on a stride grid: (pts (N, 2), flow (N, 2), valid (N,))."""
    img = _to_gray(torch.as_tensor(prev_img).float())
    H, W = img.shape
    ys = torch.arange(stride // 2, H, stride, dtype=torch.float32, device=img.device)
    xs = torch.arange(stride // 2, W, stride, dtype=torch.float32, device=img.device)
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    pts = torch.stack([xx.reshape(-1), yy.reshape(-1)], dim=-1)
    new_pts, valid = track_points(prev_img, next_img, pts, levels=levels, window=window, iters=iters)
    return pts, new_pts - pts, valid
