"""SLIC superpixels as a dense k-means over (L, a, b, y·ws, x·ws).

Port of wild_visual_navigation_tpu/ops/slic.py. Lloyd iterations from
grid-placed centres with SLIC's 2S search window, dense over all K
centres (a windowed candidate search changes the assignments on smooth
images), first-index argmin, and an orphan fallback to the spatially
nearest centre. Output ids are stable grid positions.

`slic` is the plain whole-image form. `slic_batch` runs the Lloyd loop
of ops/slic_fused.py, whose step is kernel K3 on CUDA tensors.
"""

from __future__ import annotations

import math

import numpy as np
import torch

BIG = 1e30


def rgb_to_lab(rgb: torch.Tensor) -> torch.Tensor:
    """sRGB in [0, 1], shape (..., 3, H, W) -> CIELAB (..., 3, H, W)."""
    r, g, b = rgb.unbind(-3)

    def inv_gamma(c):
        return torch.where(c > 0.04045, ((c + 0.055) / 1.055) ** 2.4, c / 12.92)

    r, g, b = inv_gamma(r), inv_gamma(g), inv_gamma(b)
    x = 0.4124564 * r + 0.3575761 * g + 0.1804375 * b
    y = 0.2126729 * r + 0.7151522 * g + 0.0721750 * b
    z = 0.0193339 * r + 0.1191920 * g + 0.9503041 * b
    xn, yn, zn = 0.95047, 1.0, 1.08883

    def f(t):
        return torch.where(t > (6 / 29) ** 3, torch.pow(t, 1.0 / 3.0), t / (3 * (6 / 29) ** 2) + 4 / 29)

    fx, fy, fz = f(x / xn), f(y / yn), f(z / zn)
    return torch.stack([116 * fy - 16, 500 * (fx - fy), 200 * (fy - fz)], dim=-3)


def _grid_centers(num_components: int, height: int, width: int) -> torch.Tensor:
    """Initial centre pixel coordinates on a regular grid: (K, 2) (y, x),
    float32 on the CPU, as the reference computes them."""
    ky = max(1, round(math.sqrt(num_components * height / width)))
    kx = max(1, math.ceil(num_components / ky))
    ys = (torch.arange(ky, dtype=torch.float32) + 0.5) * (height / ky)
    xs = (torch.arange(kx, dtype=torch.float32) + 0.5) * (width / kx)
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    coords = torch.stack([yy.reshape(-1), xx.reshape(-1)], dim=-1)[:num_components]
    if coords.shape[0] < num_components:
        coords = torch.cat([coords, coords[-1:].expand(num_components - coords.shape[0], 2)])
    return coords


def _init_index(num_components: int, height: int, width: int) -> torch.Tensor:
    yx = _grid_centers(num_components, height, width)
    idx = yx[:, 0].to(torch.int64) * width + yx[:, 1].to(torch.int64)
    return idx.clamp(0, height * width - 1)


def slic_geometry(num_components: int, compactness: float, height: int, width: int):
    """(ws, win2): the spatial weight and the squared 2S window, rounded
    to float32 so that torch and the kernel see the same values."""
    S = (height * width / num_components) ** 0.5
    return float(np.float32(compactness / S)), float(np.float32((2.0 * S) ** 2))


def pixel_features(lab: torch.Tensor, ws: float) -> torch.Tensor:
    """(B, 3, H, W) Lab -> (B, 5, H·W) rows L, a, b, y·ws, x·ws."""
    B, _, H, W = lab.shape
    ys = torch.arange(H, dtype=torch.float32, device=lab.device)[:, None].expand(H, W)
    xs = torch.arange(W, dtype=torch.float32, device=lab.device)[None, :].expand(H, W)
    yx = torch.stack([ys * ws, xs * ws]).reshape(1, 2, H * W).expand(B, 2, H * W)
    return torch.cat([lab.reshape(B, 3, H * W), yx], dim=1).contiguous()


def _sum5(a: list[torch.Tensor]) -> torch.Tensor:
    out = a[0]
    for t in a[1:]:
        out = out + t
    return out


def _assign_plain(feats: torch.Tensor, centers: torch.Tensor, width: int, ws: float, win2: float) -> torch.Tensor:
    """Nearest-centre ids of one image: feats (5, HW), centers (K, 5) -> (HW,) int64.

    Every sum is written out term by term, in the order kernel K3
    (csrc/slic_step.cu) evaluates it, so the two give identical ids."""
    HW = feats.shape[1]
    f = [feats[i][:, None] for i in range(5)]
    c = [centers[:, i][None, :] for i in range(5)]
    p2 = _sum5([fi * fi for fi in f])
    c2 = _sum5([ci * ci for ci in c])
    dots = _sum5([fi * ci for fi, ci in zip(f, c)])
    d2 = p2 - 2.0 * dots + c2
    ws_t = torch.tensor(ws, dtype=torch.float32, device=feats.device)
    cy, cx = c[3] / ws_t, c[4] / ws_t
    pix = torch.arange(HW, device=feats.device)
    py = torch.div(pix, width, rounding_mode="floor").float()[:, None]
    px = (pix % width).float()[:, None]
    yx2 = py * py + px * px
    cyx2 = cy * cy + cx * cx
    d2s = yx2 - 2.0 * (py * cy + px * cx) + cyx2
    best = torch.argmin(torch.where(d2s <= win2, d2, BIG), dim=1)
    min_s, best_s = torch.min(d2s, dim=1)  # first minimal index, as argmin
    return torch.where(min_s > win2, best_s, best)


def slic(img: torch.Tensor, num_components: int = 100, compactness: float = 10.0, iterations: int = 10) -> torch.Tensor:
    """img: (3, H, W) RGB in [0, 1] -> (H, W) int32 ids in
    [0, num_components): the plain whole-image Lloyd loop."""
    _, H, W = img.shape
    K = num_components
    ws, win2 = slic_geometry(K, compactness, H, W)
    feats = pixel_features(rgb_to_lab(img)[None], ws)[0]  # (5, HW)
    centers = feats[:, _init_index(K, H, W).to(img.device)].T.contiguous()  # (K, 5)
    for _ in range(iterations):
        ids = _assign_plain(feats, centers, W, ws, win2)
        onehot = (ids[:, None] == torch.arange(K, device=img.device)[None, :]).float()
        sums = onehot.T @ feats.T  # (K, 5)
        counts = onehot.sum(0)[:, None]
        centers = torch.where(counts > 0, sums / counts.clamp_min(1.0), centers)
    return _assign_plain(feats, centers, W, ws, win2).reshape(H, W).to(torch.int32)


def slic_batch(imgs: torch.Tensor, num_components: int = 100, compactness: float = 10.0,
               iterations: int = 10) -> torch.Tensor:
    """(B, 3, H, W) RGB in [0, 1] -> (B, H, W) int32 ids. The Lloyd
    loop of slic_fused.slic_batch_fused; its step is K3 on CUDA."""
    from .slic_fused import slic_batch_fused

    return slic_batch_fused(imgs, num_components, compactness, iterations)
