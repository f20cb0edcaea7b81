"""Dense colour-histogram features.

Port of wild_visual_navigation_tpu/ops/histogram.py. Each pixel becomes a
soft one-hot over a 10 (hue) x 3 (saturation) x 3 (value) = 90-bin HSV
grid, so the per-segment mean pooling of this dense field is the segment's
normalised colour histogram. Hue is binned with a circular triangular
kernel (red near 0 and near 1 shares bins); saturation and value with hard
bins. Elementwise, on any device.
"""

from __future__ import annotations

import torch

HIST_BINS = (10, 3, 3)  # hue, saturation, value -> 90 dims
HIST_DIM = HIST_BINS[0] * HIST_BINS[1] * HIST_BINS[2]


def rgb_to_hsv(img: torch.Tensor) -> torch.Tensor:
    """(3, H, W) RGB in [0, 1] -> (3, H, W) HSV, hue in [0, 1)."""
    r, g, b = img[0], img[1], img[2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    v = maxc
    delta = maxc - minc
    s = torch.where(maxc > 0, delta / torch.clamp_min(maxc, 1e-12), 0.0)
    safe = torch.clamp_min(delta, 1e-12)
    hr = torch.remainder((g - b) / safe, 6.0)  # floor-mod, as jnp's %
    hg = (b - r) / safe + 2.0
    hb = (r - g) / safe + 4.0
    # ties go to red first, then green
    h = torch.where(maxc == r, hr, torch.where(maxc == g, hg, hb)) / 6.0
    h = torch.where(delta > 0, torch.remainder(h, 1.0), 0.0)
    return torch.stack([h, s, v])


def _hard_onehot(x: torch.Tensor, n: int) -> torch.Tensor:
    """(H, W) in [0, 1] -> (n, H, W) one-hot of the bin `int(x * n)`
    (truncation toward zero), clipped to [0, n - 1]."""
    idx = torch.clamp((x * n).to(torch.int32), 0, n - 1)
    return (idx[None] == torch.arange(n, device=x.device, dtype=torch.int32)[:, None, None]).to(x.dtype)


def dense_color_histogram(img: torch.Tensor) -> torch.Tensor:
    """(3, H, W) RGB in [0, 1] -> (90, H, W) soft HSV-bin encoding. Per
    pixel the 90 channels sum to 1."""
    nh, ns, nv = HIST_BINS
    h, s, v = rgb_to_hsv(img)
    centers = (torch.arange(nh, dtype=img.dtype, device=img.device) + 0.5) / nh
    d = torch.abs(h[None] - centers[:, None, None])  # (nh, H, W)
    d = torch.minimum(d, 1.0 - d)  # circular distance
    hue_w = torch.clamp(1.0 - d * nh, 0.0, 1.0)  # triangular kernel, width 2 / nh
    hue_w = hue_w / torch.clamp_min(hue_w.sum(0, keepdim=True), 1e-12)
    sat_w = _hard_onehot(s, ns)
    val_w = _hard_onehot(v, nv)
    out = hue_w[:, None, None] * sat_w[None, :, None] * val_w[None, None, :]  # (nh, ns, nv, H, W)
    return out.reshape(HIST_DIM, *img.shape[1:])
