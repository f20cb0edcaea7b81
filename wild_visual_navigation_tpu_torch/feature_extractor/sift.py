"""Dense SIFT descriptors.

Port of wild_visual_navigation_tpu/feature_extractor/sift.py. Per pixel:
image gradients -> soft orientation histogram (8 angular bins) -> 4x4
spatial grid of average-pooled bins -> 128-d descriptor, L2-normalised
with the standard 0.2 clipping. `dense_sift_features` runs it on each RGB
channel and concatenates (3 x 128 = 384 dims), all channels in one batch.

Pools and rolls only, no loop over pixels. The 4x4 grid is gathered by
`torch.roll`, which wraps around the image edge, as the JAX package's
`jnp.roll` does.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

_NUM_ANG_BINS = 8
_NUM_SPATIAL_BINS = 4
_BIN_SIZE = 4  # pixels per spatial bin edge
_OFFSETS = [int(round((i - (_NUM_SPATIAL_BINS - 1) / 2.0) * _BIN_SIZE)) for i in range(_NUM_SPATIAL_BINS)]


def _gradients(img: torch.Tensor):
    """Central-difference gradients of (C, H, W) with replicate padding."""
    p = F.pad(img[:, None], (1, 1, 1, 1), mode="replicate")[:, 0]
    gx = (p[:, 1:-1, 2:] - p[:, 1:-1, :-2]) * 0.5
    gy = (p[:, 2:, 1:-1] - p[:, :-2, 1:-1]) * 0.5
    return gx, gy


def _avg_pool_same(x: torch.Tensor, k: int) -> torch.Tensor:
    """Mean filter with window k on (N, C, H, W), edge padding of k // 2
    before and k - 1 - k // 2 after (2 and 1 for k = 4)."""
    pad = k // 2
    xp = F.pad(x, (pad, k - 1 - pad, pad, k - 1 - pad), mode="replicate")
    return F.avg_pool2d(xp, k, stride=1)


def _dense_sift(img: torch.Tensor) -> torch.Tensor:
    """(C, H, W) channels -> (C, 128, H, W) dense SIFT descriptors."""
    gx, gy = _gradients(img.float())
    mag = torch.sqrt(gx * gx + gy * gy + 1e-12)
    ori = torch.atan2(gy, gx)  # [-pi, pi]

    # soft assignment to the two nearest angular bin centres
    o = (ori + math.pi) / (2 * math.pi) * _NUM_ANG_BINS  # [0, 8]
    b0 = torch.floor(o - 0.5)
    w1 = o - 0.5 - b0
    b0 = torch.remainder(b0, _NUM_ANG_BINS).to(torch.int32)  # -1 -> 7
    b1 = torch.remainder(b0 + 1, _NUM_ANG_BINS)
    bins = torch.arange(_NUM_ANG_BINS, device=img.device, dtype=torch.int32)[:, None, None]
    hist = (bins == b0[:, None]) * (mag * (1 - w1))[:, None] + (bins == b1[:, None]) * (mag * w1)[:, None]

    pooled = _avg_pool_same(hist, _BIN_SIZE)  # (C, 8, H, W)
    desc = torch.cat([torch.roll(pooled, shifts=(-sy, -sx), dims=(2, 3)) for sy in _OFFSETS for sx in _OFFSETS],
                     dim=1)  # (C, 128, H, W)

    # SIFT normalisation: L2 -> clip 0.2 -> L2
    norm = torch.sqrt(torch.sum(desc * desc, dim=1, keepdim=True) + 1e-12)
    desc = torch.clamp_max(desc / norm, 0.2)
    norm2 = torch.sqrt(torch.sum(desc * desc, dim=1, keepdim=True) + 1e-12)
    return desc / norm2


def dense_sift_channel(img: torch.Tensor) -> torch.Tensor:
    """(H, W) single channel -> (128, H, W) dense SIFT descriptors."""
    return _dense_sift(img[None])[0]


def dense_sift_features(img: torch.Tensor) -> torch.Tensor:
    """(3, H, W) RGB -> (384, H, W): per-channel dense SIFT concatenated.
    A single-channel input gives (128, H, W)."""
    if img.shape[0] == 3:
        return _dense_sift(img).reshape(3 * 128, *img.shape[1:])
    return dense_sift_channel(img[0])
