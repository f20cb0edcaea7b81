"""Batched SLIC whose Lloyd step is kernel K3 (csrc/slic_step.cu).

Port of wild_visual_navigation_tpu/ops/slic_fused.py. One step assigns
every pixel to its nearest centre (ops/slic.py semantics) and writes
per-block cluster sums (B, nblocks, K, 6): five feature sums and a
count. The block axis is summed here with `torch.sum`, in a fixed order;
the update (division, empty clusters keep their centre) and the loop stay
in torch, as the reference keeps them outside its kernel.

Single-step ids from the same centres are identical between K3 and
`slic_step_plain`. Across iterations the per-block sums round in another
order than a whole-image sum, so boundary pixels can move.
"""

from __future__ import annotations

import torch

from . import _cuda
from .slic import _assign_plain, _init_index, pixel_features, rgb_to_lab, slic_geometry

PIXELS_PER_BLOCK = 256  # = kThreads of csrc/slic_step.cu


def slic_step_plain(feats: torch.Tensor, centers: torch.Tensor, width: int, ws: float, win2: float):
    """Plain version of K3. feats (B, 5, HW), centers (B, K, 5) ->
    (ids (B, HW) int32, partials (B, nblocks, K, 6) fp32)."""
    B, _, HW = feats.shape
    K = centers.shape[1]
    P = PIXELS_PER_BLOCK
    nblk = -(-HW // P)
    ids = torch.stack([_assign_plain(feats[b], centers[b], width, ws, win2) for b in range(B)])
    pad = nblk * P - HW
    rows = torch.cat([feats.transpose(1, 2), torch.ones_like(feats[:, :1]).transpose(1, 2)], dim=2)  # (B, HW, 6)
    rows = torch.nn.functional.pad(rows, (0, 0, 0, pad)).reshape(B, nblk, P, 6)
    ids_p = torch.nn.functional.pad(ids, (0, pad), value=-1).reshape(B, nblk, P)
    onehot = (ids_p[..., None] == torch.arange(K, device=feats.device)).float()  # (B, nblk, P, K)
    partials = torch.einsum("bnpk,bnpc->bnkc", onehot, rows)
    return ids.to(torch.int32), partials


def slic_step(feats: torch.Tensor, centers: torch.Tensor, width: int, ws: float, win2: float):
    """One assign + accumulate step: K3 for CUDA tensors, the plain
    version for CPU tensors. Same contract as `slic_step_plain`."""
    if feats.device.type == "cpu":
        return slic_step_plain(feats, centers, width, ws, win2)
    if feats.device.type != "cuda":
        raise ValueError(f"slic_step: unsupported device {feats.device}")
    B, C, HW = feats.shape
    K = centers.shape[1]
    if C != 5 or centers.shape != (B, K, 5) or HW % width:
        raise ValueError(f"slic_step: expected feats (B, 5, HW) and centers (B, K, 5), got {feats.shape}, {centers.shape}")
    if feats.dtype != torch.float32 or centers.dtype != torch.float32:
        raise ValueError("slic_step: feats and centers must be float32")
    if K > 512:
        raise ValueError(f"slic_step: the kernel takes at most 512 centres, got {K}")
    _cuda.require_cuda("slic_step", feats, centers)
    nblk = -(-HW // PIXELS_PER_BLOCK)
    ids = torch.empty((B, HW), dtype=torch.int32, device=feats.device)
    partials = torch.empty((B, nblk, K, 6), dtype=torch.float32, device=feats.device)
    lib = _cuda.library()
    with torch.cuda.device(feats.device):
        err = lib.wvn_slic_step(
            feats.data_ptr(), centers.data_ptr(), ids.data_ptr(), partials.data_ptr(),
            B, HW, width, K, ws, win2, _cuda.stream_of(feats),
        )
    _cuda.check(err, "slic_step")
    slic_step.launches += 1
    return ids, partials


slic_step.launches = 0


def slic_batch_fused(imgs: torch.Tensor, num_components: int = 100, compactness: float = 10.0,
                     iterations: int = 10) -> torch.Tensor:
    """(B, 3, H, W) RGB in [0, 1] -> (B, H, W) int32 ids in
    [0, num_components): `iterations` steps plus a final assignment."""
    B, _, H, W = imgs.shape
    K = num_components
    ws, win2 = slic_geometry(K, compactness, H, W)
    feats = pixel_features(rgb_to_lab(imgs.float()), ws)  # (B, 5, HW)
    centers = feats[:, :, _init_index(K, H, W).to(imgs.device)].transpose(1, 2).contiguous()  # (B, K, 5)
    for _ in range(iterations):
        _, partials = slic_step(feats, centers, W, ws, win2)
        acc = partials.sum(dim=1)  # (B, K, 6)
        counts = acc[..., 5:6]
        centers = torch.where(counts > 0, acc[..., :5] / counts.clamp_min(1.0), centers).contiguous()
    ids, _ = slic_step(feats, centers, W, ws, win2)
    return ids.reshape(B, H, W)
