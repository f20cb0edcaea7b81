"""Batched SLIC whose Lloyd step is kernel K3 (csrc/slic_step.cu).

Port of wild_visual_navigation_tpu/ops/slic_fused.py. One step,
`slic_step(feats, centers, width, ws, win2) -> (ids, new_centers)`,
assigns every pixel to its nearest centre (ops/slic.py semantics), sums
the features and counts per cluster and divides: new centres are the
cluster means, an empty cluster keeping its centre. On the card the whole
step, update included, is one launch of K3, so `slic_batch_fused` is the
feature preparation followed by `iterations + 1` launches with no torch op
between them; the centres ping-pong between two buffers of a
`SlicScratch`.

K3 searches, per 16 x 16 tile, only the centres that `tile_candidates_plain`
lists: those within sqrt(win2) of the tile's box, plus a margin that covers
the fp32 rounding of the window test (csrc/slic_step.cu gives the bound).
No centre that passes the window test at a pixel of the tile is left out,
so the windowed argmin over the list is the argmin over all K, and a pixel
with no passing candidate is a true orphan, which scans all K. Single-step
ids from the same centres are therefore identical between K3 and
`slic_step_plain`. The sums are taken in another order than the plain
version's whole-image sum, so across iterations boundary pixels can move.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import _cuda
from .slic import _assign_plain, init_index, pixel_features, rgb_to_lab, slic_geometry

TILE = 16  # = kTile of csrc/slic_step.cu: a block's pixels are a 16 x 16 tile
MAX_K = 512
TOL_SCALE = 2.0**-18  # the candidate margin's factor, kTolScale in the kernel


def num_tiles(height: int, width: int) -> int:
    return -(-height // TILE) * -(-width // TILE)


def tile_candidates_plain(centers: torch.Tensor, height: int, width: int, ws: float, win2: float) -> torch.Tensor:
    """K3's candidate rule: centers (B, K, 5) -> (B, tiles, K) bool, tiles
    in row-major order. Centre k is a candidate of a tile when its
    unscaled position lies within sqrt(win2) of the tile's box, with the
    margin 2^-18 (P + 2Q + C + win2) (P: the box's far corner squared, Q:
    its products with |cy|, |cx|, C: the centre's squared norm), evaluated
    in the kernel's order."""
    dev = centers.device
    ws_t = torch.tensor(ws, dtype=torch.float32, device=dev)
    cy = (centers[..., 3] / ws_t)[:, None, None, :]  # (B, 1, 1, K)
    cx = (centers[..., 4] / ws_t)[:, None, None, :]
    y0 = torch.arange(0, height, TILE, dtype=torch.float32, device=dev)
    x0 = torch.arange(0, width, TILE, dtype=torch.float32, device=dev)
    y1 = torch.clamp_max(y0 + (TILE - 1), height - 1)[:, None, None]  # (ty, 1, 1)
    x1 = torch.clamp_max(x0 + (TILE - 1), width - 1)[None, :, None]  # (1, tx, 1)
    y0, x0 = y0[:, None, None], x0[None, :, None]
    dy = torch.clamp_min(torch.maximum(y0 - cy, cy - y1), 0.0)
    dx = torch.clamp_min(torch.maximum(x0 - cx, cx - x1), 0.0)
    d2 = dy * dy + dx * dx
    q = y1 * cy.abs() + x1 * cx.abs()
    t = (y1 * y1 + x1 * x1) + 2.0 * q
    t = t + (cy * cy + cx * cx)
    t = t + win2
    cand = d2 <= win2 + t * TOL_SCALE  # (B, ty, tx, K)
    return cand.reshape(centers.shape[0], -1, centers.shape[1])


def slic_step_plain(feats: torch.Tensor, centers: torch.Tensor, width: int, ws: float, win2: float):
    """Plain version of K3. feats (B, 5, HW), centers (B, K, 5) ->
    (ids (B, HW) int32, new_centers (B, K, 5) fp32), the sums taken over
    the whole image at once."""
    K = centers.shape[1]
    ids = torch.stack([_assign_plain(feats[b], centers[b], width, ws, win2) for b in range(feats.shape[0])])
    onehot = (ids[..., None] == torch.arange(K, device=feats.device)).float()  # (B, HW, K)
    sums = torch.einsum("bpk,bcp->bkc", onehot, feats)
    counts = onehot.sum(1)[..., None]
    new_centers = torch.where(counts > 0, sums / counts.clamp_min(1.0), centers)
    return ids.to(torch.int32), new_centers


@dataclass
class SlicScratch:
    """K3's buffers for one (B, H, W, K): the ids, two centre buffers that
    the steps alternate between, per-tile partial rows with their mask, the
    per-tile-row sums with theirs, and per image a ticket and one per tile
    row (zero between launches)."""

    ids: torch.Tensor  # (B, HW) int32
    centers: tuple[torch.Tensor, torch.Tensor]  # 2 x (B, K, 5) fp32
    partials: torch.Tensor  # (B, tiles, K, 6) fp32, only the tile's candidate rows written
    mask: torch.Tensor  # (B, tiles, ceil(K / 32)) int32 bit masks of the written rows
    rowsums: torch.Tensor  # (B, ceil(H / 16), K, 6) fp32
    rowmask: torch.Tensor  # (B, ceil(H / 16), ceil(K / 32)) int32 bit masks of the clusters in each tile row
    tickets: torch.Tensor  # (B, 1 + ceil(H / 16)) int32

    @classmethod
    def allocate(cls, B: int, height: int, width: int, K: int, device) -> SlicScratch:
        tiles = num_tiles(height, width)
        return cls(
            ids=torch.empty((B, height * width), dtype=torch.int32, device=device),
            centers=tuple(torch.empty((B, K, 5), dtype=torch.float32, device=device) for _ in range(2)),
            partials=torch.empty((B, tiles, K, 6), dtype=torch.float32, device=device),
            mask=torch.empty((B, tiles, -(-K // 32)), dtype=torch.int32, device=device),
            rowsums=torch.empty((B, -(-height // TILE), K, 6), dtype=torch.float32, device=device),
            rowmask=torch.empty((B, -(-height // TILE), -(-K // 32)), dtype=torch.int32, device=device),
            tickets=torch.zeros((B, 1 + -(-height // TILE)), dtype=torch.int32, device=device),
        )

    def other(self, centers: torch.Tensor) -> torch.Tensor:
        """The centre buffer that `centers` is not."""
        return self.centers[1] if centers.data_ptr() == self.centers[0].data_ptr() else self.centers[0]


def slic_step(feats: torch.Tensor, centers: torch.Tensor, width: int, ws: float, win2: float,
              scratch: SlicScratch | None = None):
    """One assign + update step: K3 for CUDA tensors, the plain version for
    CPU tensors. Same contract as `slic_step_plain`. With `scratch`, the
    ids go to scratch.ids and the new centres to the scratch centre buffer
    that `centers` is not; without, the step allocates its own."""
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
    if K > MAX_K:
        raise ValueError(f"slic_step: the kernel takes at most {MAX_K} centres, got {K}")
    height = HW // width
    if scratch is None:
        scratch = SlicScratch.allocate(B, height, width, K, feats.device)
    elif scratch.ids.shape != (B, HW) or scratch.rowsums.shape[1:3] != (-(-height // TILE), K):
        raise ValueError(f"slic_step: scratch for {tuple(scratch.ids.shape)}, K={scratch.partials.shape[2]} "
                         f"does not fit ({B}, {HW}), K={K}")
    new_centers = scratch.other(centers)
    _cuda.require_cuda("slic_step", feats, centers, scratch.ids, new_centers, scratch.partials, scratch.mask,
                       scratch.rowsums, scratch.rowmask, scratch.tickets)
    lib = _cuda.library()
    with torch.cuda.device(feats.device):
        err = lib.wvn_slic_step(
            feats.data_ptr(), centers.data_ptr(), scratch.ids.data_ptr(), new_centers.data_ptr(),
            scratch.partials.data_ptr(), scratch.mask.data_ptr(), scratch.rowsums.data_ptr(),
            scratch.rowmask.data_ptr(), scratch.tickets.data_ptr(), B, height, width, K, ws, win2,
            _cuda.stream_of(feats),
        )
    _cuda.check(err, "slic_step")
    _cuda.count_launch(slic_step)
    return scratch.ids, new_centers


slic_step.launches = 0


def slic_batch_fused(imgs: torch.Tensor, num_components: int = 100, compactness: float = 10.0,
                     iterations: int = 10, interpret: bool = False) -> torch.Tensor:
    """(B, 3, H, W) RGB in [0, 1] -> (B, H, W) int32 ids in
    [0, num_components): `iterations` steps plus a final assignment.
    interpret=True takes `slic_step_plain` on any device (the reference's
    interpret mode), where a CUDA image otherwise runs K3."""
    B, _, H, W = imgs.shape
    K = num_components
    ws, win2 = slic_geometry(K, compactness, H, W)
    feats = pixel_features(rgb_to_lab(imgs.float()), ws)  # (B, 5, HW)
    centers = feats[:, :, init_index(K, H, W, imgs.device)].transpose(1, 2)  # (B, K, 5)
    if interpret:
        for _ in range(iterations):
            _, centers = slic_step_plain(feats, centers, W, ws, win2)
        return slic_step_plain(feats, centers, W, ws, win2)[0].reshape(B, H, W)
    scratch = None
    if imgs.device.type == "cuda":
        scratch = SlicScratch.allocate(B, H, W, K, imgs.device)
        centers = scratch.centers[0].copy_(centers)
    for _ in range(iterations):
        _, centers = slic_step(feats, centers, W, ws, win2, scratch)
    ids, _ = slic_step(feats, centers, W, ws, win2, scratch)
    return ids.reshape(B, H, W)
