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

An image's tiles are split over the CTAs of thread-block clusters; each
cluster adds its rows on chip, through distributed shared memory, and the
clusters of one image join through one global level. `step_layout` sizes
the launch from the shape and the clusters the card holds at once (an
image at 224 x 224 over 7 clusters of 16 CTAs on an H100, whatever the
batch). `slic_step.variant_launches` counts the launches by layout:
"cluster" where one cluster holds the image (images of 16 tiles or fewer;
its global level reads back only its own sums) and "cluster+ticket" where
the global level joins several.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..utils.devices import resident
from . import _cuda
from .slic import _assign_plain, init_index, pixel_features, rgb_to_lab, slic_geometry

TILE = 16  # = kTile of csrc/slic_step.cu: a CTA takes whole 16 x 16 tiles, a warp a part of one
MAX_K = 512
TOL_SCALE = 2.0**-18  # the candidate margin's factor, kTolScale in the kernel
MAX_CLUSTER = 16  # the H100's largest thread-block cluster (non-portable), kMaxCluster
MAX_WARPS = 16  # kMaxWarps
SMEM_FLOATS = (232448 - 16) // 4  # kSmemLimit: 227 KB less the kernel's static shared memory


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


@dataclass(frozen=True)
class StepLayout:
    """How K3 splits one image: `clusters` thread-block clusters of
    `cluster_size` CTAs, each CTA `tiles` tiles of `parts` warps."""

    clusters: int
    cluster_size: int
    tiles: int
    parts: int

    @property
    def variant(self) -> str:
        """One cluster an image or several, as `slic_step.variant_launches`
        counts it."""
        return "cluster" if self.clusters == 1 else "cluster+ticket"


def _smem_floats(K: int, warps: int, cluster_size: int, tiles: int) -> int:
    """csrc/slic_step.cu::smem_bytes in floats: the centres' terms, each
    warp's rows, the owner's inbox, the tiles' candidate lists."""
    return 15 * K + 6 * warps * K + 6 * cluster_size * -(-K // cluster_size) + 33 * tiles * -(-K // 32)


def step_layout(height: int, width: int, K: int, slots: int) -> StepLayout:
    """K3's launch for an (height, width) image with K centres, on a card
    that holds `slots` clusters of 16 CTAs at once. The image's tiles spread
    over as many clusters as the card holds, no more than fill them (224 x
    224: 7 clusters of 16 CTAs, 2 tiles each); a batch launches that many
    for each image, so an image's sums, and its ids, do not depend on the
    batch. A CTA's tile is split over 8, 4, 2 or 1 warps, as many as its 16
    warps and its shared memory take; where they do not take its tiles, the
    image takes more clusters."""
    tiles = num_tiles(height, width)
    size = min(MAX_CLUSTER, tiles)
    clusters = max(1, min(slots, -(-tiles // size)))
    while True:
        per_cta = -(-tiles // (clusters * size))
        for parts in (8, 4, 2, 1):
            warps = per_cta * parts
            if warps <= MAX_WARPS and _smem_floats(K, warps, size, per_cta) <= SMEM_FLOATS:
                return StepLayout(clusters, size, per_cta, parts)
        clusters += 1


def cluster_slots(device) -> int:
    """Clusters of 16 CTAs the card holds at once (csrc/slic_step.cu::
    wvn_slic_step_cluster_slots; 7 on an H100), asked once per device."""
    dev = torch.device(device)
    index = dev.index if dev.index is not None else torch.cuda.current_device()

    def ask() -> int:
        with torch.cuda.device(index):
            n = _cuda.library().wvn_slic_step_cluster_slots()
        if n <= 0:
            _cuda.check(-n, "slic_step: cluster slots")
        return n

    return resident(("slic_cluster_slots", index), ask)


def _layout(height: int, width: int, K: int, device) -> StepLayout:
    return step_layout(height, width, K, cluster_slots(device))


@dataclass
class SlicScratch:
    """K3's buffers for one (B, H, W, K): the ids, two centre buffers that
    the steps alternate between, each cluster's summed rows and a ticket
    per cluster rank (zero between launches)."""

    ids: torch.Tensor  # (B, HW) int32
    centers: tuple[torch.Tensor, torch.Tensor]  # 2 x (B, K, 5) fp32
    partials: torch.Tensor  # (B, clusters, K, 6) fp32, each cluster's sums
    tickets: torch.Tensor  # (B, 16) int32

    @classmethod
    def allocate(cls, B: int, height: int, width: int, K: int, device) -> SlicScratch:
        clusters = _layout(height, width, K, device).clusters
        return cls(
            ids=torch.empty((B, height * width), dtype=torch.int32, device=device),
            centers=tuple(torch.empty((B, K, 5), dtype=torch.float32, device=device) for _ in range(2)),
            partials=torch.empty((B, clusters, K, 6), dtype=torch.float32, device=device),
            tickets=torch.zeros((B, MAX_CLUSTER), dtype=torch.int32, device=device),
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
    layout = _layout(height, width, K, feats.device)
    if scratch is None:
        scratch = SlicScratch.allocate(B, height, width, K, feats.device)
    elif scratch.ids.shape != (B, HW) or scratch.partials.shape[1:3] != (layout.clusters, K):
        raise ValueError(f"slic_step: scratch for {tuple(scratch.ids.shape)}, K={scratch.partials.shape[2]} "
                         f"does not fit ({B}, {HW}), K={K}")
    new_centers = scratch.other(centers)
    _cuda.require_cuda("slic_step", feats, centers, scratch.ids, new_centers, scratch.partials, scratch.tickets)
    lib = _cuda.library()
    with torch.cuda.device(feats.device):
        err = lib.wvn_slic_step(
            feats.data_ptr(), centers.data_ptr(), scratch.ids.data_ptr(), new_centers.data_ptr(),
            scratch.partials.data_ptr(), scratch.tickets.data_ptr(), B, height, width, K, layout.clusters,
            layout.cluster_size, layout.tiles, layout.parts, ws, win2, _cuda.stream_of(feats),
        )
    _cuda.check(err, "slic_step")
    _cuda.count_launch(slic_step, layout.variant)
    return scratch.ids, new_centers


slic_step.launches = 0
slic_step.variant_launches = {}  # launches by reduction path (`StepLayout.variant`), reset with `launches`


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
