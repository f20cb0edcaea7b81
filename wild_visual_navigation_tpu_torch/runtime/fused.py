"""Per-frame inference: segmentation + backbone + pooling + head.

Port of wild_visual_navigation_tpu/runtime/fused.py, its DINO and STEGO
frame functions:

    image -> resize / normalise -> ViT dense features (K1 in every block)
    -> SLIC (K3) or grid segmentation -> per-segment pooling, adjacency
    and centres -> per-pixel MLP traversability + confidence (K2)

    image -> resize / normalise -> ViT-B/8 (K1) -> STEGO code head ->
    per-image cosine k-means -> code pooling, adjacency and centres at
    patch resolution -> per-pixel (K2) or per-segment scoring

The ViT and the head are nn.Modules that carry their weights, so the
returned `frame(cg_state, img)` takes only what changes between frames.
A caller that swaps heads while frames run (the runtime's params mailbox)
passes its own snapshot as `head=`: the frame then reads every layer from
that one module, never from one that training updates in place.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.registry import apply_model
from ..models.stego_head import cosine_kmeans, kmeans_init_indices
from ..models.vit import dense_features
from ..ops import segment_ops
from ..ops.pixelwise import pixelwise_map_rows_chunked, pixelwise_score
from ..ops.pixelwise import supports_optimized as pixelwise_supports
from ..ops.resize import imagenet_normalize, interpolate_bilinear, resize_image
from ..ops.slic import slic_batch
from ..utils.confidence_generator import ConfidenceConfig, ConfidenceState, confidence_inference


class FrameResult(NamedTuple):
    traversability: torch.Tensor  # (H, W)
    confidence: torch.Tensor  # (H, W)
    features: torch.Tensor  # (S, D) pooled
    feat_valid: torch.Tensor  # (S,)
    segments: torch.Tensor  # (H, W) int32
    edges: torch.Tensor  # (2, E)
    edge_valid: torch.Tensor  # (E,)
    centers: torch.Tensor  # (S, 2)


def _score_rows(mlp, cg_cfg, cg_state, x):
    """(N, D) feature rows -> (trav (N,), conf (N,))."""
    out = apply_model(mlp, x)
    reco = torch.mean((out[:, 1:] - x.float()) ** 2, dim=-1)
    return out[:, 0], confidence_inference(cg_cfg, cg_state, reco)


def build_fused_frame_fn(
    vit,
    mlp,
    cg_cfg: ConfidenceConfig,
    input_size: int,
    segmentation_type: str = "slic",
    num_segments: int = 100,
    slic_compactness: float = 10.0,
    slic_iterations: int = 10,
    cell_size: int = 32,
    max_edges: int = 1024,
    prediction_per_pixel: bool = True,
    score_at_patch_res: bool = False,
    input_width: int | None = None,
):
    """Returns frame(cg_state, img, head=None) -> FrameResult, with
    frame.frames_batch(cg_state, imgs, head=None) -> FrameResult of
    stacked fields and frame.tail(cg_state, feat, segs, head=None), the
    post-backbone stage. `head` scores in place of `mlp`.

    img: (1, 3, H0, W0) in [0, 1], float or uint8. Output maps are
    (input_size, input_width or input_size). Square configs resize the
    smaller edge and centre-crop; rectangular ones resize directly and
    must be patch-aligned. Anomaly heads (LinearRnvp) are not ported yet
    (ROADMAP.md Queue 1, item 22)."""
    if segmentation_type not in ("slic", "grid"):
        raise ValueError(f"fused path does not support segmentation [{segmentation_type}]")
    H = input_size
    W = input_width or input_size
    ps = vit.cfg.patch_size
    if W != H and (H % ps or W % ps):
        raise ValueError(f"rectangular fused config must be patch-aligned: {H}x{W} with patch {ps}")
    S = num_segments
    default_mlp = mlp

    def _segments(x):
        if segmentation_type == "slic":
            return slic_batch(x, num_components=S, compactness=slic_compactness, iterations=slic_iterations)
        grid = segment_ops.segment_grid(H, W, cell_size, device=x.device)
        return grid[None].expand(x.shape[0], H, W)

    grid_graph = None
    if segmentation_type == "grid":
        grid_graph = segment_ops.grid_constants(H, W, cell_size, S, max_edges=max_edges)

    def _one(mlp, cg_state, feat_i, seg, trav=None, conf=None):
        """Per-image tail. feat_i (D, Hp, Wp); seg (H, W); trav / conf
        are given when the batch was scored per pixel already."""
        if grid_graph is not None:
            edges, edge_valid, centers, _ = (t.to(seg.device) for t in grid_graph)
        else:
            edges, edge_valid = segment_ops.adjacency_list(seg, S, max_edges=max_edges)
            centers, _ = segment_ops.segment_centers(seg, S)
        D, Hp, Wp = feat_i.shape
        sid = seg.long().clamp(0, S - 1)
        if score_at_patch_res:
            ph, pw = H // Hp, W // Wp
            pooled, counts = segment_ops.segment_mean_pool(feat_i, seg[ph // 2 :: ph, pw // 2 :: pw][:Hp, :Wp], S)
            if prediction_per_pixel:
                t_r, c_r = _score_rows(mlp, cg_cfg, cg_state, feat_i.reshape(D, -1).T)
                trav = interpolate_bilinear(t_r.reshape(1, 1, Hp, Wp), H, W)[0, 0]
                conf = interpolate_bilinear(c_r.reshape(1, 1, Hp, Wp), H, W)[0, 0]
        else:
            pooled, counts = segment_ops.segment_mean_pool_upsampled(feat_i.float(), seg, S, H, W)
            if prediction_per_pixel and trav is None:
                trav, conf = pixelwise_map_rows_chunked(
                    lambda rows: _score_rows(mlp, cg_cfg, cg_state, rows), feat_i[None], H, W)
        if not prediction_per_pixel:
            t_s, c_s = _score_rows(mlp, cg_cfg, cg_state, pooled)
            trav, conf = t_s[sid], c_s[sid]
        return FrameResult(trav, conf, pooled, counts > 0, seg, edges, edge_valid, centers)

    @torch.no_grad()
    def tail(cg_state: ConfidenceState, feat: torch.Tensor, segs: torch.Tensor, head=None) -> FrameResult:
        """feat (B, D, Hp, Wp), segs (B, H, W) -> FrameResult with a
        leading batch axis on every field."""
        mlp = default_mlp if head is None else head
        trav_b = conf_b = None
        if prediction_per_pixel and not score_at_patch_res and pixelwise_supports(mlp):
            # Gram per-pixel scorer over the whole batch: one K2 launch
            trav_b, conf_b = pixelwise_score(mlp, feat, H, W, cg_cfg, cg_state)
        outs = [
            _one(mlp, cg_state, feat[b], segs[b], None if trav_b is None else trav_b[b], None if conf_b is None else conf_b[b])
            for b in range(feat.shape[0])
        ]
        return FrameResult(*(torch.stack(field) for field in zip(*outs)))

    @torch.no_grad()
    def frames_batch(cg_state: ConfidenceState, imgs: torch.Tensor, head=None) -> FrameResult:
        """(B, 3, H0, W0) -> FrameResult with a leading batch axis; the
        backbone, SLIC and the per-pixel scorer each run once on the batch."""
        if imgs.dtype == torch.uint8:
            imgs = imgs.float() / 255.0
        x = resize_image(imgs, H, W)
        feat = dense_features(vit, imagenet_normalize(x))  # (B, D, Hp, Wp)
        return tail(cg_state, feat, _segments(x), head)

    def frame(cg_state: ConfidenceState, img: torch.Tensor, head=None) -> FrameResult:
        return FrameResult(*(f[0] for f in frames_batch(cg_state, img, head)))

    frame.frames_batch = frames_batch
    frame.tail = tail
    return frame


def build_fused_stego_frame_fn(
    stego,
    mlp,
    cg_cfg: ConfidenceConfig,
    input_size: int,
    max_edges: int = 1024,
    prediction_per_pixel: bool = True,
    input_width: int | None = None,
    init_idx: torch.Tensor | None = None,
):
    """The STEGO frame: returns frame(cg_state, img, head=None) ->
    FrameResult, with frame.frames_batch(cg_state, imgs, head=None) (the
    backbone and the code head once on the batch, then the tail) and
    frame.tail(cg_state, codes, head=None) for (B, N, 90) codes.

    `stego` is a feature_extractor/stego.py::StegoInterface. Segments are
    the per-image k-means clusters (S = stego.n_image_clusters), features
    the 90-d code pooled per cluster at patch resolution. The JAX package
    seeds k-means with the same key on every frame; the port draws the
    initial indices once, here, from a torch.Generator seeded 0 (or takes
    `init_idx`, (S,)), and every image of every frame starts from them. Rectangular
    configs must be patch-aligned."""
    H = input_size
    W = input_width or input_size
    ps = stego.vit.cfg.patch_size
    if W != H and (H % ps or W % ps):
        raise ValueError(f"rectangular fused stego config must be patch-aligned: {H}x{W} with patch {ps}")
    S = stego.n_image_clusters
    hp, wp = H // ps, W // ps
    if init_idx is None:
        init_idx = kmeans_init_indices(torch.Generator().manual_seed(0), hp * wp, S)
    default_mlp = mlp
    per_device: dict = {}

    def constants(device):
        """The initial indices and the integer nearest-upsample maps on `device`."""
        if device not in per_device:
            per_device[device] = (init_idx.to(device), (torch.arange(H, device=device) * hp) // H,
                                  (torch.arange(W, device=device) * wp) // W)
        return per_device[device]

    @torch.no_grad()
    def tail(cg_state: ConfidenceState, codes: torch.Tensor, head=None) -> FrameResult:
        """codes (B, N, 90) -> FrameResult with a leading batch axis."""
        mlp = default_mlp if head is None else head
        B = codes.shape[0]
        idx, iy, ix = constants(codes.device)
        labels, _ = cosine_kmeans(codes, idx)
        seg_p = labels.reshape(B, hp, wp)
        # the integer rule (y · hp) // H, the map upsampled_adjacency_and_centers assumes
        segs = seg_p[:, iy][:, :, ix]
        code_hw = codes.reshape(B, hp, wp, -1).permute(0, 3, 1, 2)
        trav_b = conf_b = None
        if prediction_per_pixel and pixelwise_supports(mlp):
            trav_b, conf_b = pixelwise_score(mlp, code_hw, H, W, cg_cfg, cg_state)  # one K2 launch
        outs = []
        for b in range(B):
            pooled, counts = segment_ops.segment_mean_pool(code_hw[b], seg_p[b], S)
            edges, edge_valid, centers, _ = segment_ops.upsampled_adjacency_and_centers(seg_p[b], S, H, W,
                                                                                         max_edges=max_edges)
            if trav_b is not None:
                trav, conf = trav_b[b], conf_b[b]
            elif prediction_per_pixel:
                trav, conf = pixelwise_map_rows_chunked(lambda rows: _score_rows(mlp, cg_cfg, cg_state, rows),
                                                        code_hw[b : b + 1], H, W)
            else:
                t_s, c_s = _score_rows(mlp, cg_cfg, cg_state, pooled)
                sid = segs[b].long().clamp(0, S - 1)
                trav, conf = t_s[sid], c_s[sid]
            outs.append(FrameResult(trav, conf, pooled, counts > 0, segs[b], edges, edge_valid, centers))
        return FrameResult(*(torch.stack(field) for field in zip(*outs)))

    @torch.no_grad()
    def frames_batch(cg_state: ConfidenceState, imgs: torch.Tensor, head=None) -> FrameResult:
        """(B, 3, H0, W0) -> FrameResult with a leading batch axis."""
        if imgs.dtype == torch.uint8:
            imgs = imgs.float() / 255.0
        out = stego.vit(imagenet_normalize(resize_image(imgs, H, W)))
        return tail(cg_state, stego.head(out["patch_tokens"])["code"], head)

    def frame(cg_state: ConfidenceState, img: torch.Tensor, head=None) -> FrameResult:
        return FrameResult(*(f[0] for f in frames_batch(cg_state, img, head)))

    frame.frames_batch = frames_batch
    frame.tail = tail
    return frame
