"""Per-frame inference: segmentation + backbone + pooling + head.

Port of wild_visual_navigation_tpu/runtime/fused.py (its DINO frame function):

    image -> resize / normalise -> ViT dense features (K1 in every block)
    -> SLIC (K3) or grid segmentation -> per-segment pooling, adjacency
    and centres -> per-pixel MLP traversability + confidence (K2)

The ViT and the head are nn.Modules that carry their weights, so the
returned `frame(cg_state, img)` takes only what changes between frames.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.registry import apply_model
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
    """Returns frame(cg_state, img) -> FrameResult, with
    frame.frames_batch(cg_state, imgs) -> FrameResult of stacked fields
    and frame.tail(cg_state, feat, segs), the post-backbone stage.

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

    def _segments(x):
        if segmentation_type == "slic":
            return slic_batch(x, num_components=S, compactness=slic_compactness, iterations=slic_iterations)
        grid = segment_ops.segment_grid(H, W, cell_size, device=x.device)
        return grid[None].expand(x.shape[0], H, W)

    grid_graph = None
    if segmentation_type == "grid":
        grid_graph = segment_ops.grid_constants(H, W, cell_size, S, max_edges=max_edges)

    def _one(cg_state, feat_i, seg, trav=None, conf=None):
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
    def tail(cg_state: ConfidenceState, feat: torch.Tensor, segs: torch.Tensor) -> FrameResult:
        """feat (B, D, Hp, Wp), segs (B, H, W) -> FrameResult with a
        leading batch axis on every field."""
        trav_b = conf_b = None
        if prediction_per_pixel and not score_at_patch_res and pixelwise_supports(mlp):
            # Gram per-pixel scorer over the whole batch: one K2 launch
            trav_b, conf_b = pixelwise_score(mlp, feat, H, W, cg_cfg, cg_state)
        outs = [
            _one(cg_state, feat[b], segs[b], None if trav_b is None else trav_b[b], None if conf_b is None else conf_b[b])
            for b in range(feat.shape[0])
        ]
        return FrameResult(*(torch.stack(field) for field in zip(*outs)))

    @torch.no_grad()
    def frames_batch(cg_state: ConfidenceState, imgs: torch.Tensor) -> FrameResult:
        """(B, 3, H0, W0) -> FrameResult with a leading batch axis; the
        backbone, SLIC and the per-pixel scorer each run once on the batch."""
        if imgs.dtype == torch.uint8:
            imgs = imgs.float() / 255.0
        x = resize_image(imgs, H, W)
        feat = dense_features(vit, imagenet_normalize(x))  # (B, D, Hp, Wp)
        return tail(cg_state, feat, _segments(x))

    def frame(cg_state: ConfidenceState, img: torch.Tensor) -> FrameResult:
        return FrameResult(*(f[0] for f in frames_batch(cg_state, img)))

    frame.frames_batch = frames_batch
    frame.tail = tail
    return frame
