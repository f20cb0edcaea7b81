"""Per-pixel traversability scoring.

Port of wild_visual_navigation_tpu/ops/pixelwise.py. Three orders of the
same math for a SimpleMLP reconstruction head:
  * "reference" — upsample the D-channel features to pixels, run the
    head on every pixel row;
  * "gram" — Dense_0 at patch resolution (it commutes with the bilinear
    upsample), bf16 rows, and the reconstruction MSE expanded through
    M = Wr Wrᵀ so no D-channel pixel-resolution tensor exists;
  * "fused" — the Gram math with everything after the patch-resolution
    precompute in kernel K2 (ops/pixelwise_fused.py); heads that fail
    its structural test take "gram".
"""

from __future__ import annotations

import torch

from ..utils.confidence_generator import ConfidenceConfig, ConfidenceState, confidence_inference
from .pixelwise_fused import dense_layers, pixelwise_score_fused, supports_fused
from .resize import bilinear_matrix, interpolate_bilinear_mxu, interpolate_norm_sq_mxu


def supports_optimized(mlp) -> bool:
    """The restructured scorers take a SimpleMLP reconstruction head
    with one sigmoid output and at least two layers."""
    return (
        type(mlp).__name__ == "SimpleMLP"
        and getattr(mlp, "reconstruction", False)
        and getattr(mlp, "nr_sigmoid_layers", None) == 1
        and len(getattr(mlp, "hidden_sizes", ())) >= 2
    )


def _upsample_nhwc(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """(B, h, w, C) -> (B, out_h, out_w, C), two-tap bilinear, in x.dtype."""
    Mh = bilinear_matrix(out_h, x.shape[1], x.device, x.dtype)
    Mw = bilinear_matrix(out_w, x.shape[2], x.device, x.dtype)
    return torch.einsum("pw,bowc->bopc", Mw, torch.einsum("oh,bhwc->bowc", Mh, x))


@torch.no_grad()
def pixelwise_score(mlp, feat: torch.Tensor, out_h: int, out_w: int, cg_cfg: ConfidenceConfig,
                    cg_state: ConfidenceState, method: str = "fused"):
    """feat (B, D, Hp, Wp) -> (trav, conf), each (B, out_h, out_w) fp32."""
    B, D = feat.shape[0], feat.shape[1]
    if method == "fused":
        if supports_fused(mlp, feat.shape, out_h, out_w):
            trav, reco = pixelwise_score_fused(mlp, feat, out_h, out_w)
            return trav, confidence_inference(cg_cfg, cg_state, reco)
        method = "gram"
    if method == "reference":
        dense = interpolate_bilinear_mxu(feat, out_h, out_w)
        flat = dense.permute(0, 2, 3, 1).reshape(-1, D)
        out = mlp(flat)
        trav = out[:, 0].reshape(B, out_h, out_w)
        reco = torch.mean((out[:, 1:] - flat.float()) ** 2, dim=-1)
        return trav, confidence_inference(cg_cfg, cg_state, reco).reshape(B, out_h, out_w)
    if method != "gram":
        raise ValueError(f"unknown method {method!r}")

    bf = torch.bfloat16
    layers = dense_layers(mlp)
    (W0, b0), mid, (Wl, bl) = layers[0], layers[1:-1], layers[-1]
    hp = torch.einsum("bdhw,dk->bhwk", feat.to(bf), W0.to(bf)) + b0.to(bf)
    rows = torch.relu(_upsample_nhwc(hp, out_h, out_w)).reshape(-1, hp.shape[-1])
    for W, b in mid:
        rows = torch.relu(rows @ W.to(bf) + b.to(bf))
    K = rows.shape[1]
    rows32 = rows.float()
    trav = torch.sigmoid(rows32 @ Wl[:, 0] + bl[0]).reshape(B, out_h, out_w)
    Wr, br = Wl[:, 1:], bl[1:]
    f32 = feat.float()
    z = _upsample_nhwc(torch.einsum("bdhw,kd->bhwk", f32, Wr), out_h, out_w).reshape(-1, K)
    s = interpolate_bilinear_mxu(torch.einsum("bdhw,d->bhw", f32, br)[:, None], out_h, out_w).reshape(-1)
    lin = rows32 @ (Wr @ Wr.T) + 2.0 * ((Wr @ br)[None, :] - z)
    reco = ((rows32 * lin).sum(-1) + br @ br - 2.0 * s + interpolate_norm_sq_mxu(f32, out_h, out_w).reshape(-1)) / D
    reco = torch.clamp_min(reco, 0.0)
    return trav, confidence_inference(cg_cfg, cg_state, reco).reshape(B, out_h, out_w)


@torch.no_grad()
def pixelwise_map_rows_chunked(score_fn, feat: torch.Tensor, out_h: int, out_w: int, target_rows: int = 32):
    """Apply a per-row scorer ((N, D) rows -> tuple of (N,) tensors) to
    every pixel of the bilinearly upsampled feature map, one band of
    output rows at a time, so the (D, out_h, out_w) map never exists.
    feat: (1, D, Hp, Wp). Returns the tuple with each entry (out_h, out_w)."""
    B, D, Hp, Wp = feat.shape
    if B != 1:
        raise ValueError(f"pixelwise_map_rows_chunked scores one image (got batch {B})")
    Mh = bilinear_matrix(out_h, Hp, feat.device, feat.dtype)
    Mw = bilinear_matrix(out_w, Wp, feat.device, feat.dtype)
    x = feat[0]
    bands = []
    for r0 in range(0, out_h, max(1, target_rows)):
        band = torch.einsum("rh,dhw->drw", Mh[r0 : r0 + target_rows], x)
        band = torch.einsum("pw,drw->rpd", Mw, band)
        bands.append(score_fn(band.reshape(-1, D)))
    return tuple(torch.cat([b[i] for b in bands]).reshape(out_h, out_w) for i in range(len(bands[0])))
