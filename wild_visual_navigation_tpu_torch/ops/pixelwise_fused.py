"""Fused per-pixel traversability scoring — kernel K2 and its plain version.

Port of wild_visual_navigation_tpu/ops/pixelwise_fused.py. The torch
precompute (`fused_precompute`) runs every D-channel contraction at
patch-row resolution, in fp32 (TF32 must be off: the Gram form cancels
large terms), and upsamples along W. `score_pixels` then scores every
output pixel — the 2-tap H lerp, both MLP layers after the first, the
sigmoid and the Gram-form reconstruction MSE — and writes only the two
(B, H, W) maps: K2 (csrc/pixelwise_score.cu) for CUDA tensors, the plain
version for CPU tensors.

Layout is channels-last, so one pixel's K1 hidden values are contiguous:
  hw    (B, Hp, W, K1)  bf16   upsample_W(Dense_0 feat), bf16 products
  zsts  (B, Hp, W, K+3) fp32   [upsample_W(Wr feat) | upsample_W(br·feat) | t0 | t1]
where t0 / t1 are the W-contracted Gram maps of |upsample(feat)|²
(ops/resize.py::interpolate_norm_sq_mxu).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils.devices import resident
from . import _cuda
from .resize import _bilinear_matrix_np, _bilinear_pair_matrices_np, bilinear_matrix, bilinear_pair_matrices


def _row_tables(out_size: int, in_size: int):
    """Per-output-row tables for the 2-tap H-axis combine.

    Returns (starts, coef) with starts[y] = the first of the two input
    rows (clamped so start+1 is always in range) and coef[y] =
    [c0, c1, q0, q1, x0, 0, 0, 0]:
      value   = c0*row[start] + c1*row[start+1]
      normsq  = q0*t0[start] + q1*t0[start+1] + x0*t1[start]
    Merged-tap boundary rows (both taps on the last input row) collapse
    correctly because the weights come from `_bilinear_matrix_np`.
    """
    M = _bilinear_matrix_np(out_size, in_size)
    Aq, Ax = _bilinear_pair_matrices_np(out_size, in_size)
    Axp = np.zeros((out_size, in_size), np.float32)
    Axp[:, : max(in_size - 1, 0)] = Ax
    starts = np.minimum(np.argmax(M > 0, axis=1), in_size - 2).astype(np.int32)
    rows = np.arange(out_size)
    coef = np.zeros((out_size, 8), np.float32)
    coef[:, 0] = M[rows, starts]
    coef[:, 1] = M[rows, starts + 1]
    coef[:, 2] = Aq[rows, starts]
    coef[:, 3] = Aq[rows, starts + 1]
    coef[:, 4] = Axp[rows, starts]
    return starts, coef


MAX_RUN = 8  # output rows per K2 block: one per warp


def _row_runs(starts: np.ndarray) -> np.ndarray:
    """Boundaries (R + 1,) int32 of the runs of output rows that share one
    pair of patch rows (equal starts[y]), each cut to at most MAX_RUN rows:
    K2 gives each run (and a tile of columns) one block, which loads the
    two hw rows once for all of the run's rows."""
    bounds = [0]
    for y in range(1, len(starts)):
        if starts[y] != starts[bounds[-1]] or y - bounds[-1] == MAX_RUN:
            bounds.append(y)
    bounds.append(len(starts))
    return np.asarray(bounds, np.int32)


def _row_operands(out_size: int, in_size: int, device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(starts, coef, runs) on `device`: they depend on the row counts
    alone, so each shape builds and copies them once (utils/devices.py::
    resident)."""
    dev = torch.device(device)

    def build():
        starts, coef = _row_tables(out_size, in_size)
        return tuple(torch.as_tensor(a, device=dev) for a in (starts, coef, _row_runs(starts)))

    return resident(("pixelwise_rows", dev, out_size, in_size), build)


def dense_layers(mlp) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """(kernel (in, out), bias) in fp32 for each Linear of a SimpleMLP."""
    return [(lin.weight.detach().float().T, lin.bias.detach().float()) for lin in mlp.layers]


def supports_fused(mlp, feat_shape, out_h: int, out_w: int) -> bool:
    """Structural test: a three-layer SimpleMLP stack and at least two
    patch rows and columns (2-tap slices) and output rows and columns."""
    B, D, Hp, Wp = feat_shape
    return len(getattr(mlp, "layers", ())) == 3 and min(Hp, Wp, out_h, out_w) >= 2


class FusedOperands(NamedTuple):
    starts: torch.Tensor  # (H,) int32
    coef: torch.Tensor  # (H, 8) fp32
    hw: torch.Tensor  # (B, Hp, W, K1) bf16
    zsts: torch.Tensor  # (B, Hp, W, K + 3) fp32
    w1t: torch.Tensor  # (K, K1) bf16
    b1: torch.Tensor  # (K,) fp32
    gt: torch.Tensor  # (1 + K, K) fp32: [w_trav ; Wr Wrᵀ]
    v: torch.Tensor  # (K,) fp32: Wr br
    consts: torch.Tensor  # (2,) fp32: [b_trav, br·br]
    runs: torch.Tensor  # (R + 1,) int32: row boundaries of the runs of equal starts (_row_runs)


@torch.no_grad()
def fused_precompute(mlp, feat: torch.Tensor, out_h: int, out_w: int) -> FusedOperands:
    """Every patch-row-resolution operand the scorer consumes."""
    B, D, Hp, Wp = feat.shape
    dev = feat.device
    (W0, b0), (W1, b1), (Wl, bl) = dense_layers(mlp)

    Mw = bilinear_matrix(out_w, Wp, dev)  # (W, Wp)
    Mq, Mx = bilinear_pair_matrices(out_w, Wp, dev)  # (W, Wp), (W, Wp - 1)

    # hw in bf16 products, as the reference computes it; the Gram-form
    # terms below stay fp32
    bf = torch.bfloat16
    hp = torch.einsum("bdhw,dk->bhwk", feat.to(bf), W0.to(bf)) + b0.to(bf)
    hw = torch.einsum("xj,bhjk->bhxk", Mw.to(bf), hp).contiguous()

    f32 = feat.float()

    Wr, br = Wl[:, 1:], bl[1:]  # (K, D), (D,)
    zw = torch.einsum("xj,bhjk->bhxk", Mw, torch.einsum("bdhw,kd->bhwk", f32, Wr))
    sw = torch.einsum("xj,bhj->bhx", Mw, torch.einsum("bdhw,d->bhw", f32, br))

    g00 = torch.einsum("bdhw,bdhw->bhw", f32, f32)
    g01 = torch.einsum("bdhw,bdhw->bhw", f32[..., :-1], f32[..., 1:])
    g10 = torch.einsum("bdhw,bdhw->bhw", f32[:, :, :-1], f32[:, :, 1:])
    g11 = torch.einsum("bdhw,bdhw->bhw", f32[:, :, :-1, :-1], f32[:, :, 1:, 1:])
    g1m1 = torch.einsum("bdhw,bdhw->bhw", f32[:, :, 1:, :-1], f32[:, :, :-1, 1:])
    t0 = torch.einsum("xj,bhj->bhx", Mq, g00) + 2.0 * torch.einsum("xj,bhj->bhx", Mx, g01)
    t1 = 2.0 * (torch.einsum("xj,bhj->bhx", Mq, g10) + torch.einsum("xj,bhj->bhx", Mx, g11 + g1m1))
    t1 = torch.nn.functional.pad(t1, (0, 0, 0, 1))  # Hp - 1 -> Hp rows
    zsts = torch.cat([zw, sw[..., None], t0[..., None], t1[..., None]], dim=-1).contiguous()

    starts, coef, runs = _row_operands(out_h, Hp, dev)
    M = Wr @ Wr.T
    return FusedOperands(
        starts=starts,
        coef=coef,
        hw=hw,
        zsts=zsts,
        w1t=W1.T.to(torch.bfloat16).contiguous(),
        b1=b1.contiguous(),
        gt=torch.cat([Wl[:, :1], M], dim=1).T.contiguous(),
        v=(Wr @ br).contiguous(),
        consts=torch.stack([bl[0], br @ br]).contiguous(),
        runs=runs,
    )


def score_pixels_plain(ops: FusedOperands, D: int):
    """Plain version of K2: the same math from the same operands (the H
    lerp of hw in bf16 arithmetic as the reference's kernel does it, fp32
    products after it) -> (trav, reco), each (B, H, W) fp32."""
    st = ops.starts.long()
    c = ops.coef[:, None, :]  # (H, 1, 8), broadcasts over (B, H, W)
    c0, c1, q0, q1, x0 = (c[..., i] for i in range(5))
    K = ops.w1t.shape[0]
    c0b, c1b = (ci[..., None].to(torch.bfloat16) for ci in (c0, c1))
    h = torch.relu(c0b * ops.hw[:, st] + c1b * ops.hw[:, st + 1]).float()
    x1 = torch.relu(h @ ops.w1t.float().T + ops.b1)  # (B, H, W, K)
    P = x1 @ ops.gt.T  # (B, H, W, 1 + K)
    zs0, zs1 = ops.zsts[:, st], ops.zsts[:, st + 1]
    z = c0[..., None] * zs0[..., :K] + c1[..., None] * zs1[..., :K]
    lin = P[..., 1:] + 2.0 * (ops.v - z)
    s = c0 * zs0[..., K] + c1 * zs1[..., K]
    nsq = q0 * zs0[..., K + 1] + q1 * zs1[..., K + 1] + x0 * zs0[..., K + 2]
    reco = ((x1 * lin).sum(-1) + ops.consts[1] - 2.0 * s + nsq) / D
    return torch.sigmoid(P[..., 0] + ops.consts[0]), torch.clamp_min(reco, 0.0)


def score_pixels(ops: FusedOperands, D: int):
    """K2 for CUDA operands, the plain version for CPU operands ->
    (trav, reco), each (B, H, W) fp32."""
    if ops.hw.device.type == "cpu":
        return score_pixels_plain(ops, D)
    if ops.hw.device.type != "cuda":
        raise ValueError(f"score_pixels: unsupported device {ops.hw.device}")
    B, Hp, W, K1 = ops.hw.shape
    H = ops.starts.shape[0]
    lib = _cuda.library()
    K = lib.wvn_pixelwise_hidden_width()
    if ops.w1t.shape != (K, K1) or ops.zsts.shape != (B, Hp, W, K + 3) or ops.gt.shape != (1 + K, K):
        raise ValueError(f"score_pixels: the kernel takes a [D -> K1 -> {K} -> 1 + D] head, got w1t {tuple(ops.w1t.shape)}")
    if K1 % 8 or K1 > 512 or Hp < 2:
        raise ValueError(f"score_pixels: the kernel takes K1 a multiple of 8 up to 512 and Hp >= 2, got {K1}, {Hp}")
    if ops.hw.dtype != torch.bfloat16 or ops.w1t.dtype != torch.bfloat16:
        raise ValueError("score_pixels: hw and w1t must be bfloat16")
    if ops.starts.dtype != torch.int32 or ops.runs.dtype != torch.int32 or ops.runs.ndim != 1:
        raise ValueError("score_pixels: starts and runs must be int32 vectors")
    if any(x.dtype != torch.float32 for x in (ops.zsts, ops.coef, ops.b1, ops.gt, ops.v, ops.consts)):
        raise ValueError("score_pixels: zsts, coef, b1, gt, v and consts must be float32")
    _cuda.require_cuda("score_pixels", *ops)
    trav = torch.empty((B, H, W), dtype=torch.float32, device=ops.hw.device)
    reco = torch.empty_like(trav)
    with torch.cuda.device(ops.hw.device):
        err = lib.wvn_pixelwise_score(
            *(x.data_ptr() for x in (ops.hw, ops.zsts, ops.starts, ops.runs, ops.coef, ops.w1t, ops.b1, ops.gt,
                                     ops.v, ops.consts, trav, reco)),
            B, Hp, H, W, K1, ops.runs.shape[0] - 1, float(D), _cuda.stream_of(ops.hw),
        )
    _cuda.check(err, "score_pixels")
    _cuda.count_launch(score_pixels)
    return trav, reco


score_pixels.launches = 0


def pixelwise_score_fused(mlp, feat: torch.Tensor, out_h: int, out_w: int):
    """feat (B, D, Hp, Wp) -> (trav, reco), each (B, out_h, out_w) fp32;
    reco is the reconstruction MSE before confidence calibration. The
    caller checks supports_fused() first."""
    return score_pixels(fused_precompute(mlp, feat, out_h, out_w), feat.shape[1])
