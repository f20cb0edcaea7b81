"""The plain reference's library: what the pipelines share of one camera
frame, and one supervision flush and one train step of the online loop, in
plain PyTorch. A configuration's whole frame (its backbone, segments and
scoring) is its pipeline's `frame` (`pipelines/<name>.py`), built from these.

It imports torch and numpy only, nothing of the program. Its functions
follow the port's plain versions (frozen copies of their arithmetic) and
the published descriptions: SLIC as a dense k-means over (L, a, b, y·ws,
x·ws) with SLIC's 2S window, the SimpleMLP head with its reconstruction
confidence, the pinhole projection of the robot's footprint, its convex
hull filled by half-plane tests, the pessimistic (minimum) fusion of
supervision masks, the confidence-weighted traversability loss and Adam.

Precision: `Prec(low=False)` computes in float32 throughout (the caller
turns TF32 off). `Prec(low=True)` is the control: each step one precision
below what the configuration states, the step that would tempt a faster
program: every tensor the configuration holds in bfloat16 (the ViT's
weights, its token stream, the operands and results of its products) in
fp8 e4m3 with a scale per tensor; matrix products the configuration
states in float32 on TF32 operands (10-bit mantissas, emulated by
rounding); and the float32 arithmetic outside matrix products (SLIC's
distances, the footprint's projection, the masked means) on bfloat16
operands.
"""

from __future__ import annotations

import math

import numpy as np
import torch

BIG = 1e30
EPS_HULL = 1e-6


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10-bit mantissa (round to nearest even)."""
    i = x.float().contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & -0x2000
    return i.view(torch.float32)


class Prec:
    def __init__(self, low: bool = False):
        self.low = low

    def r(self, x: torch.Tensor) -> torch.Tensor:
        """An operand of a float32 product (rounded straight through, so
        gradients pass)."""
        x = x.float()
        return x + (tf32(x) - x).detach() if self.low else x

    def e(self, x: torch.Tensor) -> torch.Tensor:
        """An operand of float32 arithmetic outside a matrix product."""
        return x.to(torch.bfloat16).float() if self.low else x.float()

    def a(self, x: torch.Tensor) -> torch.Tensor:
        """A tensor the configuration holds in bfloat16."""
        if not self.low:
            return x.float()
        s = torch.clamp(x.float().abs().amax() / 448.0, min=1e-30)
        return (x.float() / s).to(torch.float8_e4m3fn).float() * s

    def vit_linear(self, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """The ViT's qkv, proj, fc1 and fc2 (bfloat16 in the configuration)."""
        return self.a(self.a(x) @ self.a(w).T + b.float())


# ------------------------------------------------------------------ image
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def to_unit(img: torch.Tensor) -> torch.Tensor:
    """uint8 (..., 3, H, W) -> float32 in [0, 1], as the frame converts it."""
    return img.float() / 255.0 if img.dtype == torch.uint8 else img.float()


def resize_square(img: torch.Tensor, size: int) -> torch.Tensor:
    """Nearest resize of the smaller edge to `size`, then a centre crop."""
    h, w = img.shape[-2], img.shape[-1]
    nh, nw = (size, max(1, int(size * w / h))) if h <= w else (max(1, int(size * h / w)), size)

    def idx(n_out, n_in):
        i = torch.floor(torch.arange(n_out, dtype=torch.float32, device=img.device) * np.float32(n_in / n_out))
        return i.to(torch.int64).clamp(0, n_in - 1)

    img = img[..., idx(nh, h), :][..., idx(nw, w)]
    top, left = (nh - size) // 2, (nw - size) // 2
    return img[..., top:top + size, left:left + size]


def normalize(img: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(IMAGENET_MEAN, device=img.device).reshape(3, 1, 1)
    std = torch.tensor(IMAGENET_STD, device=img.device).reshape(3, 1, 1)
    return (img - mean) / std


def bilinear_matrix(n_out: int, n_in: int, device) -> torch.Tensor:
    """(n_out, n_in) align_corners=True two-tap interpolation matrix."""
    M = np.zeros((n_out, n_in), np.float32)
    if n_out == 1:
        M[0, 0] = 1.0
    else:
        f = np.arange(n_out, dtype=np.float64) * ((n_in - 1) / (n_out - 1))
        i0 = np.clip(np.floor(f).astype(int), 0, n_in - 1)
        i1 = np.clip(i0 + 1, 0, n_in - 1)
        wgt = (f - i0).astype(np.float32)
        M[np.arange(n_out), i0] += 1.0 - wgt
        M[np.arange(n_out), i1] += wgt
    return torch.as_tensor(M, device=device)


def upsample(x: torch.Tensor, h: int, w: int, p: Prec) -> torch.Tensor:
    """Bilinear (align_corners) resize of (..., Hp, Wp) to (..., h, w)."""
    Mh = bilinear_matrix(h, x.shape[-2], x.device)
    Mw = bilinear_matrix(w, x.shape[-1], x.device)
    out = torch.einsum("oh,...hw->...ow", p.r(Mh), p.r(x))
    return torch.einsum("pw,...ow->...op", p.r(Mw), p.r(out))


# -------------------------------------------------------------------- ViT
def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    return torch.nn.functional.layer_norm(x.float(), (x.shape[-1],), w.float(), b.float(), eps)


# ------------------------------------------------------------------- SLIC
def rgb_to_lab(rgb: torch.Tensor) -> torch.Tensor:
    """sRGB in [0, 1] (3, H, W) -> CIELAB (3, H, W)."""
    r, g, b = rgb.unbind(-3)

    def inv_gamma(c):
        return torch.where(c > 0.04045, ((c + 0.055) / 1.055) ** 2.4, c / 12.92)

    r, g, b = inv_gamma(r), inv_gamma(g), inv_gamma(b)
    x = 0.4124564 * r + 0.3575761 * g + 0.1804375 * b
    y = 0.2126729 * r + 0.7151522 * g + 0.0721750 * b
    z = 0.0193339 * r + 0.1191920 * g + 0.9503041 * b

    def f(t):
        return torch.where(t > (6 / 29) ** 3, torch.pow(t, 1.0 / 3.0), t / (3 * (6 / 29) ** 2) + 4 / 29)

    fx, fy, fz = f(x / 0.95047), f(y / 1.0), f(z / 1.08883)
    return torch.stack([116 * fy - 16, 500 * (fx - fy), 200 * (fy - fz)], dim=-3)


def _sum(terms):
    out = terms[0]
    for t in terms[1:]:
        out = out + t
    return out


def _assign(feats, centers, width, ws, win2, p: Prec):
    """Nearest centre within the 2S window (orphans: the spatially nearest
    centre), first index on ties: feats (5, HW), centers (K, 5) -> (HW,)."""
    HW = feats.shape[1]
    f = [p.e(feats[i])[:, None] for i in range(5)]
    c = [p.e(centers[:, i])[None, :] for i in range(5)]
    d2 = _sum([fi * fi for fi in f]) - 2.0 * _sum([fi * ci for fi, ci in zip(f, c)]) + _sum([ci * ci for ci in c])
    ws_t = torch.tensor(ws, dtype=torch.float32, device=feats.device)
    cy, cx = c[3] / ws_t, c[4] / ws_t
    pix = torch.arange(HW, device=feats.device)
    py = torch.div(pix, width, rounding_mode="floor").float()[:, None]
    px = (pix % width).float()[:, None]
    d2s = (py * py + px * px) - 2.0 * (py * cy + px * cx) + (cy * cy + cx * cx)
    best = torch.argmin(torch.where(d2s <= win2, d2, BIG), dim=1)
    min_s, best_s = torch.min(d2s, dim=1)
    return torch.where(min_s > win2, best_s, best)


def slic(img: torch.Tensor, K: int, compactness: float, iterations: int, p: Prec) -> torch.Tensor:
    """(3, H, W) in [0, 1] -> (H, W) int32 superpixel ids from grid-placed centres."""
    _, H, W = img.shape
    S = (H * W / K) ** 0.5
    ws, win2 = float(np.float32(compactness / S)), float(np.float32((2.0 * S) ** 2))
    ky = max(1, round(math.sqrt(K * H / W)))
    kx = max(1, math.ceil(K / ky))
    ys = (torch.arange(ky, dtype=torch.float32) + 0.5) * (H / ky)
    xs = (torch.arange(kx, dtype=torch.float32) + 0.5) * (W / kx)
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    yx = torch.stack([yy.reshape(-1), xx.reshape(-1)], dim=-1)[:K]
    if yx.shape[0] < K:
        yx = torch.cat([yx, yx[-1:].expand(K - yx.shape[0], 2)])
    init = (yx[:, 0].to(torch.int64) * W + yx[:, 1].to(torch.int64)).clamp(0, H * W - 1).to(img.device)
    lab = rgb_to_lab(img)
    gy = torch.arange(H, dtype=torch.float32, device=img.device)[:, None].expand(H, W)
    gx = torch.arange(W, dtype=torch.float32, device=img.device)[None, :].expand(H, W)
    feats = torch.cat([lab.reshape(3, H * W), torch.stack([gy * ws, gx * ws]).reshape(2, H * W)]).contiguous()
    centers = feats[:, init].T.contiguous()
    for _ in range(iterations):
        ids = _assign(feats, centers, W, ws, win2, p)
        onehot = (ids[:, None] == torch.arange(K, device=img.device)[None, :]).float()
        sums = onehot.T @ p.r(feats).T
        counts = onehot.sum(0)[:, None]
        centers = torch.where(counts > 0, sums / counts.clamp_min(1.0), centers)
    return _assign(feats, centers, W, ws, win2, p).reshape(H, W).to(torch.int32)


def grid_segments(H: int, W: int, cell: int, device) -> torch.Tensor:
    ys = torch.arange(H, device=device) // cell
    xs = torch.arange(W, device=device) // cell
    return (ys[:, None] * (-(-W // cell)) + xs[None, :]).to(torch.int32)


# ---------------------------------------------------------- pooling, head
def _one_hot(ids: torch.Tensor, S: int) -> torch.Tensor:
    return (ids[..., None] == torch.arange(S, device=ids.device)).float()


def pool_upsampled(feat: torch.Tensor, seg: torch.Tensor, S: int, p: Prec):
    """Per-segment means of the bilinearly upsampled (D, Hp, Wp) features
    over an (H, W) segmentation: ((S, D), (S,) counts)."""
    D, Hp, Wp = feat.shape
    H, W = seg.shape
    onehot = _one_hot(seg.long(), S)
    t = torch.einsum("hws,hp->pws", onehot, p.r(bilinear_matrix(H, Hp, feat.device)))
    A = torch.einsum("pws,wq->spq", p.r(t), p.r(bilinear_matrix(W, Wp, feat.device)))
    sums = torch.einsum("spq,dpq->sd", p.r(A), p.r(feat))
    counts = onehot.sum((0, 1))
    return sums / counts.clamp_min(1.0)[:, None], counts


def pool_patches(feat: torch.Tensor, seg_p: torch.Tensor, S: int, p: Prec):
    """Per-segment means of (D, Hp, Wp) features over a (Hp, Wp) segmentation."""
    D = feat.shape[0]
    onehot = _one_hot(seg_p.reshape(-1).long(), S)
    sums = onehot.T @ p.r(feat.reshape(D, -1).T)
    counts = onehot.sum(0)
    return sums / counts.clamp_min(1.0)[:, None], counts


def head_forward(head: dict, x: torch.Tensor, p: Prec) -> torch.Tensor:
    """SimpleMLP: Linear + ReLU layers, the last emitting [sigmoid(trav) || reconstruction]."""
    n = len([k for k in head if k.endswith(".weight")])
    h = x.float()
    for i in range(n):
        h = p.r(h) @ p.r(head[f"layers.{i}.weight"]).T + head[f"layers.{i}.bias"].float()
        if i < n - 1:
            h = torch.relu(h)
    return torch.cat([torch.sigmoid(h[..., :1]), h[..., 1:]], dim=-1)


def confidence_init(device) -> tuple:
    """(mean, std) of the confidence state before the first train step."""
    return torch.zeros((), device=device), torch.ones((), device=device)


def confidence_inference(mean, std, std_factor: float, x: torch.Tensor) -> torch.Tensor:
    """Reconstruction loss -> confidence: 1 at or below mean + (factor - 1)·std, 0 from mean + (factor + 1)·std."""
    shifted = mean + std * std_factor
    lo = torch.clamp_min(shifted - std, 0.0)
    hi = shifted + std
    xc = torch.minimum(torch.maximum(x, lo), hi)
    return 1.0 - (xc - lo) / torch.clamp_min(hi - lo, 1e-12)


def score_rows(head: dict, rows: torch.Tensor, mean, std, std_factor: float, p: Prec):
    out = head_forward(head, rows, p)
    reco = torch.mean((out[:, 1:] - rows.float()) ** 2, dim=-1)
    return out[:, 0], confidence_inference(mean, std, std_factor, reco)


# ---------------------------------------------------------------- flush
def _se3_inverse(T):
    Rt = T[..., :3, :3].transpose(-1, -2)
    out = torch.zeros_like(T)
    out[..., :3, :3] = Rt
    out[..., :3, 3] = -(Rt * T[..., None, :3, 3]).sum(-1)
    out[..., 3, 3] = 1.0
    return out


def project(K, pose_cam_in_world, pts_world, p: Prec):
    """World points (B, N, 3) -> pixel (x, y) (B, N, 2) and in-front flags (B, N)."""
    Ti = _se3_inverse(p.e(pose_cam_in_world))
    R, t = Ti[..., :3, :3], Ti[..., :3, 3]
    pc = p.e((R[:, None] * p.e(pts_world)[:, :, None, :]).sum(-1) + t[:, None])
    z = pc[..., 2]
    zs = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    uvw = (p.e(K)[:, None] * pc[..., None, :]).sum(-1)
    return p.e(uvw[..., :2] / zs[..., None]), z >= 0


def convex_hull(points: torch.Tensor, valid: torch.Tensor, max_hull: int = 32):
    """Gift wrap from the lowest-y (then lowest-x) point, a fixed number of
    steps, ties to the first index: (B, N, 2), (B, N) -> (B, max_hull, 2), (B, max_hull)."""
    pts = points.float()
    B, N, _ = pts.shape
    valid = valid & torch.isfinite(pts).all(-1)
    rows = torch.arange(B, device=pts.device)
    nv = valid.sum(-1)
    safe = torch.where(valid[..., None], pts, BIG)
    start_idx = torch.argmin(safe[..., 1] * 1e6 + safe[..., 0], dim=-1)
    start = pts[rows, start_idx]
    cur_idx, cur, done = start_idx, start, nv < 3
    verts, vvalid = [], []
    for _ in range(max_hull - 1):
        d = pts - cur[:, None, :]
        dist = torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])
        cand = valid & (dist > EPS_HULL)
        C = d[:, :, None, 0] * d[:, None, :, 1] - d[:, :, None, 1] * d[:, None, :, 0]
        min_cross = torch.where(cand[:, None, :], C, BIG).amin(-1)
        is_dir = cand & (min_cross >= -EPS_HULL * (1.0 + dist * dist))
        nxt_idx = torch.argmax(torch.where(is_dir, dist, -1.0), dim=-1)
        anyc = is_dir.any(-1)
        nxt_idx = torch.where(anyc, nxt_idx, cur_idx)
        nxt = pts[rows, nxt_idx]
        closed = (nxt_idx == start_idx) | ~anyc
        verts.append(torch.where(done[:, None], start, nxt))
        vvalid.append(~done & ~closed)
        cur_idx = nxt_idx
        cur = torch.where(done[:, None], cur, nxt)
        done = done | closed
    hull = torch.cat([start[:, None], torch.stack(verts, 1)], dim=1)
    hv = torch.cat([(nv >= 3)[:, None], torch.stack(vvalid, 1)], dim=1)
    return torch.where(hv[..., None], hull, start[:, None]), hv


def fill_hulls(hull: torch.Tensor, hv: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Pixels (x, y) at integer coordinates inside every edge's half plane,
    a·x + b·y + c >= -1e-6 for a = -(v1y - v0y), b = v1x - v0x, c = (v1y -
    v0y)·v0x - (v1x - v0x)·v0y; nothing for a hull of fewer than 3 vertices."""
    v0 = hull.float()
    v1 = torch.roll(v0, -1, dims=1)
    ex, ey = v1[..., 0] - v0[..., 0], v1[..., 1] - v0[..., 1]
    a, b, c = -ey, ex, ey * v0[..., 0] - ex * v0[..., 1]
    ys = torch.arange(H, dtype=torch.float32, device=hull.device)[:, None]
    xs = torch.arange(W, dtype=torch.float32, device=hull.device)[None, :]
    acc = torch.full((hull.shape[0], H, W), BIG, dtype=torch.float32, device=hull.device)
    for e in range(hull.shape[1]):
        acc = torch.minimum(acc, a[:, e, None, None] * xs + b[:, e, None, None] * ys + c[:, e, None, None])
    return (acc >= -EPS_HULL) & (hv.sum(1) >= 3)[:, None, None]


def segment_masked_mean(values, valid, seg, S: int, p: Prec = Prec()):
    """Per-segment mean of the valid pixels (0 where none) and `mean > 0`."""
    B = values.shape[0]
    v = p.e(torch.where(valid, values, 0.0)).reshape(B, -1).double()
    m = valid.reshape(B, -1).double()
    ids = seg.reshape(B, -1).long()
    sums = torch.stack([torch.bincount(ids[b], weights=v[b], minlength=S)[:S] for b in range(B)])
    counts = torch.stack([torch.bincount(ids[b], weights=m[b], minlength=S)[:S] for b in range(B)])
    mean = torch.where(counts > 0, sums / counts.clamp_min(1.0), 0.0).float()
    return mean, mean > 0


def flush(mask_before, K, pose_cam_in_world, seg, footprint, trav: float, S: int, H: int, W: int, p: Prec):
    """One footprint update over the fan-out rows: the footprint's hull in
    each row's camera, fused by minimum into the row's mask (+inf unset),
    and the per-segment supervision signal."""
    B = mask_before.shape[0]
    pts = footprint.float()[None].expand(B, -1, 3)
    pts2d, in_front = project(K, pose_cam_in_world, pts, p)
    inside = fill_hulls(*convex_hull(pts2d, in_front), H, W)
    fused = torch.minimum(mask_before, torch.where(inside, torch.tensor(trav, device=inside.device), torch.inf))
    sig, sv = segment_masked_mean(fused, torch.isfinite(fused), seg, S, p)
    return {"mask": fused, "signal": sig, "signal_valid": sv}


# ------------------------------------------------------------ train step
def train_step(cfg: dict, params: dict, adam: dict, cg_mean, cg_std, rows: dict, p: Prec):
    """One step of the confidence-weighted loss and Adam on the rows of
    the sampled nodes. Returns the loss, each leaf's gradient and its
    change."""
    lc, ec = cfg["loss"], cfg["estimator"]
    D = rows["features"].shape[-1]
    x = rows["features"].reshape(-1, D).float()
    y = rows["signal"].reshape(-1).float()
    y_valid = rows["signal_valid"].reshape(-1)
    sample_valid = (rows["feat_valid"] & rows["valid"][:, None]).reshape(-1)
    with torch.enable_grad():
        return _train_step(cfg, params, adam, cg_mean, cg_std, x, y, y_valid, sample_valid, p)


def _train_step(cfg, params, adam, cg_mean, cg_std, x, y, y_valid, sample_valid, p: Prec):
    lc, ec = cfg["loss"], cfg["estimator"]
    leaves = {k: v.detach().float().clone().requires_grad_(True) for k, v in params.items()}
    res = head_forward(leaves, x, p)
    loss_reco = torch.mean((res[:, 1:] - x) ** 2, dim=-1)
    labeled = y_valid & sample_valid
    unlabeled = ~y_valid & sample_valid
    lr_ng = loss_reco.detach()
    m = labeled.float()
    n = m.sum()
    mean_p = (lr_ng * m).sum() / n.clamp_min(1.0)
    std_p = torch.sqrt((((lr_ng - mean_p) ** 2) * m).sum() / (n - 1.0).clamp_min(1.0))
    mean = torch.where(n > 0, mean_p, cg_mean)
    std = torch.where(n > 0, std_p, cg_std)
    conf = confidence_inference(mean, std, cfg["confidence"]["std_factor"], lr_ng)
    raw = (res[:, 0] - y) ** 2
    nv = sample_valid.float().sum().clamp_min(1.0)
    l_trav = (torch.where(labeled, raw, 0.0).sum() + torch.where(unlabeled, raw * (1.0 - conf), 0.0).sum()) / nv
    l_reco = (loss_reco * m).sum() / n.clamp_min(1.0)
    loss = lc["w_trav"] * l_trav + lc["w_reco"] * l_reco
    loss.backward()
    b1, b2, eps, lr = 0.9, 0.999, 1e-8, ec["lr"]
    grads, change = {}, {}
    for k, leaf in leaves.items():
        g = leaf.grad.detach()
        m1, v1, step = adam[k]
        t = step + 1
        m1 = b1 * m1 + (1 - b1) * g
        v1 = b2 * v1 + (1 - b2) * g * g
        upd = (lr / (1 - b1**t)) * m1 / (torch.sqrt(v1) / math.sqrt(1 - b2**t) + eps)
        grads[k], change[k] = g, -upd
    return {"loss": loss.detach(), "grads": grads, "change": change, "cg_mean": mean, "cg_std": std}
