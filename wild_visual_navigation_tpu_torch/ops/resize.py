"""Image resize / crop / feature-interpolation primitives.

Port of wild_visual_navigation_tpu/ops/resize.py: torchvision's
`Resize(size, NEAREST) + CenterCrop(size)` and
`F.interpolate(mode="bilinear", align_corners=True)` semantics on NCHW
tensors, with the numpy interpolation matrices the per-pixel scorer
shares.
"""

from __future__ import annotations

import numpy as np
import torch


def _nearest_indices(out_size: int, in_size: int, device=None) -> torch.Tensor:
    # F.interpolate(mode="nearest") mapping: floor(i * in / out), computed
    # in float32 as the reference does
    idx = torch.floor(torch.arange(out_size, dtype=torch.float32, device=device) * np.float32(in_size / out_size))
    return idx.to(torch.int64).clamp(0, in_size - 1)


def resize_nearest(img: torch.Tensor, new_h: int, new_w: int) -> torch.Tensor:
    """Nearest-neighbour resize of (..., H, W) to (..., new_h, new_w)."""
    h, w = img.shape[-2], img.shape[-1]
    iy = _nearest_indices(new_h, h, img.device)
    ix = _nearest_indices(new_w, w, img.device)
    return img[..., iy, :][..., ix]


def resize_smaller_edge_nearest(img: torch.Tensor, size: int) -> torch.Tensor:
    """torchvision `Resize(size)`: scale the smaller edge to `size`; the
    long edge truncates like torchvision's `int(size * long / short)`."""
    h, w = img.shape[-2], img.shape[-1]
    if h <= w:
        new_h, new_w = size, max(1, int(size * w / h))
    else:
        new_h, new_w = max(1, int(size * h / w)), size
    return resize_nearest(img, new_h, new_w)


def center_crop(img: torch.Tensor, crop_h: int, crop_w: int | None = None) -> torch.Tensor:
    """torchvision `CenterCrop` on (..., H, W); zero-pads a crop larger
    than the input."""
    if crop_w is None:
        crop_w = crop_h
    h, w = img.shape[-2], img.shape[-1]
    pad_h, pad_w = max(0, crop_h - h), max(0, crop_w - w)
    if pad_h or pad_w:
        img = torch.nn.functional.pad(img, (pad_w // 2, pad_w - pad_w // 2, pad_h // 2, pad_h - pad_h // 2))
        h, w = img.shape[-2], img.shape[-1]
    top = (h - crop_h) // 2
    left = (w - crop_w) // 2
    return img[..., top : top + crop_h, left : left + crop_w]


def resize_image(img: torch.Tensor, new_h: int, new_w: int | None = None) -> torch.Tensor:
    """Square target: aspect-preserving resize + centre crop; otherwise
    a direct (new_h, new_w) nearest resize."""
    if new_w is None or new_w == new_h:
        return center_crop(resize_smaller_edge_nearest(img, new_h), new_h)
    return resize_nearest(img, new_h, new_w)


def interpolate_bilinear(x: torch.Tensor, new_h: int, new_w: int) -> torch.Tensor:
    """Bilinear resize with align_corners=True on (..., H, W), in the
    reference's gather-and-lerp form."""
    h, w = x.shape[-2], x.shape[-1]

    def coords(out, inp):
        if out == 1:
            return torch.zeros(1, dtype=torch.float32, device=x.device)
        return torch.arange(out, dtype=torch.float32, device=x.device) * np.float32((inp - 1) / (out - 1))

    fy, fx = coords(new_h, h), coords(new_w, w)
    y0 = torch.floor(fy).to(torch.int64).clamp(0, h - 1)
    x0 = torch.floor(fx).to(torch.int64).clamp(0, w - 1)
    y1 = (y0 + 1).clamp(0, h - 1)
    x1 = (x0 + 1).clamp(0, w - 1)
    wy = (fy - y0.float())[:, None]
    wx = (fx - x0.float())[None, :]
    a = x[..., y0, :][..., x0]
    b = x[..., y0, :][..., x1]
    c = x[..., y1, :][..., x0]
    d = x[..., y1, :][..., x1]
    top = a * (1 - wx) + b * wx
    bot = c * (1 - wx) + d * wx
    return top * (1 - wy) + bot * wy


def _bilinear_matrix_np(out_size: int, in_size: int) -> np.ndarray:
    """(out, in) align_corners=True two-tap interpolation matrix."""
    M = np.zeros((out_size, in_size), np.float32)
    if out_size == 1:
        M[0, 0] = 1.0
        return M
    f = np.arange(out_size, dtype=np.float64) * ((in_size - 1) / (out_size - 1))
    i0 = np.clip(np.floor(f).astype(int), 0, in_size - 1)
    i1 = np.clip(i0 + 1, 0, in_size - 1)
    w = (f - i0).astype(np.float32)
    rows = np.arange(out_size)
    M[rows, i0] += 1.0 - w
    M[rows, i1] += w
    return M


def _bilinear_pair_matrices_np(out_size: int, in_size: int):
    """Mq = M ⊙ M (out, in) and the adjacent-tap products
    Mx[o, i] = M[o, i] · M[o, i+1] (out, in-1), for interpolating
    squared-norm maps."""
    M = _bilinear_matrix_np(out_size, in_size)
    Mq = M * M
    Mx = M[:, :-1] * M[:, 1:] if in_size > 1 else np.zeros((out_size, 0), M.dtype)
    return Mq, Mx


def bilinear_matrix(out_size: int, in_size: int, device=None, dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(_bilinear_matrix_np(out_size, in_size), dtype=dtype, device=device)


PRECISIONS = (None, "default", "high", "highest")  # the reference's `precision=` names (jax.lax.Precision)


def interpolate_bilinear_mxu(x: torch.Tensor, new_h: int, new_w: int) -> torch.Tensor:
    """interpolate_bilinear as two constant-matrix products (the
    reference's `interpolate_bilinear_mxu`), in x.dtype, each product
    rounded to it."""
    h, w = x.shape[-2], x.shape[-1]
    Mh = bilinear_matrix(new_h, h, x.device, x.dtype)
    Mw = bilinear_matrix(new_w, w, x.device, x.dtype)
    out = torch.einsum("oh,...hw->...ow", Mh, x)
    return torch.einsum("pw,...ow->...op", Mw, out)


def interpolate_bilinear_mxu_nhwc(x: torch.Tensor, new_h: int, new_w: int, precision=None) -> torch.Tensor:
    """interpolate_bilinear_mxu on channels-last input: (B, h, w, C) ->
    (B, new_h, new_w, C), the same two products in x.dtype, each rounded
    to it (the reference's form of the same name).

    `precision` takes the reference's values, a name of PRECISIONS or a
    jax.lax.Precision member, which picks how many bf16 passes the TPU's
    matrix unit takes for an fp32 product. It changes nothing here: PyTorch
    computes fp32 products in fp32 on the CPU, and on the card with TF32
    off, PyTorch's default, which the port never changes."""
    name = getattr(precision, "name", precision)  # a jax.lax.Precision member, by its name
    if (name.lower() if isinstance(name, str) else name) not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS} or a jax.lax.Precision, got {precision!r}")
    h, w = x.shape[-3], x.shape[-2]
    Mh = bilinear_matrix(new_h, h, x.device, x.dtype)
    Mw = bilinear_matrix(new_w, w, x.device, x.dtype)
    out = torch.einsum("oh,bhwc->bowc", Mh, x)
    return torch.einsum("pw,bowc->bopc", Mw, out)


def interpolate_bilinear_mxu_precise(x: torch.Tensor, new_h: int, new_w: int) -> torch.Tensor:
    """interpolate_bilinear_mxu of x in fp32, for the terms of the Gram
    scorer that cancel (the reference's form, at its "highest" precision)."""
    return interpolate_bilinear_mxu(x.float(), new_h, new_w)


def interpolate_norm_sq_mxu(x: torch.Tensor, new_h: int, new_w: int) -> torch.Tensor:
    """Σ_d interpolate_bilinear(x)² over channels without the upsampled
    map: x (B, D, H, W) -> (B, new_h, new_w), from the five
    patch-resolution Gram maps and the pair-product matrices, in fp32."""
    xf = x.float()
    g00 = torch.einsum("bdhw,bdhw->bhw", xf, xf)
    g01 = torch.einsum("bdhw,bdhw->bhw", xf[..., :-1], xf[..., 1:])
    g10 = torch.einsum("bdhw,bdhw->bhw", xf[:, :, :-1], xf[:, :, 1:])
    g11 = torch.einsum("bdhw,bdhw->bhw", xf[:, :, :-1, :-1], xf[:, :, 1:, 1:])
    g1m1 = torch.einsum("bdhw,bdhw->bhw", xf[:, :, 1:, :-1], xf[:, :, :-1, 1:])
    h, w = x.shape[-2], x.shape[-1]
    Aq, Ax = (torch.as_tensor(m, device=x.device) for m in _bilinear_pair_matrices_np(new_h, h))
    Bq, Bx = (torch.as_tensor(m, device=x.device) for m in _bilinear_pair_matrices_np(new_w, w))

    def sep(m, Mh, Mw):
        return torch.einsum("pw,bow->bop", Mw, torch.einsum("oh,bhw->bow", Mh, m))

    out = sep(g00, Aq, Bq)
    if w > 1:
        out = out + 2.0 * sep(g01, Aq, Bx)
    if h > 1:
        out = out + 2.0 * sep(g10, Ax, Bq)
    if h > 1 and w > 1:
        out = out + 2.0 * sep(g11 + g1m1, Ax, Bx)
    return out


IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


_IMAGENET_CONSTANTS: dict = {}  # (device, dtype) -> (mean, std), each (3, 1, 1)


def imagenet_constants(device, dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """The ImageNet mean and std as (3, 1, 1) tensors of `dtype` on
    `device`, built once per (device, dtype) and kept there: on the card a
    host-to-device copy waits for the stream, and a CUDA graph's capture
    takes none."""
    key = (torch.device(device), dtype)
    hit = _IMAGENET_CONSTANTS.get(key)
    if hit is None:
        hit = _IMAGENET_CONSTANTS.setdefault(key, tuple(
            torch.tensor(c, dtype=dtype, device=key[0]).reshape(3, 1, 1) for c in (IMAGENET_MEAN, IMAGENET_STD)))
    return hit


def imagenet_normalize(img: torch.Tensor) -> torch.Tensor:
    """Channel-wise ImageNet normalisation of (..., 3, H, W) in [0, 1]."""
    mean, std = imagenet_constants(img.device, img.dtype)
    return (img - mean) / std
