"""Flash attention (forward) — kernel K1 and its plain version.

`flash_attention` launches csrc/flash_attention.cu for CUDA tensors and
uses `xla_attention`, the plain einsum form, for CPU tensors. Layout is
the JAX package's (B, H, S, D); output is in q.dtype.

On the card q, k and v may be strided views (a contiguous D axis, any
strides for B, H and S, e.g. the slices of a (B, S, 3, H, D) qkv product),
and the output is a (B, H, S, D) view of a (B, S, H, D) buffer, so
`out.transpose(1, 2)` is contiguous. bf16 runs on the tensor cores
(wgmma, TMA loads), fp32 on the SIMT pipes.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sm_scale: float = 1.0) -> torch.Tensor:
    """softmax(q kᵀ · sm_scale) v with fp32 scores and fp32 accumulation,
    p rounded to v.dtype before the second product (the reference's
    `xla_attention`). Output in q.dtype."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def bf16_atol(ref: torch.Tensor) -> float:
    """The absolute error that K1's bf16 output is held to against
    `xla_attention` on the same inputs: 2**-6 of the output's largest
    |value|, 2 to 4 bf16 units in the last place of the largest outputs.
    Both sides round p and the output to bf16, so they may differ there by
    one or two units. Leaving out the last kv tile moves some output by 7
    to 40 times this at the ViT shapes (tests/test_torch_port_attention_vit.py)."""
    return float(ref.float().abs().max()) * 2.0**-6


def _outer_strides(name: str, t: torch.Tensor) -> list[int]:
    """The (B, H, S) strides of t in elements, checked for the kernel: a
    contiguous last axis and, as TMA needs, 16-byte aligned base and
    strides. An axis of size 1 is never stepped, so it gets the tensor's
    extent as a harmless stride."""
    if t.stride(-1) != 1:
        raise ValueError(f"{name}: the head axis must be contiguous, got strides {t.stride()}")
    per16 = 16 // t.element_size()
    extent = max(s * n for s, n in zip(t.stride(), t.shape))
    extent = -(-max(extent, 1) // per16) * per16
    strides = [s if n > 1 else extent for s, n in zip(t.stride()[:3], t.shape[:3])]
    if t.data_ptr() % 16 or any(s % per16 for s in strides):
        raise ValueError(f"{name}: base and (B, H, S) strides must be 16-byte aligned, got strides {t.stride()}")
    return strides


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sm_scale: float = 1.0) -> torch.Tensor:
    """softmax(q kᵀ · sm_scale) v. q, k, v: (B, H, S, D).

    CUDA tensors run kernel K1 (D = 64, bf16 or fp32) or raise; CPU
    tensors take the plain version."""
    if q.device.type == "cpu":
        return xla_attention(q, k, v, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"flash_attention: q, k, v must share one (B, H, S, D) shape, got {q.shape}, {k.shape}, {v.shape}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: dtype must be float32 or bfloat16 for all of q, k, v, got {q.dtype}")
    B, H, S, D = q.shape
    if D != 64:
        raise ValueError(f"flash_attention: the kernel takes head dim 64, got {D}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention: q, k, v on different devices: {q.device}, {k.device}, {v.device}")
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, out) for s in _outer_strides("flash_attention", t)))
    lib = _cuda.library()
    with torch.cuda.device(q.device):
        err = lib.wvn_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), ctypes.addressof(strides),
            B, H, S, D, _DTYPES[q.dtype], float(sm_scale), _cuda.stream_of(q),
        )
    _cuda.check(err, "flash_attention")
    _cuda.count_launch(flash_attention)
    return out


flash_attention.launches = 0
