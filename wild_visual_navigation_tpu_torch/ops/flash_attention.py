"""Flash attention (forward) — kernel K1 and its plain version.

`flash_attention` launches csrc/flash_attention.cu for CUDA tensors and
uses `xla_attention`, the plain einsum form, for CPU tensors. Layout is
the JAX package's (B, H, S, D); output is in q.dtype.
"""

from __future__ import annotations

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
    _cuda.require_cuda("flash_attention", q, k, v)
    out = torch.empty_like(q)
    lib = _cuda.library()
    with torch.cuda.device(q.device):
        err = lib.wvn_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B * H, S, D, _DTYPES[q.dtype], float(sm_scale), _cuda.stream_of(q),
        )
    _cuda.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
