"""Flash attention (forward) — kernel K1 and its plain version.

`flash_attention` launches csrc/flash_attention.cu for CUDA tensors and
uses `xla_attention`, the plain einsum form, for CPU tensors. Layout is
the JAX package's (B, H, S, D); output is in q.dtype.

On the card q, k and v may be strided views (a contiguous D axis, any
strides for B, H and S, e.g. the slices of a (B, S, 3, H, D) qkv product),
and the output is a (B, H, S, D) view of a (B, S, H, D) buffer, so
`out.transpose(1, 2)` is contiguous. bf16 runs on the tensor cores
(wgmma, TMA loads), fp32 on the SIMT pipes.

The kernel is also the custom operator `wvn::flash_attention`
(torch.library.custom_op), so `torch.export` records it as one node of the
graph, and the engine AOTInductor compiles from that graph
(feature_extractor/aot_engine.py) calls it through Inductor's proxy
executor: K1 stays the attention there, and its launches count. Its fake (shape-only) version gives the layout the real
call returns on each device: on CUDA the (B, H, S, D) view of a
(B, S, H, D) buffer, on the CPU a contiguous tensor. `flash_attention` is
the one entry point: under torch.export it calls the operator; eager calls
run the operator's body directly, because the dispatcher's cost (23 to 37
µs per call on the card's host, 0.27 to 0.45 ms over a frame's 12 calls,
and 0.4 to 4.9 ms of frame time in paired runs; NVIDIA H100 80GB HBM3,
chip_smoke.py phase 4k) is more than the 0.3 ms per frame the port allows
it.
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


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sm_scale: float) -> torch.Tensor:
    """K1 on CUDA tensors (D = 64, bf16 or fp32), or raise."""
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


def _flash_attention_body(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sm_scale: float) -> torch.Tensor:
    """The operator's body: K1 for CUDA tensors, the plain version
    (contiguous) for CPU tensors."""
    if q.device.type == "cpu":
        return xla_attention(q, k, v, sm_scale).contiguous()
    return _launch(q, k, v, sm_scale)


flash_attention_op = torch.library.custom_op("wvn::flash_attention", _flash_attention_body, mutates_args=())


@flash_attention_op.register_fake
def _flash_attention_fake(q, k, v, sm_scale):
    B, H, S, D = q.shape
    if q.device.type == "cuda":
        return q.new_empty((B, S, H, D)).transpose(1, 2)
    return q.new_empty((B, H, S, D))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sm_scale: float = 1.0) -> torch.Tensor:
    """softmax(q kᵀ · sm_scale) v. q, k, v: (B, H, S, D); under
    torch.export the operator `wvn::flash_attention`.

    CUDA tensors run kernel K1 (D = 64, bf16 or fp32) or raise; CPU
    tensors take the plain version."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if torch.compiler.is_exporting():
        return flash_attention_op(q, k, v, float(sm_scale))
    return _flash_attention_body(q, k, v, float(sm_scale))


flash_attention.launches = 0
