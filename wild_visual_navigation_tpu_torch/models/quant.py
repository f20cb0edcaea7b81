"""int8 matrix products for the frozen backbone (W8A8).

Port of wild_visual_navigation_tpu/models/quant.py. Weights are
quantised symmetrically per output channel (scale_j = max_i |W_ij| / 127),
activations per tensor, either per call (`int8_dense`, quant="int8") or
with a calibrated constant scale (`int8_dense_static`,
quant="int8_static"); the product accumulates in int32 and is rescaled
and biased in fp32. `attention_scores_int8` runs both attention products
the same way, with the probabilities quantised per row.

The JAX package leaves these products to XLA, outside any Pallas kernel;
here they are `torch._int_mm` (cuBLASLt on the card, exact on the CPU).
That call takes 2-D int8 operands with more than 16 rows and an inner size
and column count that are multiples of 8, and cuBLASLt's int8 kernels take
the right operand column-major (the "TN" layout): with a row-major one the
card ran 2.4 to 6.6 times slower at the ViTs' shapes and refused some shapes
outright (an inner size of 64). `int_mm` pads with zeros to those sizes
(exact in integers), hands the right operand over column-major (a weight
stored (out, in) is that already) and slices the product back; a shape the
card still refuses raises.

Under a mesh (models/vit.py::shard_heads_, parallel/mesh.py::shard_module)
each rank holds part of a tensor whose per-tensor scale JAX's sharded
program takes over the whole: `group=` reduces the local abs-max with MAX
over the process group that splits it (exact, as max is), and a
row-parallel product sums its int32 accumulators over tp before the
dequantisation (exact too, where summing dequantised fp32 partials would
round differently and flip int8 roundings downstream).

Rounding follows the JAX package: `torch.round` rounds half to even as
`jnp.round` does, values clip to ±127, scales floor at 1e-12. Every scale
stays a tensor on the operands' device (no host sync), and every division
is by a tensor on that device: CUDA divides by a host scalar as a product
with its reciprocal, which can differ from the quotient in its last bit.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

QMAX = 127.0


def _qmax_like(t: torch.Tensor) -> torch.Tensor:
    return torch.full((), QMAX, dtype=torch.float32, device=t.device)


def max_over(t: torch.Tensor, group) -> torch.Tensor:
    """t's elementwise maximum over the ranks of `group` (None: t)."""
    if group is not None:
        t = t.contiguous()
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return t


def quantize_symmetric(x: torch.Tensor, dim: int | None = None, group=None) -> tuple[torch.Tensor, torch.Tensor]:
    """x -> (int8 values, fp32 scale): q = round(x / s), s = amax / 127
    floored at 1e-12; amax over the whole tensor or along `dim` (kept). A
    per-tensor amax is taken over the ranks of `group` too, where x is one
    rank's part of the tensor."""
    amax = x.abs().amax() if dim is None else x.abs().amax(dim=dim, keepdim=True)
    amax = max_over(amax.float(), group if dim is None else None)
    scale = torch.clamp(amax / _qmax_like(x), min=1e-12)
    return quantize_with_scale(x, scale), scale


def quantize_with_scale(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """round(x / scale) clipped to ±127, as int8."""
    return torch.clamp(torch.round(x.float() / scale), -QMAX, QMAX).to(torch.int8)


def _pad_to(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    r, c = t.shape
    return t if (r, c) == (rows, cols) else F.pad(t, (0, cols - c, 0, rows - r))


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32 through `torch._int_mm`,
    zero-padded to M > 16 and K, N multiples of 8, b column-major (no copy
    when b.t() is contiguous)."""
    M, K = a.shape
    N = b.shape[1]
    Mp, Kp, Np = max(M, 17), -(-K // 8) * 8, -(-N // 8) * 8
    acc = torch._int_mm(_pad_to(a, Mp, Kp).contiguous(), _pad_to(b.t(), Np, Kp).contiguous().t())
    return acc if (Mp, Np) == (M, N) else acc[:M, :N]


def int8_matmul_scaled(xq: torch.Tensor, sx: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor,
                       bias: torch.Tensor | None, group=None) -> torch.Tensor:
    """acc(xq @ wq) · (sx · sw) + bias in fp32. xq: (..., in) int8, wq:
    (in, out) int8 (column-major avoids a copy), sx per tensor, sw (1, out).
    With `group` (a row-parallel layer's tp group: each rank holds its
    slice of the inner axis) the int32 accumulators are summed over the
    group first, and the bias is added once, after the sum."""
    lead = xq.shape[:-1]
    acc = int_mm(xq.reshape(-1, xq.shape[-1]), wq)
    if group is not None:
        acc = acc.contiguous()
        dist.all_reduce(acc, group=group)
    y = acc.float() * (sx * sw)
    if bias is not None:
        y = y + bias.float()
    return y.reshape(*lead, wq.shape[1])


def _int8_matmul_bias(xq: torch.Tensor, sx: torch.Tensor, kernel: torch.Tensor,
                      bias: torch.Tensor | None) -> torch.Tensor:
    """The JAX helper: kernel (in, out) quantised per output channel here."""
    wq, sw = quantize_symmetric(kernel, dim=0)
    return int8_matmul_scaled(xq, sx, wq, sw, bias)


def int8_dense(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor | None) -> torch.Tensor:
    """y = x @ kernel + bias with a per-call activation scale. kernel: (in,
    out) fp, the flax layout. fp32 out."""
    xq, sx = quantize_symmetric(x)
    return _int8_matmul_bias(xq, sx, kernel, bias)


def int8_dense_static(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor | None,
                      x_scale: torch.Tensor) -> torch.Tensor:
    """int8_dense with a calibrated activation scale: out-of-range
    activations clip at ±127."""
    return _int8_matmul_bias(quantize_with_scale(x, x_scale), x_scale, kernel, bias)


def _per_head_int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, H, M, K) @ (B, H, K, N) int8 -> int32, one `int_mm` per head."""
    B, H = a.shape[:2]
    out = [int_mm(a[i, h], b[i, h]) for i in range(B) for h in range(H)]
    return torch.stack(out).reshape(B, H, *out[0].shape)


def attention_scores_int8(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sm_scale: float = 1.0,
                          group=None) -> torch.Tensor:
    """softmax(q kᵀ · sm_scale) v with both products in int8: q, k, v per
    tensor (over the ranks of `group` too, where each holds some of the
    frames or heads); the fp32 softmax's probabilities per row (max_k p /
    127, so a diffuse row keeps its precision, and rank-local). q, k, v:
    (B, H, S, Dh); out in q.dtype."""
    qq, sq = quantize_symmetric(q, group=group)
    kq, sk = quantize_symmetric(k, group=group)
    vq, sv = quantize_symmetric(v, group=group)
    s = _per_head_int_mm(qq, kq.transpose(-1, -2)).float() * (sq * sk * sm_scale)
    p = torch.softmax(s, dim=-1)
    p_scale = torch.clamp(p.amax(dim=-1, keepdim=True), min=1e-9) / _qmax_like(p)
    pq = torch.round(p / p_scale).to(torch.int8)
    out = _per_head_int_mm(pq, vq).float() * (p_scale * sv)
    return out.to(q.dtype)
