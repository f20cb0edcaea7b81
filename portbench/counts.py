"""Operations and bytes of the kernels, from shapes alone, against NVIDIA's
published H100 SXM peaks (dense, 700 W): a frozen copy of chip_smoke.py's
`bound` and its per-kernel counts. A configuration's pipeline
(`pipelines/<name>.py`) gives the shapes its frame launches each kernel at
(`kernel_shapes`) and the frame's model FLOPs (`frame_flops`).

A bound is the larger of bytes / peak bandwidth and, over the kinds of
operation a kernel runs, operations / that kind's peak. Inputs are read
once and outputs written once; where the work depends on the data, the
count is the least these shapes need, so a share of the bound never
overstates the kernel.
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16_tensor": 989e12, "bf16x2": 133.8e12, "fp32": 67e12}


def bound_s(nbytes: float, flops: dict) -> float:
    t_ops = max((n / PEAK_FLOPS[kind] for kind, n in flops.items()), default=0.0)
    return max(nbytes / PEAK_BYTES_PER_S, t_ops)


def k1_bound_s(B: int, H: int, S: int, D: int) -> float:
    """Flash attention, bf16: q, k, v in and o out (2 bytes each); QKᵀ and PV on the tensor cores."""
    return bound_s(4 * B * H * S * D * 2, {"bf16_tensor": 4 * B * H * S * S * D})


def k2_bound_s(B: int, Hp: int, H: int, W: int, K1: int = 256, K: int = 32) -> float:
    """The per-pixel scorer over B (H, W) maps from (Hp, ·) patch rows. Bytes:
    hw (B, Hp, W, K1) bf16, zsts (B, Hp, W, K + 3) fp32, the row tables
    (H int32 starts, H x 8 fp32 coefficients), the weights (K x K1 bf16,
    K fp32, (1 + K) x K fp32, K fp32, 2 fp32), the two fp32 maps out.
    Operations per pixel: 2 K K1 on the tensor cores, 3 K1 in bf16x2, and
    K (K + 1) + 10 K + 16 in fp32."""
    n_px = B * H * W
    nbytes = (B * Hp * W * K1 * 2 + B * Hp * W * (K + 3) * 4 + H * 4 + H * 8 * 4
              + K * K1 * 2 + K * 4 + (1 + K) * K * 4 + K * 4 + 2 * 4 + 2 * n_px * 4)
    return bound_s(nbytes, {"bf16_tensor": 2 * K * K1 * n_px, "bf16x2": 3 * K1 * n_px,
                            "fp32": (K * (K + 1) + 10 * K + 16) * n_px})


def k3_bound_s(B: int, H: int, W: int, K: int) -> float:
    """One SLIC step: features (5 x HW fp32) and centres in, ids and new
    centres out; 6 fp32 sums per pixel (the pair count depends on the data
    and is left out)."""
    hw = B * H * W
    return bound_s(5 * hw * 4 + B * K * 5 * 4 + hw * 4 + B * K * 5 * 4, {"fp32": 6 * hw})


def k4_bound_s(B: int, H: int, W: int, N: int = 64, E: int = 32) -> float:
    """Footprints to masks: B x N points (8 bytes and a flag) in, B hulls of
    E vertices and B (H, W) byte masks out; the fill's 6 fp32 operations per
    edge and hull (the march depends on the data and is left out)."""
    return bound_s(B * N * 9 + B * E * 9 + B * H * W, {"fp32": B * (E + 1) * 6})
