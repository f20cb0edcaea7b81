"""SO(3)/SE(3) Lie-group operations in torch.

Port of wild_visual_navigation_tpu/utils/lie.py. Rotations are 3x3
matrices, poses 4x4 homogeneous matrices, tangent vectors
`[rho (3), phi (3)]` (translation first). Everything is batched over
leading dimensions and branch-free.

The JAX package pins its 3x3 products to full fp32 precision; here every
small product is written out as elementwise products summed in index
order, so no TF32 or reduced-precision matmul path can be taken, on any
device and whatever the global matmul settings.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def hat(v: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator. v: (..., 3) -> (..., 3, 3) skew-symmetric."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def vee(m: torch.Tensor) -> torch.Tensor:
    """Inverse of hat. m: (..., 3, 3) -> (..., 3)."""
    return torch.stack([m[..., 2, 1], m[..., 0, 2], m[..., 1, 0]], dim=-1)


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., n, k) @ (..., k, m) as elementwise products summed in fp32."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def _matvec(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., n, k) @ (..., k) -> (..., n)."""
    return (m * v[..., None, :]).sum(-1)


def _eye(like: torch.Tensor, n: int = 3) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula with series coefficients near zero.
    phi: (..., 3) -> (..., 3, 3)."""
    theta2 = torch.sum(phi * phi, dim=-1)
    small = theta2 < 1e-8
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta_safe = torch.sqrt(theta2_safe)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta_safe) / theta_safe)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta_safe)) / theta2_safe)
    K = hat(phi)
    return _eye(phi) + a[..., None, None] * K + b[..., None, None] * _matmul(K, K)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Log map of SO(3), branch-free over theta ~ 0 (series), the generic
    formula, and theta ~ pi (axis from the symmetric part, sign from the
    skew part). R: (..., 3, 3) -> (..., 3)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_theta)
    theta2 = theta * theta
    small = theta2 < 1e-8
    near_pi = cos_theta < -1.0 + 1e-5
    w = vee(R - R.transpose(-1, -2))  # = 2 sin(theta) * axis
    sin_safe = torch.where(small | near_pi, torch.ones_like(theta), torch.sin(theta))
    scale = torch.where(small, 0.5 + theta2 / 12.0, theta / (2.0 * sin_safe))
    generic = scale[..., None] * w

    S = 0.5 * (R + R.transpose(-1, -2)) - cos_theta[..., None, None] * _eye(R)
    diag = torch.diagonal(S, dim1=-2, dim2=-1)
    k = torch.argmax(diag, dim=-1)
    col = torch.gather(S, -1, k[..., None, None].expand(*S.shape[:-1], 1))[..., 0]
    axis = col / (torch.sqrt(torch.sum(col * col, dim=-1, keepdim=True)) + _EPS)
    sgn = torch.where(torch.sum(axis * w, dim=-1) < 0.0, -1.0, 1.0).to(R.dtype)
    pi_val = (theta * sgn)[..., None] * axis
    return torch.where(near_pi[..., None], pi_val, generic)


def so3_from_rpy(rpy: torch.Tensor) -> torch.Tensor:
    """Rotation from roll-pitch-yaw: R = Rz(yaw) @ Ry(pitch) @ Rx(roll)."""
    r, p, y = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    cr, sr = torch.cos(r), torch.sin(r)
    cp, sp = torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    row0 = torch.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], dim=-1)
    row1 = torch.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], dim=-1)
    row2 = torch.stack([-sp, cp * sr, cp * cr], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (x, y, z, w), ROS order -> rotation matrix (..., 3, 3)."""
    q = q / (torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True)) + _EPS)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], dim=-1)
    row1 = torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], dim=-1)
    row2 = torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def rot_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> quaternion (x, y, z, w), branch-free."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def half_sqrt(v):
        return torch.sqrt(torch.clamp_min(v, _EPS)) * 0.5

    qw0 = half_sqrt(1.0 + tr)
    c0 = torch.stack([(m21 - m12), (m02 - m20), (m10 - m01), 4.0 * qw0 * qw0], dim=-1) / (4.0 * qw0[..., None])
    qx1 = half_sqrt(1.0 + m00 - m11 - m22)
    c1 = torch.stack([4.0 * qx1 * qx1, (m01 + m10), (m02 + m20), (m21 - m12)], dim=-1) / (4.0 * qx1[..., None])
    qy2 = half_sqrt(1.0 - m00 + m11 - m22)
    c2 = torch.stack([(m01 + m10), 4.0 * qy2 * qy2, (m12 + m21), (m02 - m20)], dim=-1) / (4.0 * qy2[..., None])
    qz3 = half_sqrt(1.0 - m00 - m11 + m22)
    c3 = torch.stack([(m02 + m20), (m12 + m21), 4.0 * qz3 * qz3, (m10 - m01)], dim=-1) / (4.0 * qz3[..., None])

    cond0 = (tr > 0)[..., None]
    cond1 = ((m00 >= m11) & (m00 >= m22))[..., None]
    cond2 = (m11 >= m22)[..., None]
    q = torch.where(cond0, c0, torch.where(cond1, c1, torch.where(cond2, c2, c3)))
    return q / (torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True)) + _EPS)


def _so3_left_jacobian(phi: torch.Tensor) -> torch.Tensor:
    theta2 = torch.sum(phi * phi, dim=-1)
    small = theta2 < 1e-8
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2_safe)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (theta - torch.sin(theta)) / (theta2_safe * theta))
    K = hat(phi)
    return _eye(phi) + b[..., None, None] * K + c[..., None, None] * _matmul(K, K)


def _so3_left_jacobian_inv(phi: torch.Tensor) -> torch.Tensor:
    theta2 = torch.sum(phi * phi, dim=-1)
    small = theta2 < 1e-8
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    half = theta * 0.5
    sin_half_safe = torch.where(small, torch.ones_like(half), torch.sin(half))
    cot_coeff = torch.where(small, 1.0 / 12.0 + theta2 / 720.0,
                            (1.0 - half * torch.cos(half) / sin_half_safe) / theta2_safe)
    K = hat(phi)
    return _eye(phi) - 0.5 * K + cot_coeff[..., None, None] * _matmul(K, K)


def se3_matrix(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) pose from rotation (..., 3, 3) and translation (..., 3)."""
    T = torch.zeros(R.shape[:-2] + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """Exp map of SE(3). xi: (..., 6) = [rho, phi] -> (..., 4, 4)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    return se3_matrix(so3_exp(phi), _matvec(_so3_left_jacobian(phi), rho))


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """Log map of SE(3). T: (..., 4, 4) -> (..., 6) = [rho, phi]."""
    phi = so3_log(T[..., :3, :3])
    rho = _matvec(_so3_left_jacobian_inv(phi), T[..., :3, 3])
    return torch.cat([rho, phi], dim=-1)


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    """Inverse of homogeneous transforms without a linear solve."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    return se3_matrix(Rt, -_matvec(Rt, T[..., :3, 3]))


def transform_points(T: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply transform(s) T (..., 4, 4) to points (..., N, 3) -> (..., N, 3)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return (R[..., None, :, :] * points[..., :, None, :]).sum(-1) + t[..., None, :]


def pose_distance(T_a: torch.Tensor, T_b: torch.Tensor) -> torch.Tensor:
    """Translational distance ||log(T_a^-1 T_b)[:3]||."""
    rel = _matmul(se3_inverse(T_a), T_b)
    rho = se3_log(rel)[..., :3]
    return torch.sqrt(torch.sum(rho * rho, dim=-1))
