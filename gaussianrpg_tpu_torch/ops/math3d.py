"""Quaternion / rotation / covariance math in PyTorch.

Counterpart of `gaussianrpg_tpu/ops/math3d.py`; same formulas and the same
elementwise evaluation order (no batched 3x3 matmuls), so results agree with
the JAX package to float32 rounding. Quaternion convention: (w, x, y, z).
"""
from __future__ import annotations

import math

import torch


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Quaternion [..., 4] -> rotation matrix [..., 3, 3] (normalizing)."""
    r, x, y, z = q.unbind(-1)
    two_s = 2.0 / torch.sum(q * q, dim=-1)
    m = torch.stack(
        [
            1 - two_s * (y * y + z * z),
            two_s * (x * y - z * r),
            two_s * (x * z + y * r),
            two_s * (x * y + z * r),
            1 - two_s * (x * x + z * z),
            two_s * (y * z - x * r),
            two_s * (x * z - y * r),
            two_s * (y * z + x * r),
            1 - two_s * (x * x + y * y),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def unnormalized_quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Rotation matrix from the raw quaternion (the CUDA computeCov3D
    behaviour: callers normalize upstream)."""
    r, x, y, z = q.unbind(-1)
    m = torch.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y),
            2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x),
            2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quaternion(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> unit quaternion [..., 4], picking the
    numerically best of the four candidates."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    q_abs_sq = torch.stack(
        [
            1.0 + m00 + m11 + m22,
            1.0 + m00 - m11 - m22,
            1.0 - m00 + m11 - m22,
            1.0 - m00 - m11 + m22,
        ],
        dim=-1,
    )
    q_abs = torch.sqrt(torch.clamp(q_abs_sq, min=0.0))
    quat_by_rijk = torch.stack(
        [
            torch.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], -1),
            torch.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], -1),
            torch.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], -1),
            torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], -1),
        ],
        dim=-2,
    )
    quat_candidates = quat_by_rijk / (2.0 * torch.clamp(q_abs[..., None],
                                                        min=0.1))
    best = torch.argmax(q_abs, dim=-1)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.gather(quat_candidates, -2, idx)[..., 0, :]
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quaternion_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product of (w, x, y, z) quaternions."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quaternion_invert(q: torch.Tensor) -> torch.Tensor:
    """Conjugate of a unit quaternion."""
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype,
                            device=q.device)


def quaternion_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v [..., 3] by unit quaternions q [..., 4]."""
    return torch.einsum("...ij,...j->...i", quaternion_to_matrix(q), v)


def quaternion_slerp(q0: torch.Tensor, q1: torch.Tensor, t) -> torch.Tensor:
    """Shortest-arc spherical interpolation with a lerp fallback for
    nearly parallel quaternions. The arccos is taken of a safe argument
    where the lerp branch is chosen, so its infinite derivative at |d| = 1
    never meets the branch's zero cotangent (0 * inf = NaN); values are
    unchanged. The JAX package does not do this, and its gradient of a
    tracked rotation residual is NaN when the two tracklet rotations are
    equal (ROADMAP, faults)."""
    t = torch.as_tensor(t, dtype=q0.dtype, device=q0.device)
    d = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(d < 0.0, -q1, q1)
    d = torch.clamp(torch.abs(d), -1.0, 1.0)
    with torch.no_grad():
        near = torch.sin(torch.arccos(d)) < 1e-6
    theta = torch.arccos(torch.where(near, torch.zeros_like(d), d))
    sin_theta = torch.sin(theta)
    safe = torch.where(near, torch.ones_like(sin_theta), sin_theta)
    w0 = torch.where(near, 1.0 - t, torch.sin((1.0 - t) * theta) / safe)
    w1 = torch.where(near, t * torch.ones_like(theta),
                     torch.sin(t * theta) / safe)
    out = w0 * q0 + w1 * q1
    return out / torch.linalg.norm(out, dim=-1, keepdim=True)


def build_scaling_rotation(s: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """L = R @ diag(s): [..., 3, 3]."""
    return quaternion_to_matrix(q) * s[..., None, :]


def build_covariance(s: torch.Tensor, q: torch.Tensor,
                     scale_modifier=1.0) -> torch.Tensor:
    """World covariance R S^2 R^T packed as (xx, xy, xz, yy, yz, zz), from
    the UNNORMALIZED quaternion, written elementwise."""
    R = unnormalized_quaternion_to_matrix(q)
    M = R * (scale_modifier * s)[..., None, :]
    m0, m1, m2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]

    def dot3(a, b):
        return torch.sum(a * b, dim=-1)

    return torch.stack(
        [dot3(m0, m0), dot3(m0, m1), dot3(m0, m2),
         dot3(m1, m1), dot3(m1, m2), dot3(m2, m2)],
        dim=-1,
    )


def strip_symmetric(sigma: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] symmetric -> packed [..., 6] (xx, xy, xz, yy, yz, zz)."""
    return torch.stack(
        [sigma[..., 0, 0], sigma[..., 0, 1], sigma[..., 0, 2],
         sigma[..., 1, 1], sigma[..., 1, 2], sigma[..., 2, 2]],
        dim=-1,
    )


def unpack_sym6(cov6: torch.Tensor) -> torch.Tensor:
    """Packed [..., 6] -> full symmetric [..., 3, 3]."""
    xx, xy, xz, yy, yz, zz = cov6.unbind(-1)
    return torch.stack([torch.stack([xx, xy, xz], -1),
                        torch.stack([xy, yy, yz], -1),
                        torch.stack([xz, yz, zz], -1)], dim=-2)


def se3_compose(R1, t1, R2, t2):
    """(R1, t1) . (R2, t2): apply (R2, t2) first. Returns (R, t)."""
    return R1 @ R2, torch.einsum("...ij,...j->...i", R1, t2) + t1


def se3_inverse(R, t):
    Rt = R.transpose(-1, -2)
    return Rt, -torch.einsum("...ij,...j->...i", Rt, t)


def l1_abs(x: torch.Tensor) -> torch.Tensor:
    """|x| for L1 terms, with derivative 1 at x == 0 as in the JAX package
    (`torch.abs` gives 0 there). It matters where a term starts exactly at
    its minimum, as an identity colour correction does."""
    return torch.where(x >= 0, x, -x)


def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """log(x / (1 - x))."""
    return torch.log(x / (1.0 - x))


def exp_lr_schedule(lr_init, lr_final, max_steps, lr_delay_steps=0,
                    lr_delay_mult=1.0):
    """Log-lerp learning-rate schedule with an optional sin-eased delay:
    f(step) -> float, as `math3d.exp_lr_schedule` (evaluated in float32)."""
    def schedule(step):
        if lr_init == 0.0 and lr_final == 0.0:
            return 0.0
        step = torch.tensor(float(step), dtype=torch.float32)
        t = torch.clamp(step / max_steps, 0.0, 1.0)
        log_init = torch.log(torch.tensor(lr_init, dtype=torch.float32))
        log_final = torch.log(torch.tensor(lr_final, dtype=torch.float32))
        log_lerp = torch.exp(log_init * (1 - t) + log_final * t)
        if lr_delay_steps > 0:
            delay_rate = lr_delay_mult + (1 - lr_delay_mult) * torch.sin(
                0.5 * math.pi * torch.clamp(step / lr_delay_steps, 0.0, 1.0))
        else:
            delay_rate = 1.0
        return float(delay_rate * log_lerp)

    return schedule
