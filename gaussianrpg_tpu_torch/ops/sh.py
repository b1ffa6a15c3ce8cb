"""Spherical-harmonics evaluation + the 4D (time-conditioned) Fourier DC
basis, in PyTorch.

Counterpart of `gaussianrpg_tpu/ops/sh.py`: same coefficients, same basis
order, same clamp.
"""
from __future__ import annotations

import math

import torch

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
SH_C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)


def num_sh_coeffs(degree: int) -> int:
    return (degree + 1) ** 2


def eval_sh_basis(degree: int, dirs: torch.Tensor) -> torch.Tensor:
    """Real SH basis (degree 0..3) at unit directions: [..., 3] ->
    [..., (degree+1)^2]."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    out = [torch.full_like(x, SH_C0)]
    if degree > 0:
        out += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if degree > 1:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out += [
            SH_C2[0] * xy,
            SH_C2[1] * yz,
            SH_C2[2] * (2.0 * zz - xx - yy),
            SH_C2[3] * xz,
            SH_C2[4] * (xx - yy),
        ]
    if degree > 2:
        xx, yy, zz = x * x, y * y, z * z
        xy = x * y
        out += [
            SH_C3[0] * y * (3.0 * xx - yy),
            SH_C3[1] * xy * z,
            SH_C3[2] * y * (4.0 * zz - xx - yy),
            SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            SH_C3[4] * x * (4.0 * zz - xx - yy),
            SH_C3[5] * z * (xx - yy),
            SH_C3[6] * x * (xx - 3.0 * yy),
        ]
    return torch.stack(out, dim=-1)


def eval_sh(degree: int, sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """sh [..., K, 3] (K >= (degree+1)^2), dirs [..., 3] unit -> raw RGB
    (before +0.5 and the clamp)."""
    basis = eval_sh_basis(degree, dirs)
    b = basis.shape[-1]
    return torch.sum(basis[..., :, None] * sh[..., :b, :], dim=-2)


def sh_to_rgb_clamped(degree: int, sh: torch.Tensor, dirs: torch.Tensor):
    """eval + 0.5, clamped at 0 from below. Returns (rgb, clamped_mask)."""
    raw = eval_sh(degree, sh, dirs) + 0.5
    return torch.clamp(raw, min=0.0), raw < 0.0


def rgb_to_sh(rgb):
    """(rgb - 0.5) / C0; works on tensors and numpy arrays alike."""
    return (rgb - 0.5) / SH_C0


def sh_to_rgb(sh):
    """sh * C0 + 0.5, the inverse of `rgb_to_sh`."""
    return sh * SH_C0 + 0.5


def idft_basis(time: torch.Tensor, dim: int) -> torch.Tensor:
    """Inverse-DFT basis for Fourier-stacked DC coefficients: even k ->
    cos(pi t k), odd k -> sin(pi t (k+1)). time [...] -> [..., dim]."""
    t = time.to(torch.float32)[..., None]
    k = torch.arange(dim, device=t.device)
    even = (k % 2) == 0
    return torch.where(even, torch.cos(math.pi * t * k),
                       torch.sin(math.pi * t * (k + 1))).to(torch.float32)


def fourier_features_dc(features_dc: torch.Tensor, time,
                        fourier_scale=1.0) -> torch.Tensor:
    """Combine per-frequency DC coefficients [N, F, 3] at a normalized time
    -> [N, 1, 3]."""
    time = torch.as_tensor(time, device=features_dc.device)
    basis = idft_basis(time * fourier_scale, features_dc.shape[-2])
    return torch.sum(features_dc * basis[..., None], dim=-2, keepdim=True)
