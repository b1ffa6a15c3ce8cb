"""Learnable sky cube map with a bilinear cube sampler.

Counterpart of `gaussianrpg_tpu/models/sky.py`: GL face order (+x, -x, +y,
-y, +z, -z), bilinear lookup clamped to the face edge, pixel-centre rays
(uniformly jittered inside the pixel in training, drawn from a
`torch.Generator`). The cube map is a plain tensor the trainer learns.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class SkyCubeMap:
    cube_map: torch.Tensor   # [6, R, R, 3]

    @property
    def resolution(self) -> int:
        return self.cube_map.shape[1]

    def replace(self, **kw) -> "SkyCubeMap":
        return dataclasses.replace(self, **kw)


def init_sky_cubemap(resolution: int = 1024, init_value: float = 0.5,
                     device=None) -> SkyCubeMap:
    from ..utils.device import resolve_device
    return SkyCubeMap(torch.full((6, resolution, resolution, 3), init_value,
                                 dtype=torch.float32,
                                 device=resolve_device(device)))


def _cube_face_uv(d: torch.Tensor):
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    ax, ay, az = torch.abs(x), torch.abs(y), torch.abs(z)
    is_x = (ax >= ay) & (ax >= az)
    is_y = (~is_x) & (ay >= az)

    def pick(px, nx):
        return torch.where(x > 0, px, nx)

    i = lambda v: torch.full_like(x, v, dtype=torch.int64)  # noqa: E731
    face = torch.where(
        is_x, pick(i(0), i(1)),
        torch.where(is_y, torch.where(y > 0, i(2), i(3)),
                    torch.where(z > 0, i(4), i(5))))
    ma = torch.where(is_x, ax, torch.where(is_y, ay, az))
    ma = torch.clamp(ma, min=1e-12)
    sc = torch.where(is_x, torch.where(x > 0, -z, z),
                     torch.where(is_y, x, torch.where(z > 0, x, -x)))
    tc = torch.where(is_x, -y, torch.where(is_y, torch.where(y > 0, z, -z),
                                           -y))
    u = 0.5 * (sc / ma + 1.0)
    v = 0.5 * (tc / ma + 1.0)
    return face, u, v


def sample_cubemap(cube_map: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Bilinear cube-map lookup: [6,R,R,3], dirs [...,3] -> [...,3]."""
    r = cube_map.shape[1]
    face, u, v = _cube_face_uv(dirs)
    fu = u * r - 0.5
    fv = v * r - 0.5
    x0 = torch.floor(fu)
    y0 = torch.floor(fv)
    wx = (fu - x0)[..., None]
    wy = (fv - y0)[..., None]
    x0 = torch.clamp(x0.to(torch.int64), 0, r - 1)
    y0 = torch.clamp(y0.to(torch.int64), 0, r - 1)
    x1 = torch.clamp(x0 + 1, 0, r - 1)
    y1 = torch.clamp(y0 + 1, 0, r - 1)
    c00 = cube_map[face, y0, x0]
    c01 = cube_map[face, y0, x1]
    c10 = cube_map[face, y1, x0]
    c11 = cube_map[face, y1, x1]
    return ((1 - wy) * ((1 - wx) * c00 + wx * c01)
            + wy * ((1 - wx) * c10 + wx * c11))


def _uniform(shape, generator: torch.Generator, device) -> torch.Tensor:
    """U[0, 1) draws of the training ray jitter (tests replace this helper
    to feed the JAX package's draws)."""
    return torch.rand(shape, generator=generator, device=device)


def camera_rays(camera, perturb: torch.Generator | None = None
                ) -> torch.Tensor:
    """Per-pixel world-space unit ray directions [H, W, 3] through pixel
    centres, or (with a `perturb` generator) through uniform points of
    each pixel: the column offsets are drawn first, then the rows."""
    H, W = camera.height, camera.width
    dev = camera.viewmatrix.device
    j, i = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                          torch.arange(W, dtype=torch.float32, device=dev),
                          indexing="ij")
    if perturb is not None:
        i = i + _uniform(i.shape, perturb, dev)
        j = j + _uniform(j.shape, perturb, dev)
    else:
        i = i + 0.5
        j = j + 0.5
    xy1 = torch.stack([i, j, torch.ones_like(i)], dim=-1)
    k_inv = torch.linalg.inv(camera.K)
    pix_cam = xy1 @ k_inv.T
    rot = camera.viewmatrix[:3, :3].T
    dirs = pix_cam @ rot.T
    return dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)


def render_sky(sky: SkyCubeMap, camera,
               perturb: torch.Generator | None = None) -> torch.Tensor:
    """Sky colour image [3, H, W] (the renderer composites
    rgb += sky * (1 - acc))."""
    color = sample_cubemap(sky.cube_map, camera_rays(camera, perturb))
    return torch.clamp(color, 0.0, 1.0).permute(2, 0, 1)


def cubemap_to_latlong(sky: SkyCubeMap, height: int = 512):
    """LDR lat-long panorama [height, 2 * height, 3] as a numpy array (the
    directions built in float64 numpy, sampled in float32)."""
    width = height * 2
    theta = (np.arange(height) + 0.5) / height * np.pi
    phi = (np.arange(width) + 0.5) / width * 2 * np.pi - np.pi
    t, p = np.meshgrid(theta, phi, indexing="ij")
    dirs = np.stack(
        [np.sin(t) * np.sin(p), -np.cos(t), np.sin(t) * np.cos(p)], axis=-1)
    with torch.no_grad():
        img = sample_cubemap(sky.cube_map, torch.as_tensor(
            dirs.astype(np.float32), device=sky.cube_map.device))
    return np.clip(img.cpu().numpy(), 0, 1)
