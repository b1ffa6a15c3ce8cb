"""A plain tile rasterizer of 3D Gaussians, written from the published
method (Kerbl et al., "3D Gaussian Splatting for Real-Time Radiance Field
Rendering", SIGGRAPH 2023, and its CUDA rasterizer's conventions):

- projection: the pinhole camera's world->camera matrix V and its OpenGL
  projection P (z in [0.001, 1000]); a Gaussian is seen when its view
  depth exceeds 0.2;
- EWA splatting: the 2D covariance J W Sigma W^T J^T with the view
  direction clamped to 1.3 x tan(fov) and 0.3 px^2 added on the diagonal;
  Sigma = R S S^T R^T from the quaternion (w, x, y, z) as given;
- tiles: a Gaussian covers the tiles of the square of radius
  ceil(3 sqrt(lambda_max)) around its mean (lambda_max with the 0.1 floor
  on the discriminant); within a tile the pairs are in view-depth order,
  ties by index;
- compositing, front to back at integer pixel centres: a pair is skipped
  where its exponent is positive or op * exp(power) < 1/255; alpha =
  min(0.99, op * exp(power)); a pixel stops before the pair that would
  take its transmittance below 1e-4; out = sum w c + T_final bg.

Everything is evaluated densely per tile, all pairs of a tile against all
its pixels, in blocks of tiles that fit in memory. `render` also counts
the work that the blend needs on these inputs (`BlendCounts`). Plain
PyTorch; nothing here knows the port's layouts.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

Z_NEAR, Z_FAR = 0.001, 1000.0
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_STOP = 1e-4
BLOCK_ELEMS = 1 << 25          # (tile, pair, pixel) elements in one block


class Camera(NamedTuple):
    view: torch.Tensor         # [4, 4] float32 world -> camera
    full: torch.Tensor         # [4, 4] float32 P @ V
    width: int
    height: int
    fx: float
    fy: float
    tan_fovx: float
    tan_fovy: float


class BlendCounts(NamedTuple):
    """What the front-to-back blend needs on one frame's inputs."""

    pairs: int                 # (Gaussian, tile) pairs that colour a pixel
    live_pair_pixels: int      # non-skipped pairs a pixel meets up to and
                               # including the one that stops it
    pixels: int                # H x W


def pinhole_camera(c2w: np.ndarray, fovx: float, width: int, height: int,
                   device) -> Camera:
    """A camera from a camera->world pose and a horizontal field of view,
    the focal lengths and matrices rounded to float32 as a camera file
    stores them; principal point at the image centre."""
    fovy = 2 * math.atan(math.tan(fovx / 2) * height / width)
    fx = float(np.float32(width / (2 * math.tan(fovx / 2))))
    fy = float(np.float32(height / (2 * math.tan(fovy / 2))))
    view = np.linalg.inv(np.asarray(c2w, np.float64)).astype(np.float32)
    proj = np.zeros((4, 4))
    proj[0, 0] = 2 * fx / width
    proj[1, 1] = 2 * fy / height
    proj[0, 2] = -1 + 2 * (np.float32(width / 2) / width)
    proj[1, 2] = -1 + 2 * (np.float32(height / 2) / height)
    proj[2, 2] = (Z_FAR + Z_NEAR) / (Z_FAR - Z_NEAR)
    proj[2, 3] = -2 * Z_FAR * Z_NEAR / (Z_FAR - Z_NEAR)
    proj[3, 2] = 1.0
    full = (proj.astype(np.float32).astype(np.float64)
            @ view.astype(np.float64)).astype(np.float32)
    return Camera(torch.as_tensor(view, device=device),
                  torch.as_tensor(full, device=device), int(width),
                  int(height), fx, fy, width / (2 * fx), height / (2 * fy))


def _affine(m: torch.Tensor, p: torch.Tensor, row: int) -> torch.Tensor:
    """(m @ [p, 1])[row], one product and sum at a time."""
    return (m[row, 0] * p[:, 0] + m[row, 1] * p[:, 1] + m[row, 2] * p[:, 2]
            + m[row, 3])


def _rotation(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(-1, 3, 3)


class Splats(NamedTuple):
    mean: torch.Tensor         # [N, 2] pixels
    conic: torch.Tensor        # [N, 3] (a, b, c) of the inverse covariance
    opacity: torch.Tensor      # [N]
    color: torch.Tensor        # [N, C]
    depth: torch.Tensor        # [N]
    rect: torch.Tensor         # [N, 4] tile x0, y0, x1, y1 (end exclusive)
    visible: torch.Tensor      # [N] bool


def project(means, scales, quats, opacities, colors, cam: Camera,
            tile_x: int, tile_y: int) -> Splats:
    """Per-Gaussian projection and tile rectangles."""
    W, H = cam.width, cam.height
    gx, gy = -(-W // tile_x), -(-H // tile_y)
    depth = _affine(cam.view, means, 2)
    hom = [_affine(cam.full, means, r) for r in range(4)]
    inv_w = 1.0 / (hom[3] + 1e-7)
    mx = ((hom[0] * inv_w + 1.0) * W - 1.0) * 0.5
    my = ((hom[1] * inv_w + 1.0) * H - 1.0) * 0.5

    rot = _rotation(quats)
    m = rot * scales[:, None, :]
    sigma = m @ m.transpose(1, 2)
    tz = depth.clamp(min=0.2)
    tx = (_affine(cam.view, means, 0) / tz).clamp(
        -1.3 * cam.tan_fovx, 1.3 * cam.tan_fovx) * tz
    ty = (_affine(cam.view, means, 1) / tz).clamp(
        -1.3 * cam.tan_fovy, 1.3 * cam.tan_fovy) * tz
    zero = torch.zeros_like(tz)
    jac = torch.stack([
        torch.stack([cam.fx / tz, zero, -cam.fx * tx / (tz * tz)], -1),
        torch.stack([zero, cam.fy / tz, -cam.fy * ty / (tz * tz)], -1),
    ], 1)                                                  # [N, 2, 3]
    t = jac @ cam.view[:3, :3]
    cov = t @ sigma @ t.transpose(1, 2)
    a, b, c = cov[:, 0, 0] + 0.3, cov[:, 0, 1], cov[:, 1, 1] + 0.3
    det = a * c - b * b
    ok = det != 0
    inv = 1.0 / torch.where(ok, det, torch.ones_like(det))
    conic = torch.stack([c * inv, -b * inv, a * inv], -1)
    mid = 0.5 * (a + c)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lam.clamp(min=0)))
    rect = torch.stack([
        torch.floor((mx - radius) / tile_x).clamp(0, gx),
        torch.floor((my - radius) / tile_y).clamp(0, gy),
        torch.floor((mx + radius + tile_x - 1) / tile_x).clamp(0, gx),
        torch.floor((my + radius + tile_y - 1) / tile_y).clamp(0, gy),
    ], -1).long()
    area = (rect[:, 2] - rect[:, 0]) * (rect[:, 3] - rect[:, 1])
    visible = (depth > 0.2) & ok & (area > 0)
    return Splats(torch.stack([mx, my], -1), conic, opacities.reshape(-1),
                  colors, depth, rect, visible)


def _pairs(s: Splats, gx: int):
    """(tile, Gaussian) of every pair, grouped by tile, depth order within
    a tile."""
    idx = torch.nonzero(s.visible).flatten()
    idx = idx[torch.sort(s.depth[idx], stable=True).indices]
    r = s.rect[idx]
    nx, ny = r[:, 2] - r[:, 0], r[:, 3] - r[:, 1]
    n = nx * ny
    g = torch.repeat_interleave(idx, n)
    start = torch.cumsum(n, 0) - n
    local = torch.arange(g.shape[0], device=g.device) \
        - torch.repeat_interleave(start, n)
    rr = torch.repeat_interleave(r, n, dim=0)
    nxr = torch.repeat_interleave(nx, n)
    tile = (rr[:, 1] + local // nxr) * gx + rr[:, 0] + local % nxr
    order = torch.sort(tile, stable=True).indices
    return tile[order], g[order]


def composite(s: Splats, width: int, height: int, tile_x: int, tile_y: int,
              bg: torch.Tensor, count: bool = False):
    """[C, H, W] image of the splats (and `BlendCounts` with `count`)."""
    dev = s.mean.device
    gx, gy = -(-width // tile_x), -(-height // tile_y)
    n_tiles, n_pix = gx * gy, tile_x * tile_y
    ch = s.color.shape[1]
    tile, g = _pairs(s, gx)
    per_tile = torch.bincount(tile, minlength=n_tiles)
    first = torch.cumsum(per_tile, 0) - per_tile
    planes = bg.reshape(1, ch, 1).to(torch.float32).expand(
        n_tiles, ch, n_pix).clone()
    live = torch.zeros((), dtype=torch.int64, device=dev)
    n_pairs = torch.zeros((), dtype=torch.int64, device=dev)
    p = torch.arange(n_pix, device=dev)
    by_count = torch.argsort(per_tile, descending=True).tolist()
    counts = per_tile.tolist()
    i = 0
    while i < len(by_count) and counts[by_count[i]] > 0:
        m = counts[by_count[i]]
        nb = max(1, BLOCK_ELEMS // (m * n_pix))
        tb_list = [t for t in by_count[i:i + nb] if counts[t] > 0]
        i += len(tb_list)
        tb = torch.tensor(tb_list, device=dev)
        j = torch.arange(m, device=dev)
        slot = first[tb][:, None] + j[None, :]
        real = j[None, :] < per_tile[tb][:, None]                  # [B, M]
        gi = g[slot.clamp(max=g.shape[0] - 1)]
        px = (tb % gx)[:, None] * tile_x + p[None, :] % tile_x      # [B, P]
        py = (tb // gx)[:, None] * tile_y + p[None, :] // tile_x
        dx = s.mean[gi, 0][:, :, None] - px[:, None, :].to(torch.float32)
        dy = s.mean[gi, 1][:, :, None] - py[:, None, :].to(torch.float32)
        ca, cb, cc = (s.conic[gi, k][:, :, None] for k in range(3))
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        del dx, dy
        alpha_raw = s.opacity[gi][:, :, None] * torch.exp(power)
        skip = (power > 0) | (alpha_raw < ALPHA_MIN) | ~real[:, :, None]
        del power
        alpha = alpha_raw.clamp(max=ALPHA_MAX)
        del alpha_raw
        one_m = torch.where(skip, torch.ones_like(alpha), 1.0 - alpha)
        t_incl = torch.cumprod(one_m, dim=1)
        del one_m
        t_excl = torch.cat([torch.ones_like(t_incl[:, :1]),
                            t_incl[:, :-1]], dim=1)
        alive = t_incl >= T_STOP
        contrib = ~skip & alive
        w = torch.where(contrib, alpha * t_excl, torch.zeros_like(alpha))
        del t_excl, alpha
        t_final = torch.where(contrib, t_incl,
                              torch.full_like(t_incl, 2.0)).amin(1)
        t_final = t_final.clamp(max=1.0)                            # [B, P]
        del t_incl
        col = s.color[gi]                                           # [B, M, C]
        acc = torch.bmm(col.transpose(1, 2), w)                     # [B, C, P]
        planes[tb] = acc + t_final[:, None, :] * bg.reshape(1, ch, 1)
        if count:
            stop = ~skip & ~alive
            before = (torch.cumsum(stop.to(torch.int32), 1)
                      - stop.to(torch.int32)) > 0
            live += (~skip & ~before).sum()
            n_pairs += contrib.any(dim=2).sum()
        del w, contrib, skip, alive
    img = planes.view(gy, gx, ch, tile_y, tile_x).permute(2, 0, 3, 1, 4) \
        .reshape(ch, gy * tile_y, gx * tile_x)[:, :height, :width]
    if not count:
        return img.contiguous()
    return img.contiguous(), BlendCounts(int(n_pairs), int(live),
                                         width * height)


def render(means, scales, quats, opacities, colors, cam: Camera, *,
           tile_x: int, tile_y: int, bg: torch.Tensor, count: bool = False,
           field_dtype: torch.dtype | None = None):
    """Rendered [C, H, W] (and counts). `field_dtype` rounds each splat's
    2D fields (mean, conic, opacity, colour) to that type before the
    blend, as a pair layout stored in it would: the control's form."""
    s = project(means, scales, quats, opacities, colors, cam, tile_x, tile_y)
    if field_dtype is not None:
        def rnd(x):
            return x.to(field_dtype).to(torch.float32)
        s = s._replace(mean=rnd(s.mean), conic=rnd(s.conic),
                       opacity=rnd(s.opacity), color=rnd(s.color))
    return composite(s, cam.width, cam.height, tile_x, tile_y, bg, count)
