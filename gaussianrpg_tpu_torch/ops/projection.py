"""Camera projection + EWA splatting math (per-Gaussian preprocess).

Counterpart of `gaussianrpg_tpu/ops/projection.py` (itself the CUDA
`preprocessCUDA`, `forward.cu:155-256`): the same constants, clamps and
evaluation order, so integer outputs (radii, tile rects) come out equal and
floats agree to rounding. Plain tensor code, the route of training and of
the CPU: an eval call on the card runs the whole primitive stage, this
preprocess included, as one hand-written kernel (`csrc/primitive_fields.cu`
through ops/fields.py), which repeats this arithmetic in its order and gives
the same bits; `ops/oracle.py` calls `preprocess` directly.

Matrix conventions: `viewmatrix` / `projmatrix` are column-vector matrices
(x_out = M @ [x, 1]).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .math3d import build_covariance

TILE_X = 16  # the CUDA rasterizer's BLOCK_X
TILE_Y = 16  # BLOCK_Y


class Preprocessed(NamedTuple):
    means2d: torch.Tensor        # [N, 2] pixel coords
    depths: torch.Tensor         # [N] view-space z
    conics: torch.Tensor         # [N, 3] inverse 2D covariance (a, b, c)
    radii: torch.Tensor          # [N] i32, 0 => culled
    rect_min: torch.Tensor       # [N, 2] i32 tile rect (inclusive)
    rect_max: torch.Tensor       # [N, 2] i32 tile rect (exclusive)
    tiles_touched: torch.Tensor  # [N] i32
    cov3d: torch.Tensor          # [N, 6]
    cov2d: torch.Tensor          # [N, 3]


def transform_point_4x3(p: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """(M @ [p, 1])[:3], written as elementwise math rather than a matmul
    (same rounding as the JAX package)."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    return torch.stack(
        [
            m[0, 0] * x + m[0, 1] * y + m[0, 2] * z + m[0, 3],
            m[1, 0] * x + m[1, 1] * y + m[1, 2] * z + m[1, 3],
            m[2, 0] * x + m[2, 1] * y + m[2, 2] * z + m[2, 3],
        ],
        dim=-1,
    )


def transform_point_4x4(p: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    return torch.stack(
        [
            m[0, 0] * x + m[0, 1] * y + m[0, 2] * z + m[0, 3],
            m[1, 0] * x + m[1, 1] * y + m[1, 2] * z + m[1, 3],
            m[2, 0] * x + m[2, 1] * y + m[2, 2] * z + m[2, 3],
            m[3, 0] * x + m[3, 1] * y + m[3, 2] * z + m[3, 3],
        ],
        dim=-1,
    )


def ndc2pix(v: torch.Tensor, size) -> torch.Tensor:
    return ((v + 1.0) * size - 1.0) * 0.5


def compute_cov2d(mean3d, cov3d, viewmatrix, focal_x, focal_y, tan_fovx,
                  tan_fovy, lim_tan_fovx=None, lim_tan_fovy=None):
    """EWA projection J W Sigma W^T J^T with the 1.3*tanfov frustum clamp
    and the +0.3 low-pass -> [..., 3] (a, b, c)."""
    t = transform_point_4x3(mean3d, viewmatrix)
    tx, ty = t[..., 0], t[..., 1]
    tz = torch.clamp(t[..., 2], min=0.2)
    limx = 1.3 * (lim_tan_fovx if lim_tan_fovx is not None else tan_fovx)
    limy = 1.3 * (lim_tan_fovy if lim_tan_fovy is not None else tan_fovy)
    txtz = tx / tz
    tytz = ty / tz
    tx = torch.clamp(txtz, -limx, limx) * tz
    ty = torch.clamp(tytz, -limy, limy) * tz

    inv_tz = 1.0 / tz
    j00 = focal_x * inv_tz
    j02 = -focal_x * tx * inv_tz * inv_tz
    j11 = focal_y * inv_tz
    j12 = -focal_y * ty * inv_tz * inv_tz

    W = viewmatrix[:3, :3]
    u0 = j00[..., None] * W[0] + j02[..., None] * W[2]
    u1 = j11[..., None] * W[1] + j12[..., None] * W[2]

    xx, xy, xz, yy, yz, zz = cov3d.unbind(-1)

    def quad(a, b):
        return (
            a[..., 0] * (xx * b[..., 0] + xy * b[..., 1] + xz * b[..., 2])
            + a[..., 1] * (xy * b[..., 0] + yy * b[..., 1] + yz * b[..., 2])
            + a[..., 2] * (xz * b[..., 0] + yz * b[..., 1] + zz * b[..., 2])
        )

    c00 = quad(u0, u0) + 0.3
    c01 = quad(u0, u1)
    c11 = quad(u1, u1) + 0.3
    return torch.stack([c00, c01, c11], dim=-1)


def tile_rect(means2d, radii, grid_x: int, grid_y: int,
              tile_x: int = TILE_X, tile_y: int = TILE_Y):
    """Tile bounding rect per Gaussian (the CUDA getRect)."""
    r = radii.to(means2d.dtype)
    mx, my = means2d[..., 0], means2d[..., 1]

    def fl(v, hi):
        return torch.clamp(torch.floor(v), 0, hi).to(torch.int32)

    rect_min = torch.stack([fl((mx - r) / tile_x, grid_x),
                            fl((my - r) / tile_y, grid_y)], dim=-1)
    rect_max = torch.stack([fl((mx + r + tile_x - 1) / tile_x, grid_x),
                            fl((my + r + tile_y - 1) / tile_y, grid_y)],
                           dim=-1)
    return rect_min, rect_max


def preprocess(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    rotations: torch.Tensor,
    viewmatrix: torch.Tensor,
    projmatrix: torch.Tensor,
    image_width: int,
    image_height: int,
    tan_fovx: float,
    tan_fovy: float,
    scale_modifier: float = 1.0,
    cov3d_precomp: torch.Tensor | None = None,
    lim_tan_fovx=None,
    lim_tan_fovy=None,
    tile_x: int = TILE_X,
    tile_y: int = TILE_Y,
    opacities: torch.Tensor | None = None,
) -> Preprocessed:
    """Vectorized per-Gaussian preprocess. With `opacities` given, the tile
    rect is tightened render-exactly to the band where alpha can reach
    1/255 (see the JAX counterpart's docstring); radii keep the CUDA
    square semantics."""
    grid_x = (image_width + tile_x - 1) // tile_x
    grid_y = (image_height + tile_y - 1) // tile_y
    focal_x = image_width / (2.0 * tan_fovx)
    focal_y = image_height / (2.0 * tan_fovy)

    p_view = transform_point_4x3(means3d, viewmatrix)
    in_front = p_view[..., 2] > 0.2

    p_hom = transform_point_4x4(means3d, projmatrix)
    denom = p_hom[..., 3] + 1e-7
    tiny = torch.where(denom < 0, torch.full_like(denom, -1e-7),
                       torch.full_like(denom, 1e-7))
    denom = torch.where(torch.abs(denom) < 1e-7, tiny, denom)
    p_w = 1.0 / denom
    p_proj = p_hom[..., :3] * p_w[..., None]

    if cov3d_precomp is not None:
        cov3d = cov3d_precomp
    else:
        cov3d = build_covariance(scales, rotations, scale_modifier)

    cov2d = compute_cov2d(means3d, cov3d, viewmatrix, focal_x, focal_y,
                          tan_fovx, tan_fovy, lim_tan_fovx, lim_tan_fovy)
    a, b, c = cov2d.unbind(-1)
    det = a * c - b * b
    det_ok = det != 0.0
    det_inv = torch.where(det_ok, 1.0 / torch.where(det_ok, det,
                                                    torch.ones_like(det)),
                          torch.zeros_like(det))
    conic = torch.stack([c * det_inv, -b * det_inv, a * det_inv], dim=-1)

    mid = 0.5 * (a + c)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius_f = torch.ceil(3.0 * torch.sqrt(torch.clamp(lam, min=0.0)))

    mean2d = torch.stack([ndc2pix(p_proj[..., 0], image_width),
                          ndc2pix(p_proj[..., 1], image_height)], dim=-1)
    rect_min, rect_max = tile_rect(mean2d, radius_f, grid_x, grid_y,
                                   tile_x, tile_y)
    area = (rect_max[..., 0] - rect_min[..., 0]) * (
        rect_max[..., 1] - rect_min[..., 1])

    visible = in_front & det_ok & (area > 0)
    radii = torch.where(visible, radius_f,
                        torch.zeros_like(radius_f)).to(torch.int32)

    if opacities is not None:
        op = opacities.reshape(-1).detach()
        mx = mean2d[..., 0].detach()
        my = mean2d[..., 1].detach()
        t_cut = torch.clamp(
            2.0 * torch.log(255.0 * torch.clamp(op, min=1e-12)), min=0.0)
        tighten = det > 0.0
        rfull = torch.where(visible, radius_f, torch.zeros_like(radius_f))
        rx = torch.sqrt(t_cut * torch.clamp(a.detach(), min=0.0)) \
            * (1.0 + 1e-5) + 1e-3
        ry = torch.sqrt(t_cut * torch.clamp(c.detach(), min=0.0)) \
            * (1.0 + 1e-5) + 1e-3
        rx = torch.where(tighten, torch.minimum(rfull, rx), rfull)
        ry = torch.where(tighten, torch.minimum(rfull, ry), rfull)
        tmin_x = torch.clamp(torch.floor((mx - rx) / tile_x), 0, grid_x)
        tmax_x = torch.clamp(torch.floor((mx + rx) / tile_x) + 1, 0, grid_x)
        tmin_y = torch.clamp(torch.floor((my - ry) / tile_y), 0, grid_y)
        tmax_y = torch.clamp(torch.floor((my + ry) / tile_y) + 1, 0, grid_y)
        tmin = torch.stack([tmin_x, tmin_y], dim=-1).to(torch.int32)
        tmax = torch.stack([tmax_x, tmax_y], dim=-1).to(torch.int32)
        rect_min = torch.maximum(rect_min, tmin)
        rect_max = torch.minimum(rect_max, tmax)
        dead = (op * 255.0 < 1.0) & tighten
        rect_max = torch.where(dead[..., None], rect_min, rect_max)
        rect_max = torch.maximum(rect_max, rect_min)
        area = (rect_max[..., 0] - rect_min[..., 0]) * (
            rect_max[..., 1] - rect_min[..., 1])

    tiles = torch.where(visible, area, torch.zeros_like(area)).to(torch.int32)
    return Preprocessed(
        means2d=mean2d,
        depths=p_view[..., 2],
        conics=conic,
        radii=radii,
        rect_min=rect_min,
        rect_max=rect_max,
        tiles_touched=tiles,
        cov3d=cov3d,
        cov2d=cov2d,
    )
