"""Reference rasterizer ("the oracle"): O(N x H x W), written on torch ops
with autograd.

Counterpart of `gaussianrpg_tpu/ops/oracle.py`, an independent reference
of the port's own beside `ops/rasterize.py`: every Gaussian is tested
against every pixel of every tile, with no binning, no pair lists and no
kernel. The tests hold it to the JAX oracle and to the port's
`rasterize`; it is never on a card path.

  preprocess  `ops/projection.preprocess` (`forward.cu:155-256`)
  order       one global stable sort by (depth, id): restricted to any
              tile it is the CUDA per-tile order (depth asc, id asc)
  blend       closed-form cumprod (`forward.cu:410-454`): skip if
              power > 0 or alpha < 1/255, stop the pixel before a
              Gaussian that would drive T below 1e-4, alpha =
              min(0.99, opacity * exp(power)) with the gradient of the
              unclamped value (the CUDA backward ignores the clamp,
              `backward.cu:618,638`), out_color = C + T_final * bg
  backward    torch autograd over the frozen contributor set

`means2d_offset` [N, 2] reproduces the reference's dummy screenspace
tensor: its gradient is dL/d(pixel mean) scaled by (0.5 W, 0.5 H).
"""
from __future__ import annotations

import torch

from .projection import TILE_X, TILE_Y, preprocess
from .rasterize import RasterOut
from .sh import sh_to_rgb_clamped


def _straight_through_min(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Value min(x, cap); gradient of identity."""
    return x + (torch.clamp(x, max=cap) - x).detach()


def _blend_tiles(tiles, means2d, conics, opacities, feats, rect_min,
                 rect_max, valid, bg_feat):
    """Blend tiles [T, 2] (tx, ty) against the whole depth-sorted list.
    Returns [T, F + 1, TILE_Y, TILE_X]: features, then the weight
    (alpha)."""
    dev = means2d.device
    tx, ty = tiles[:, 0], tiles[:, 1]
    ar_x = torch.arange(TILE_X, device=dev)
    ar_y = torch.arange(TILE_Y, device=dev)
    px = (tx[:, None, None] * TILE_X + ar_x[None, None, :]).expand(
        -1, TILE_Y, TILE_X)
    py = (ty[:, None, None] * TILE_Y + ar_y[None, :, None]).expand(
        -1, TILE_Y, TILE_X)
    # [T, P, 2], row-major (y, x) like the CUDA pix_id
    pix = torch.stack([px.reshape(len(tiles), -1),
                       py.reshape(len(tiles), -1)], -1).to(means2d.dtype)

    covers = ((rect_min[None, :, 0] <= tx[:, None])
              & (tx[:, None] < rect_max[None, :, 0])
              & (rect_min[None, :, 1] <= ty[:, None])
              & (ty[:, None] < rect_max[None, :, 1])
              & valid[None, :])                             # [T, N]

    d = means2d[None, :, None, :] - pix[:, None, :, :]     # [T, N, P, 2]
    dx, dy = d[..., 0], d[..., 1]
    a, b, c = conics[:, 0:1], conics[:, 1:2], conics[:, 2:3]
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy  # [T, N, P]
    alpha_raw = opacities[:, None] * torch.exp(power)
    alpha = _straight_through_min(alpha_raw, 0.99)

    # frozen masks (no gradient flow), matching the CUDA skip rules
    with torch.no_grad():
        a_sg = torch.clamp(alpha_raw, max=0.99)
        skip = ((power > 0.0) | (alpha_raw < (1.0 / 255.0))
                | ~covers[:, :, None])
        a_eff = torch.where(skip, torch.zeros_like(a_sg), a_sg)
        t_excl_sg = torch.cat([torch.ones_like(a_eff[:, :1]),
                               torch.cumprod(1.0 - a_eff, dim=1)[:, :-1]],
                              dim=1)
        stop = ~skip & (t_excl_sg * (1.0 - a_eff) < 1e-4)
        stopped = torch.cumsum(stop.to(torch.int32), dim=1) > 0
        contrib = ~skip & ~stopped                          # [T, N, P]

    # differentiable blend over the frozen contributor set
    a_used = torch.where(contrib, alpha, torch.zeros_like(alpha))
    t_incl = torch.cumprod(1.0 - a_used, dim=1)
    t_excl = torch.cat([torch.ones_like(t_incl[:, :1]), t_incl[:, :-1]],
                       dim=1)
    w = a_used * t_excl                                     # [T, N, P]
    out_feat = torch.einsum("tnp,nf->tfp", w, feats)        # [T, F, P]
    weight = torch.sum(w, dim=1)                            # [T, P]
    t_final = t_incl[:, -1]                                 # [T, P]
    out_feat = out_feat + t_final[:, None, :] * bg_feat[None, :, None]
    out = torch.cat([out_feat, weight[:, None, :]], dim=1)
    return out.reshape(len(tiles), out.shape[1], TILE_Y, TILE_X)


def rasterize_oracle(
    means3d: torch.Tensor,
    opacities: torch.Tensor,
    *,
    camera,
    bg_color: torch.Tensor,
    colors: torch.Tensor | None = None,
    shs: torch.Tensor | None = None,
    sh_degree: int = 0,
    semantics: torch.Tensor | None = None,
    scales: torch.Tensor | None = None,
    rotations: torch.Tensor | None = None,
    cov3d_precomp: torch.Tensor | None = None,
    scale_modifier: float = 1.0,
    means2d_offset: torch.Tensor | None = None,
    tile_chunk: int = 4,
) -> RasterOut:
    """Render with the oracle, on the inputs' device; differentiable in
    every float input. opacities [N] post-sigmoid; colors [N, 3] or shs
    [N, K, 3]; semantics [N, S] optional; means2d_offset [N, 2] zeros
    whose gradient is the NDC-scale viewspace gradient. `tile_chunk`
    tiles are blended at a time."""
    H, W = camera.height, camera.width
    grid_x = (W + TILE_X - 1) // TILE_X
    grid_y = (H + TILE_Y - 1) // TILE_Y
    n = means3d.shape[0]
    dev, dt = means3d.device, means3d.dtype
    if scales is None:
        scales = torch.ones((n, 3), dtype=dt, device=dev)
    if rotations is None:
        rotations = torch.cat([torch.ones((n, 1), dtype=dt, device=dev),
                               torch.zeros((n, 3), dtype=dt, device=dev)],
                              -1)
    pre = preprocess(means3d, scales, rotations, camera.viewmatrix,
                     camera.projmatrix, W, H, camera.tan_fovx,
                     camera.tan_fovy, scale_modifier, cov3d_precomp)

    if colors is None:
        assert shs is not None
        dirs = means3d - camera.cam_center
        dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
        colors, _ = sh_to_rgb_clamped(sh_degree, shs, dirs)

    means2d = pre.means2d
    if means2d_offset is not None:
        means2d = means2d + means2d_offset * torch.tensor(
            [0.5 * W, 0.5 * H], dtype=means2d.dtype, device=dev)
    visible = pre.radii > 0
    sort_key = torch.where(visible, pre.depths.detach(),
                           torch.full_like(pre.depths, float("inf")))
    order = torch.argsort(sort_key, stable=True)

    feats = [colors, pre.depths[:, None]]
    s_ch = 0
    if semantics is not None and semantics.shape[-1] > 0:
        feats.append(semantics)
        s_ch = semantics.shape[-1]
    feats = torch.cat(feats, dim=-1)                        # [N, 3+1+S]
    bg_feat = torch.cat([bg_color.reshape(3).to(dt),
                         torch.zeros(1 + s_ch, dtype=dt, device=dev)])

    gathered = [x[order] for x in (means2d, pre.conics,
                                   opacities.reshape(-1), feats,
                                   pre.rect_min, pre.rect_max, visible)]
    ty, tx = torch.meshgrid(torch.arange(grid_y, device=dev),
                            torch.arange(grid_x, device=dev), indexing="ij")
    tiles = torch.stack([tx.reshape(-1), ty.reshape(-1)], -1)  # (ty, tx)
    out_tiles = torch.cat([_blend_tiles(tiles[i:i + tile_chunk], *gathered,
                                        bg_feat)
                           for i in range(0, len(tiles), tile_chunk)])
    f_tot = out_tiles.shape[1]
    img = (out_tiles.reshape(grid_y, grid_x, f_tot, TILE_Y, TILE_X)
           .permute(2, 0, 3, 1, 4)
           .reshape(f_tot, grid_y * TILE_Y, grid_x * TILE_X))[:, :H, :W]
    return RasterOut(
        color=img[0:3], depth=img[3:4], semantic=img[4:4 + s_ch],
        alpha=img[4 + s_ch:5 + s_ch], radii=pre.radii, means2d=pre.means2d,
        overflow=torch.zeros((), dtype=torch.bool, device=dev),
        n_pairs=torch.zeros((), dtype=torch.int32, device=dev))
