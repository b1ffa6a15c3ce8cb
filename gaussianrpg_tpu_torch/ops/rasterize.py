"""Rasterizer entry point: primitive stage -> depth order -> tile binning
-> pair gather -> blend (kernel B forward, kernel C backward).

Counterpart of `gaussianrpg_tpu/ops/rasterize.py`: same field-column
layout, same binning inputs on both the emission and the marker path, same
outputs. As in JAX, train mode is
"gradient hooks given": `means2d_offset` (its gradient is the NDC-scale
viewspace gradient) and `absgrad_sink` (its gradient is the AbsGS
statistic, riding the F_RADIUS column). In train mode every pair gather
goes through an autograd Function whose backward is the sort-free segment
sum (`_PairGather`, `_PairGatherDerive`, `_PermTake`) instead of the
`index_add_` scatter that autograd of `index_select` would use; the
preprocess, SH and field assembly are differentiated by autograd. On the
card an eval call's primitive stage is one hand-written kernel,
`csrc/primitive_fields.cu` (ops/fields.py), and both row takes of the
field table, the marker path's depth-order take and the pair gather, run
the hand-written row gather `csrc/gather_rows.cu` (ops/gather.py), which
writes the padding slots' rows as zeros.

Under a profiler the stages record the spans `raster.fields`
(`rasterize`'s primitive stage), `raster.sort` (depth order), `raster.bin`
(tile binning), `raster.gather` (the pair gather) and `raster.blend`
(utils/spans.py). An eval call on the card replays one CUDA graph of the
whole path (ops/raster_graph.py): it records one span, `raster.graph`,
and none of those.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..parallel.collectives import Axis, gather_field_rows
from ..utils.device import on_device, resolve_device
from ..utils.spans import span
from . import binning, fields, gather, raster_graph
from .raster_graph import eager, graph_counts  # noqa: F401  (re-exported)
from .blend import NF_BASE, blend_pairs
from .projection import TILE_X, TILE_Y, preprocess, transform_point_4x3
from .sh import sh_to_rgb_clamped


def _round_up(x, m):
    return (x + m - 1) // m * m


DERIVE_GM = True  # emission path in train mode: derive the expansion index
                  # in the gather's backward instead of riding it through
                  # the sort (False = the ridden path, for cross-checks)


class RasterOut(NamedTuple):
    color: torch.Tensor      # [3, H, W]
    depth: torch.Tensor      # [1, H, W] alpha-weighted
    alpha: torch.Tensor      # [1, H, W]
    semantic: torch.Tensor   # [S, H, W]
    radii: torch.Tensor      # [N] i32
    means2d: torch.Tensor    # [N, 2]
    overflow: torch.Tensor   # [] bool: pair capacity exceeded
    n_pairs: torch.Tensor    # [] i32


class FieldSet(NamedTuple):
    """Per-Gaussian pair-ready fields (output of the O(N) primitive
    stage)."""

    fields: torch.Tensor     # [N, NF] blend field columns
    rect_min: torch.Tensor   # [N, 2] i32 tile rect
    rect_max: torch.Tensor   # [N, 2]
    radii: torch.Tensor      # [N] i32 (0 = culled)
    depths: torch.Tensor     # [N]
    means2d: torch.Tensor    # [N, 2]
    s_ch: int
    tile_x: int = TILE_X
    tile_y: int = TILE_Y


def _take8(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row gather."""
    return x.index_select(0, idx.long())


SCAN_BLOCK = 1024  # rows of one block of the two-level prefix sum


def _column_prefix_sums(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums of each column of x [P, C] over all P rows,
    returned as [C, P]. Every column is cut into blocks of SCAN_BLOCK
    rows, each block is scanned, and each block gets the running total of
    the blocks before it: PyTorch's scan of a tall column runs one
    sequential thread per column on the card (11 s for [32M, 16] down
    dim 0), the blocked form is many short independent scans, and
    deterministic. The same form runs on every device."""
    p, c = x.shape
    xt = x.t()
    if p % SCAN_BLOCK:
        xt = torch.cat([xt, xt.new_zeros((c, SCAN_BLOCK - p % SCAN_BLOCK))],
                       dim=1)
    blocks = xt.contiguous().view(c, -1, SCAN_BLOCK).cumsum(dim=2)
    totals = blocks[:, :-1, -1].cumsum(dim=1)      # through each block
    blocks[:, 1:] += totals[:, :, None]
    return blocks.view(c, -1)[:, :p]


def _segment_sum_expansion(d_gm, seg_offs, seg_area):
    """Per-gaussian sums of contiguous expansion-order segments: one f32
    prefix sum over the whole capacity and the difference at the segment
    boundaries (segments are contiguous: offs[g] + area[g] == offs[g+1])."""
    p = d_gm.shape[0]
    ends = torch.clamp(torch.cat([seg_offs, (seg_offs[-1]
                                             + seg_area[-1])[None]]), max=p)
    cs = _column_prefix_sums(d_gm)                 # [NF, P]
    at = cs.index_select(1, torch.clamp(ends - 1, min=0).long())
    bounds = torch.where(ends[None, :] > 0, at, torch.zeros_like(at))
    return (bounds[:, 1:] - bounds[:, :-1]).t().contiguous()   # [N, NF]


def _unpermute_and_segment_sum(d_gdata, valid_f, pair_gm, seg_offs,
                               seg_area):
    """Tile-major pair cotangents -> per-gaussian sums: invert the slot
    permutation with a stable sort of (gm, slot) (padding keyed last),
    gather into expansion order, segment-sum."""
    gm_key = torch.where(pair_gm >= 0, pair_gm,
                         torch.full_like(pair_gm, 0x7FFFFFFF))
    pos = torch.sort(gm_key, stable=True).indices
    d_tm = d_gdata * valid_f[:, None]
    return _segment_sum_expansion(d_tm.index_select(0, pos), seg_offs,
                                  seg_area)


class _PairGather(torch.autograd.Function):
    """Pair rows [P, NF] from the field table whose backward is the
    sort-free segment sum over the ridden expansion index `pair_gm`
    (`rasterize._pair_gather`)."""

    @staticmethod
    def forward(ctx, fields, src, valid_f, pair_gm, seg_offs, seg_area):
        ctx.save_for_backward(valid_f, pair_gm, seg_offs, seg_area)
        return _take8(fields, src) * valid_f[:, None]

    @staticmethod
    def backward(ctx, d_gdata):
        valid_f, pair_gm, seg_offs, seg_area = ctx.saved_tensors
        d = _unpermute_and_segment_sum(d_gdata.contiguous(), valid_f,
                                       pair_gm, seg_offs, seg_area)
        return d, None, None, None, None, None


def derive_pair_gm(packed, pair_tile, ntx: int):
    """Expansion index of each slot from the exact-int f32 columns
    (x0*2048 + y0, rect width, seg offset) riding its row and its tile:
    gm = offs + (ty - y0)*rw + (tx - x0); -1 for padding."""
    xy = packed[:, 0].to(torch.int32)
    x0 = xy >> 11
    y0 = xy & 0x7FF
    rw = packed[:, 1].to(torch.int32)
    offs = packed[:, 2].to(torch.int32)
    ty = torch.div(pair_tile, ntx, rounding_mode="floor")
    tx = pair_tile - ty * ntx
    gm = offs + (ty - y0) * rw + (tx - x0)
    return torch.where(pair_tile >= 0, gm, torch.full_like(gm, -1))


class _PairGatherDerive(torch.autograd.Function):
    """Pair gather whose backward derives gm instead of consuming a ridden
    one (`rasterize._pair_gather_derive_fn`): the rect and segment offset
    ride the wide row gather as exact-int f32 columns [col0, col0+3)."""

    @staticmethod
    def forward(ctx, fields_ext, src, valid_f, pair_tile, seg_offs,
                seg_area, ntx, col0):
        out = _take8(fields_ext, src) * valid_f[:, None]
        packed = out[:, col0:col0 + 3].detach().clone()
        ctx.save_for_backward(valid_f, pair_tile, packed, seg_offs, seg_area)
        ctx.ntx = ntx
        return out

    @staticmethod
    def backward(ctx, d_gdata):
        valid_f, pair_tile, packed, seg_offs, seg_area = ctx.saved_tensors
        gm = derive_pair_gm(packed, pair_tile, ctx.ntx)
        d = _unpermute_and_segment_sum(d_gdata.contiguous(), valid_f, gm,
                                       seg_offs, seg_area)
        return d, None, None, None, None, None, None, None


class _PermTake(torch.autograd.Function):
    """Row gather by a permutation whose backward is the gather by the
    inverse permutation (`rasterize._perm_take`)."""

    @staticmethod
    def forward(ctx, x, perm, inv_perm):
        ctx.save_for_backward(inv_perm)
        return x.index_select(0, perm)

    @staticmethod
    def backward(ctx, ct):
        (inv_perm,) = ctx.saved_tensors
        return ct.index_select(0, inv_perm), None, None


def _default_geometry(means3d, scales, rotations):
    n = means3d.shape[0]
    if scales is None:
        scales = torch.ones((n, 3), dtype=means3d.dtype, device=means3d.device)
    if rotations is None:
        rotations = torch.zeros((n, 4), dtype=means3d.dtype,
                                device=means3d.device)
        rotations[:, 0] = 1.0
    return scales, rotations


def mark_visible(means3d: torch.Tensor, camera) -> torch.Tensor:
    """Frustum-culling mask: view depth beyond the 0.2 near plane."""
    return transform_point_4x3(means3d, camera.viewmatrix)[:, 2] > 0.2


def visible_filter(means3d, *, camera, scales=None, rotations=None,
                   cov3d_precomp=None, scale_modifier: float = 1.0):
    """(radii, means2d) without rendering."""
    scales, rotations = _default_geometry(means3d, scales, rotations)
    pre = preprocess(means3d, scales, rotations, camera.viewmatrix,
                     camera.projmatrix, camera.width, camera.height,
                     camera.tan_fovx, camera.tan_fovy, scale_modifier,
                     cov3d_precomp, camera.lim_tan_fovx, camera.lim_tan_fovy)
    return pre.radii, pre.means2d


def primitive_fields(
    means3d: torch.Tensor,
    opacities: torch.Tensor,
    *,
    camera,
    colors: torch.Tensor | None = None,
    shs: torch.Tensor | None = None,
    sh_degree: int = 0,
    semantics: torch.Tensor | None = None,
    scales: torch.Tensor | None = None,
    rotations: torch.Tensor | None = None,
    cov3d_precomp: torch.Tensor | None = None,
    scale_modifier: float = 1.0,
    means2d_offset: torch.Tensor | None = None,
    absgrad_sink: torch.Tensor | None = None,
    active_mask: torch.Tensor | None = None,
    tile_x: int = TILE_X,
    tile_y: int = TILE_Y,
    tight_rect: bool = True,
) -> FieldSet:
    """O(N) per-primitive stage: preprocess + SH + field-column assembly.
    The hooks (zeros) enter the mean columns (`means2d_offset`, scaled to
    pixels by the physical image size) and the radius column
    (`absgrad_sink`, whose value the blend never reads).

    Two routes by what the call holds, sharing no logic: on the card, a
    call that autograd does not record and that passes neither hook runs
    the hand-written kernel (ops/fields.py); every other call, training
    and every CPU tensor, the PyTorch composition
    (`primitive_fields_plain`). Both give the same bits. Spherical
    harmonics are evaluated first on either route."""
    opacities = opacities.reshape(-1)
    scales, rotations = _default_geometry(means3d, scales, rotations)
    if colors is None:
        assert shs is not None
        dirs = means3d - camera.cam_center
        dirs = dirs * torch.rsqrt(torch.clamp(
            torch.sum(dirs * dirs, -1, keepdim=True), min=1e-24))
        colors, _ = sh_to_rgb_clamped(sh_degree, shs, dirs)
    if semantics is not None and semantics.shape[-1] == 0:
        semantics = None
    kw = dict(camera=camera, colors=colors, semantics=semantics,
              scales=scales, rotations=rotations,
              cov3d_precomp=cov3d_precomp, scale_modifier=scale_modifier,
              active_mask=active_mask, tile_x=tile_x, tile_y=tile_y,
              tight_rect=tight_rect)
    recorded = (means3d, opacities, colors, semantics, scales, rotations,
                cov3d_precomp, camera.viewmatrix, camera.projmatrix)
    if fields.engages(means3d, recorded, (means2d_offset, absgrad_sink)):
        out = fields.primitive_fields(means3d, opacities, **kw)
    else:
        out = primitive_fields_plain(means3d, opacities,
                                     means2d_offset=means2d_offset,
                                     absgrad_sink=absgrad_sink, **kw)
    return FieldSet(*out, s_ch=0 if semantics is None
                    else semantics.shape[-1], tile_x=tile_x, tile_y=tile_y)


def primitive_fields_plain(means3d, opacities, *, camera, colors,
                           semantics, scales, rotations, cov3d_precomp,
                           scale_modifier, means2d_offset, absgrad_sink,
                           active_mask, tile_x, tile_y, tight_rect):
    """The primitive stage as a PyTorch composition (the route of every
    call but a card's eval call; see `primitive_fields`): (fields,
    rect_min, rect_max, radii, depths, means2d) of a FieldSet, from
    `opacities` [N], `colors` [N, 3] and `semantics` [N, S] or None."""
    H, W = camera.height, camera.width
    n = means3d.shape[0]
    pre = preprocess(
        means3d, scales, rotations, camera.viewmatrix, camera.projmatrix,
        W, H, camera.tan_fovx, camera.tan_fovy, scale_modifier,
        cov3d_precomp, camera.lim_tan_fovx, camera.lim_tan_fovy,
        tile_x=tile_x, tile_y=tile_y,
        opacities=opacities if tight_rect else None)

    means2d = pre.means2d
    if means2d_offset is not None:
        fw = camera.full_width or W
        fh = camera.full_height or H
        means2d = means2d + means2d_offset * torch.tensor(
            [0.5 * fw, 0.5 * fh], dtype=means2d.dtype, device=means2d.device)

    radii = pre.radii
    if active_mask is not None:
        radii = torch.where(active_mask, radii, torch.zeros_like(radii))

    s_ch = 0 if semantics is None else semantics.shape[-1]
    sem_list = [] if semantics is None else [semantics]
    radius_col = radii.to(torch.float32)
    if absgrad_sink is not None:
        radius_col = radius_col + absgrad_sink
    fields = torch.cat(
        [means2d, pre.conics, opacities[:, None], colors,
         pre.depths[:, None], radius_col[:, None]] + sem_list,
        dim=1)
    nf_cols = _round_up(NF_BASE + s_ch, 8)
    if fields.shape[1] < nf_cols:
        fields = torch.cat(
            [fields, torch.zeros((n, nf_cols - fields.shape[1]),
                                 dtype=fields.dtype, device=fields.device)],
            dim=1)
    return (fields, pre.rect_min, pre.rect_max, radii, pre.depths,
            pre.means2d)


def pair_rows(
    fs: FieldSet,
    *,
    width: int,
    height: int,
    capacity: int,
    train_mode: bool = False,
    sub_chunks: int | None = None,
    tail_cap: int | None = None,
    big_cap: int | None = None,
    emit_k: int | None = None,
):
    """Depth order, tile binning and pair gather: (gdata [P_pad, NF],
    PairLists), the blend kernel's inputs. In train mode the gathers carry
    the segment-sum backward."""
    H, W = height, width
    n, nf = fs.fields.shape
    dev = fs.fields.device
    s_ch = fs.s_ch
    col0 = NF_BASE + s_ch
    ntx, nty = binning.tile_grid_dims(W, H, fs.tile_x, fs.tile_y)
    emit = binning.emit_active(n, ntx * nty)
    with span("raster.sort"):
        visible = fs.radii > 0
        key = torch.where(visible, fs.depths.detach(),
                          torch.full_like(fs.depths, float("inf")))
        order = torch.argsort(key, stable=True)
        if emit:
            # emission path: the sort key carries each gaussian's depth
            # rank, so the field table stays in original order
            rank = torch.empty_like(order)
            rank[order] = torch.arange(n, device=dev)

    if emit:
        with span("raster.bin"):
            zero = torch.zeros_like(fs.rect_min)
            rect_min = torch.where(visible[:, None], fs.rect_min, zero)
            rect_max = torch.where(visible[:, None], fs.rect_max, zero)
            # derive-gm: with 3 spare field columns the expansion index is
            # rebuilt in the gather's backward instead of riding the sort
            derive = (DERIVE_GM and train_mode and nf - col0 >= 3
                      and ntx < 2048 and nty < 2048
                      and capacity < (1 << 24))
            lists = binning.build_pair_lists(
                rect_min, rect_max, visible, W, H, capacity,
                ride_gm=train_mode, tile_x=fs.tile_x, tile_y=fs.tile_y,
                sub_chunks=sub_chunks, rank=rank, tail_cap=tail_cap,
                big_cap=big_cap, derive_gm=derive, emit_k=emit_k)
        fields_sorted = fs.fields
        if derive and lists.pair_tile is not None:
            packed = torch.stack(
                [(rect_min[:, 0] * 2048 + rect_min[:, 1]).to(fs.fields.dtype),
                 torch.clamp(rect_max[:, 0] - rect_min[:, 0], min=0).to(
                     fs.fields.dtype),
                 lists.seg_offs.to(fs.fields.dtype)], dim=1)
            fields_sorted = torch.cat(
                [fs.fields[:, :col0], packed, fs.fields[:, col0 + 3:]],
                dim=1)
    else:
        # marker path: the tile rect rides the depth-sorted row take in the
        # field table's spare columns (or four appended ones)
        with span("raster.sort"):
            rectf = torch.cat([fs.rect_min, fs.rect_max], dim=1).to(
                fs.fields.dtype)
            rectf = torch.where(visible[:, None], rectf,
                                torch.zeros_like(rectf))
            spare = nf - (NF_BASE + s_ch)
            if spare >= 4:
                rect_col = nf - 4
                ext = torch.cat([fs.fields[:, :rect_col], rectf], dim=1)
            else:
                rect_col = nf
                ext = torch.cat([fs.fields, rectf], dim=1)
                pad = -ext.shape[1] % 8
                if pad:
                    ext = torch.cat([ext, torch.zeros(
                        (n, pad), dtype=ext.dtype, device=dev)], dim=1)
            if train_mode:
                inv_order = torch.empty_like(order)
                inv_order[order] = torch.arange(n, device=dev)
                ext_sorted = _PermTake.apply(ext, order, inv_order)
            else:
                ext_sorted = gather.gather_rows(ext, order.to(torch.int32))
            rect_s = ext_sorted[:, rect_col:rect_col + 4].detach().to(
                torch.int32)
            rect_min_s, rect_max_s = rect_s[:, 0:2], rect_s[:, 2:4]
            visible_s = (rect_max_s[:, 0] > rect_min_s[:, 0]) & (
                rect_max_s[:, 1] > rect_min_s[:, 1])
            fields_sorted = ext_sorted if spare >= 4 else ext_sorted[:, :nf]
        with span("raster.bin"):
            lists = binning.build_pair_lists(
                rect_min_s, rect_max_s, visible_s, W, H, capacity,
                ride_gm=train_mode, tile_x=fs.tile_x, tile_y=fs.tile_y,
                sub_chunks=sub_chunks)

    with span("raster.gather"):
        if not train_mode:
            return gather.gather_rows(fields_sorted, lists.pair_src), lists
        src = torch.clamp(lists.pair_src, min=0)
        valid = lists.pair_valid.to(fs.fields.dtype)
        if lists.pair_tile is not None:
            gdata = _PairGatherDerive.apply(fields_sorted, src, valid,
                                            lists.pair_tile, lists.seg_offs,
                                            lists.seg_area, ntx, col0)
        else:
            gdata = _PairGather.apply(fields_sorted, src, valid,
                                      lists.pair_gm, lists.seg_offs,
                                      lists.seg_area)
    return gdata, lists


def blend_fields(
    fs: FieldSet,
    *,
    width: int,
    height: int,
    bg_color: torch.Tensor,
    capacity: int,
    train_mode: bool = False,
    sub_chunks: int | None = None,
    stat_width: int | None = None,
    stat_height: int | None = None,
    tail_cap: int | None = None,
    big_cap: int | None = None,
    emit_k: int | None = None,
) -> RasterOut:
    """O(P) tile stage: depth order, tile binning, pair gather, blend."""
    s_ch = fs.s_ch
    gdata, lists = pair_rows(fs, width=width, height=height,
                             capacity=capacity, train_mode=train_mode,
                             sub_chunks=sub_chunks, tail_cap=tail_cap,
                             big_cap=big_cap, emit_k=emit_k)
    with span("raster.blend"):
        planes = blend_pairs(gdata, lists,
                             bg_color.reshape(3).to(torch.float32),
                             width=width, height=height, s_ch=s_ch,
                             stat_width=stat_width, stat_height=stat_height)
    return RasterOut(
        color=planes[0:3],
        depth=planes[3:4],
        alpha=planes[4:5],
        semantic=planes[5:5 + s_ch],
        radii=fs.radii,
        means2d=fs.means2d,
        overflow=lists.overflowed,
        n_pairs=torch.maximum(lists.raw_total, lists.padded_total),
    )


def suggest_capacity(fs: FieldSet, *, width: int, height: int,
                     slack: float = 1.25, sub_chunks: int = 1,
                     quantum: int = 65536) -> int:
    """Right-size the static pair capacity: exact aligned per-tile counts
    (2D corner deltas + prefix sums, no pair expansion) times `slack`,
    rounded up to `quantum` (65536 spares the marker fills a padding
    copy before kernel A)."""
    visible = fs.radii > 0
    empty = ~visible | (fs.rect_max[:, 0] <= fs.rect_min[:, 0]) | (
        fs.rect_max[:, 1] <= fs.rect_min[:, 1])
    zero = torch.zeros_like(fs.rect_min)
    rect_min = torch.where(empty[:, None], zero, fs.rect_min).long()
    rect_max = torch.where(empty[:, None], zero, fs.rect_max).long()
    ntx, nty = binning.tile_grid_dims(width, height, fs.tile_x, fs.tile_y)
    delta = torch.zeros((nty + 1) * (ntx + 1), dtype=torch.int64,
                        device=fs.fields.device)
    x0, y0 = rect_min[:, 0], rect_min[:, 1]
    x1, y1 = rect_max[:, 0], rect_max[:, 1]
    w1 = ntx + 1
    ones = torch.ones_like(x0)
    delta.index_add_(0, y0 * w1 + x0, ones)
    delta.index_add_(0, y0 * w1 + x1, -ones)
    delta.index_add_(0, y1 * w1 + x0, -ones)
    delta.index_add_(0, y1 * w1 + x1, ones)
    counts = torch.cumsum(torch.cumsum(delta.reshape(nty + 1, ntx + 1), 0),
                          1)[:nty, :ntx]
    align = binning.G_CHUNK * sub_chunks
    padded_total = int(torch.sum((counts + align - 1) // align * align))
    cap = int(padded_total * slack)
    q = max(quantum, align)
    q = q + (-q % align)
    return max(cap + (-cap % q), q)


class BinningSizes(NamedTuple):
    capacity: int
    tail_cap: int | None
    big_cap: int | None
    emit_k: int | None


def suggest_binning_sizes(fs: FieldSet, *, width: int, height: int,
                          slack: float = 1.25, sub_chunks: int = 1,
                          quantum: int = 65536) -> BinningSizes:
    """Right-size the pair capacity and, on the emission path, the tail
    buffers from the scene's measured rect areas."""
    cap = suggest_capacity(fs, width=width, height=height, slack=slack,
                           sub_chunks=sub_chunks, quantum=quantum)
    n = fs.radii.shape[0]
    ntx, nty = binning.tile_grid_dims(width, height, int(fs.tile_x),
                                      int(fs.tile_y))
    if not binning.emit_active(n, ntx * nty):
        return BinningSizes(cap, None, None, None)
    visible = fs.radii > 0
    rw = torch.clamp(fs.rect_max[:, 0] - fs.rect_min[:, 0], min=0)
    rh = torch.clamp(fs.rect_max[:, 1] - fs.rect_min[:, 1], min=0)
    area = torch.where(visible, rw * rh, torch.zeros_like(rw)).cpu().numpy()
    k = binning.EMIT_K
    tail_total = int(np.maximum(area - k, 0).sum())
    n_big = int((area > k).sum())
    tail_cap = max(8192, int(tail_total * slack)
                   + (-int(tail_total * slack) % 8192))
    big_cap = min(n, max(1024, int(n_big * slack)
                         + (-int(n_big * slack) % 1024)))
    return BinningSizes(cap, tail_cap, big_cap, k)


def rasterize(
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
    absgrad_sink: torch.Tensor | None = None,
    active_mask: torch.Tensor | None = None,
    capacity: int = 1 << 19,
    tile_x: int = TILE_X,
    tile_y: int = TILE_Y,
    tight_rect: bool = True,
    sub_chunks: int | None = None,
    tail_cap: int | None = None,
    big_cap: int | None = None,
    emit_k: int | None = None,
    model_axis: Axis | None = None,
    device=None,
) -> RasterOut:
    """Render Gaussians, differentiable in every float input. means3d
    [N,3]; opacities [N] or [N,1] (activated); colors [N,3] or shs
    [N,K,3]; semantics [N,S]; scales [N,3] + rotations [N,4] or
    cov3d_precomp [N,6]. Training passes the hooks, zeros
    `means2d_offset` [N,2] and `absgrad_sink` [N]: their gradients are
    the NDC viewspace gradient and the AbsGS statistic. `capacity` is the
    static padded pair capacity: check `overflow` and grow it. All tensors
    must lie on `device` (CUDA unless given).

    `model_axis` (a mesh's `model` axis): shard the O(N) primitive stage
    over the axis's ranks. Each runs it on its N / size slice of the
    (replicated) inputs, the field rows are all-gathered in rank order
    before the O(P) tile stage, and under autograd the gather's backward
    is a reduce-scatter that hands each rank its slice's cotangents. N
    must divide by the axis's size.

    An eval call on the card runs through one CUDA graph of the whole
    path, captured on the second consecutive call with the same key and
    replayed after (ops/raster_graph.py): same kernels, same outputs,
    each returned tensor the caller's own."""
    call = {k: v for k, v in locals().items() if k != "device"}
    dev = resolve_device(device)
    if not on_device(means3d, dev):
        raise ValueError(f"rasterize: inputs on {means3d.device}, "
                         f"device is {dev}")
    return raster_graph.run(call, dev, _rasterize)


def _rasterize(*, means3d, opacities, camera, bg_color, colors, shs,
               sh_degree, semantics, scales, rotations, cov3d_precomp,
               scale_modifier, means2d_offset, absgrad_sink, active_mask,
               capacity, tile_x, tile_y, tight_rect, sub_chunks, tail_cap,
               big_cap, emit_k, model_axis) -> RasterOut:
    """The eager path of `rasterize` (its arguments but `device`)."""
    train_mode = means2d_offset is not None or absgrad_sink is not None
    per_g = dict(means3d=means3d, opacities=opacities.reshape(-1),
                 colors=colors, shs=shs, semantics=semantics, scales=scales,
                 rotations=rotations, cov3d_precomp=cov3d_precomp,
                 means2d_offset=means2d_offset, absgrad_sink=absgrad_sink,
                 active_mask=active_mask)
    if model_axis is not None:
        n = means3d.shape[0]
        if n % model_axis.size:
            raise ValueError(f"{n} Gaussians do not divide over a "
                             f"{model_axis.size}-rank axis")
        shard = n // model_axis.size
        lo = model_axis.index * shard
        per_g = {k: None if v is None else v[lo:lo + shard]
                 for k, v in per_g.items()}
    with span("raster.fields"):
        fs = primitive_fields(
            per_g.pop("means3d"), per_g.pop("opacities"), camera=camera,
            sh_degree=sh_degree, scale_modifier=scale_modifier,
            tile_x=tile_x, tile_y=tile_y, tight_rect=tight_rect, **per_g)
    if model_axis is not None:
        fs = gather_field_rows(fs, model_axis)
    return blend_fields(fs, width=camera.width, height=camera.height,
                        bg_color=bg_color, capacity=capacity,
                        train_mode=train_mode, sub_chunks=sub_chunks,
                        stat_width=camera.full_width,
                        stat_height=camera.full_height, tail_cap=tail_cap,
                        big_cap=big_cap, emit_k=emit_k)
