"""Tile binning: depth-ordered, tile-grouped pair lists padded to the blend
kernel's 128-pair chunks.

Counterpart of `gaussianrpg_tpu/ops/binning.py`: the emission path
(`_build_pair_lists_emit`) and the default marker path of
`build_pair_lists` (one gaussian-id marker scatter, a cummax fill, one
row take). With `ride_gm` (training) they also return the machinery of
the sort-free pair-gradient segment sum: each slot's expansion-order
index `pair_gm` (ridden through the sort), or with `derive_gm` on the
emission path the slot's tile `pair_tile` (the caller rebuilds gm), plus
each gaussian's expansion segment `seg_offs`/`seg_area`. Every
running-max fill of either path goes through kernel A (`_fill`), where
the JAX package uses XLA's cummax for lengths that are not a multiple of
65536 and on the emission path. Outputs are element-for-element those of
the JAX package. The legacy packed-marker branches and `SCATTER_COLS`
(TPU A/B knobs whose output equals the default) are not ported.

Scatter-max with `mode="drop"` becomes `scatter_reduce_(reduce="amax")`
in which every dropped entry, and every entry that its right-hand
neighbour supersedes (same index, value no larger), writes a private slot
past the end: the runs of equal offsets that the marker scatters meet (the
inactive slots' trailing run on the marker path) then cost one atomic per
distinct offset, not one atomic each on a shared address. Counts are taken
in float32 or int, never in bfloat16; sorts keep `stable=True` where the
JAX package asks for it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .projection import TILE_X, TILE_Y
from .scan import BLOCK as SCAN_BLOCK
from .scan import fused_cummax

G_CHUNK = 128      # pairs per blend-kernel chunk
SUB_CHUNKS = 1     # 128-pair chunks per alignment quantum (default)
EMIT_PAIRS = True  # emission path when its key fields fit (see emit_active)
EMIT_K = 4         # emission slots per gaussian

_EMIT_GB = 20
_EMIT_SPARE = (1 << _EMIT_GB) - 1
_EMIT_SENT = 0x7FFFFFFF

I32 = torch.int32


class PairLists(NamedTuple):
    pair_src: torch.Tensor      # [P_pad] i32 row index (-1 = padding)
    pair_valid: torch.Tensor    # [P_pad] bool
    tile_nonempty: torch.Tensor  # [n_tiles] bool: tiles whose block is written
    chunk_meta: torch.Tensor    # [P_pad/128] i32 tile|first<<24|last<<25|valid<<26
    raw_total: torch.Tensor     # [] i32 true pair count
    padded_total: torch.Tensor  # [] i32 padded pair count
    n_tiles_x: int
    n_tiles_y: int
    capacity: int
    tile_x: int = TILE_X
    tile_y: int = TILE_Y
    sub_chunks: int = 1
    # training extras (ride_gm=True)
    pair_gm: torch.Tensor | None = None    # [P_pad] i32 expansion index (-1 pad)
    seg_offs: torch.Tensor | None = None   # [N] i32 first expansion slot
    seg_area: torch.Tensor | None = None   # [N] i32 pairs per gaussian
    pair_tile: torch.Tensor | None = None  # [P_pad] i32 tile (-1 pad; derive_gm)

    @property
    def overflowed(self) -> torch.Tensor:
        return (self.raw_total > self.capacity) | (
            self.padded_total > self.capacity)


def depth_order(pre) -> torch.Tensor:
    """Stable (depth, id) order of a `Preprocessed` with culled Gaussians
    at the end."""
    key = torch.where(pre.radii > 0, pre.depths,
                      torch.full_like(pre.depths, float("inf")))
    return torch.argsort(key, stable=True)


def tile_grid_dims(width: int, height: int, tile_x: int = TILE_X,
                   tile_y: int = TILE_Y) -> tuple[int, int]:
    return ((width + tile_x - 1) // tile_x, (height + tile_y - 1) // tile_y)


def emit_active(n: int, n_tiles: int) -> bool:
    """True when the emission path handles this configuration."""
    return (EMIT_PAIRS and n < (1 << _EMIT_GB) - 1
            and ((n_tiles + 2) << _EMIT_GB) < (1 << 31))


def _cumsum(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, dim=0, dtype=I32)


def _scatter_max(size: int, idx: torch.Tensor, vals: torch.Tensor):
    """zeros(size).at[idx].max(vals, mode="drop"), for any idx and vals.

    An entry whose right-hand neighbour has the same index and a value no
    smaller cannot change the max, so it is superseded. Superseded and
    out-of-range entries each write a private slot `size + i` that is cut
    off (selecting the kept ones by a boolean mask would wait for the card
    to count them); the rest go through the atomic amax, where repeats
    that are not neighbours still meet. On the callers' non-decreasing
    offsets each address then takes one write."""
    n = idx.shape[0]
    dev = vals.device
    sup = torch.zeros(n, dtype=torch.bool, device=dev)
    torch.logical_and(idx[:-1] == idx[1:], vals[:-1] <= vals[1:],
                      out=sup[:-1])
    keep = (idx >= 0) & (idx < size) & ~sup
    slot = torch.where(keep, idx.long(),
                       torch.arange(size, size + n, device=dev))
    out = torch.zeros(size + n, dtype=I32, device=dev)
    out.scatter_reduce_(0, slot, vals, "amax")
    return out[:size]


def _fill(marks: torch.Tensor) -> torch.Tensor:
    """Running max of a marker array through kernel A. A length that is
    not a multiple of 65536 is zero-padded up to one and the result cut
    back: what follows the first P elements cannot change their running
    max."""
    p = marks.shape[0]
    pad = -p % SCAN_BLOCK
    if pad:
        marks = torch.cat([marks, marks.new_zeros(pad)])
    return fused_cummax([marks])[0][:p]


def _chunk_and_pad(counts, align, capacity, n_tiles, max_chunks):
    """Per-tile chunk-aligned layout + packed chunk metadata from the
    per-tile pair counts."""
    dev = counts.device
    pcounts = ((counts + align - 1) // align) * align
    pstarts = torch.cat([torch.zeros(1, dtype=I32, device=dev),
                         _cumsum(pcounts)])
    padded_total = pstarts[-1]
    cidx = torch.arange(max_chunks, dtype=I32, device=dev)
    elem = cidx * G_CHUNK
    ct = torch.clamp(torch.searchsorted(pstarts, elem, right=True).to(I32)
                     - 1, 0, n_tiles - 1)
    cvalid = elem < padded_total
    chunk_tile = torch.where(cvalid, ct, torch.full_like(ct, n_tiles - 1))
    chunk_first = (cvalid & (elem == pstarts[ct.long()])).to(I32)
    chunk_last = (cvalid & (elem + G_CHUNK == pstarts[ct.long() + 1])).to(I32)
    assert n_tiles < (1 << 24)
    chunk_meta = (chunk_tile | (chunk_first << 24) | (chunk_last << 25)
                  | (cvalid.to(I32) << 26))
    tile_written = (counts > 0) & (pstarts[1:] <= capacity)
    return pcounts, pstarts, padded_total, chunk_meta, tile_written


def _emit_decode(k, rw_f, base0, ntx):
    """Tile of the k-th rect cell, row-major (f32 +0.5 floor division, as
    the JAX package computes it)."""
    row = torch.floor((k.to(torch.float32) + 0.5) / rw_f).to(I32)
    col = k - row * rw_f.to(I32)
    return base0 + row * ntx + col


def _build_pair_lists_emit(x0, y0, rw, area, offs, raw_total, capacity,
                           align, sub, n_tiles, ntx, nty, max_chunks, tile_x,
                           tile_y, ride_gm, rank=None, tail_cap=None,
                           big_cap=None, derive_gm=False, emit_k=None):
    """Transposed K-slot emission + one keyed sort of
    (tile << 20 | depth rank) keys (unique for real pairs). `offs` (the
    exclusive cumsum of the areas) is needed only with `ride_gm`."""
    dev = x0.device
    n = x0.shape[0]
    K = EMIT_K if emit_k is None else emit_k
    p_max = capacity
    g32 = torch.arange(n, dtype=I32, device=dev)
    gb = _EMIT_GB
    # torch.full, not torch.tensor: a python value copied to the card
    # would wait for the stream (a host sync inside the frame)
    sent = torch.full((), _EMIT_SENT, dtype=I32, device=dev)

    base0 = (y0 * ntx + x0).to(I32)
    rw_f = torch.clamp(rw, min=1).to(torch.float32)

    # exact per-tile counts: separable rect coverage as a 0/1 indicator
    # product, accumulated in float32 (exact below 2^24)
    ix = torch.arange(ntx, dtype=I32, device=dev)[:, None]
    iy = torch.arange(nty, dtype=I32, device=dev)[:, None]
    zero = torch.zeros_like(rw)
    x1 = (x0 + torch.where(area > 0, rw, zero))[None, :]
    y1 = (y0 + torch.where(area > 0,
                           torch.div(area, torch.clamp(rw, min=1),
                                     rounding_mode="floor"), zero))[None, :]
    indx = ((ix >= x0[None, :]) & (ix < x1)).to(torch.float32)
    indy = ((iy >= y0[None, :]) & (iy < y1)).to(torch.float32)
    counts = (indy @ indx.T).to(I32).reshape(-1)

    pcounts, pstarts, padded_total, chunk_meta, tile_written = \
        _chunk_and_pad(counts, align, capacity, n_tiles, max_chunks)

    # head emission: slots 0..K-1 of every gaussian, [K, n]
    krank = g32 if rank is None else rank.to(I32)
    kk = torch.arange(K, dtype=I32, device=dev)[:, None]
    tile_e = _emit_decode(kk, rw_f[None, :], base0[None, :], ntx)
    valid_e = kk < area[None, :]
    key_e = torch.where(valid_e, (tile_e << gb) | krank[None, :], sent)
    src_e = g32[None, :].expand(K, n)
    if offs is None:                   # eval: the gm machinery is unused
        offs = area
    gm_e = offs[None, :] + kk

    # tail: rects bigger than K, compacted then marker-expanded
    if tail_cap is None:
        tail_cap = max(65536, p_max // 8 // 65536 * 65536)
    if big_cap is None:
        big_cap = max(8192, tail_cap // 16)
    big_cap = min(big_cap, n)
    area_t = torch.clamp(area - K, min=0)
    big = area_t > 0
    n_big = torch.sum(big.to(I32))
    order_b = torch.argsort(torch.where(big, g32, sent),
                            stable=True)[:big_cap]
    b_at = area_t[order_b] * big[order_b].to(I32)
    b_offs_t = _cumsum(b_at) - b_at
    tail_total = b_offs_t[-1] + b_at[-1]
    b_tab = torch.stack(
        [base0[order_b],
         offs[order_b],
         torch.clamp(rw[order_b], min=1),
         g32[order_b],
         b_offs_t,
         krank[order_b]], dim=1)
    markb = _scatter_max(
        tail_cap, b_offs_t,
        torch.arange(1, order_b.shape[0] + 1, dtype=I32, device=dev))
    fillb = _fill(markb) - 1
    rows_b = b_tab[torch.clamp(fillb, min=0).long()]
    t_idx = torch.arange(tail_cap, dtype=I32, device=dev)
    k_t = K + (t_idx - rows_b[:, 4])
    tile_t = _emit_decode(k_t, rows_b[:, 2].to(torch.float32),
                          rows_b[:, 0], ntx)
    ok_t = (t_idx < tail_total) & (fillb >= 0)
    key_t = torch.where(ok_t, (tile_t << gb) | rows_b[:, 5], sent)
    src_t = rows_b[:, 3]
    gm_t = rows_b[:, 1] + k_t
    tail_overflow = (tail_total > tail_cap) | (n_big > big_cap)

    # per-tile padding slots
    spare_cap = n_tiles * align
    pad_needed = pcounts - counts
    cum_pad_excl = _cumsum(pad_needed) - pad_needed
    spare_marks = _scatter_max(
        spare_cap, cum_pad_excl,
        torch.arange(1, n_tiles + 1, dtype=I32, device=dev))
    spare_fill = _fill(spare_marks) - 1
    s_idx = torch.arange(spare_cap, dtype=I32, device=dev)
    ok_s = (s_idx < padded_total - raw_total) & (spare_fill >= 0)
    key_s = torch.where(ok_s, (spare_fill << gb) | _EMIT_SPARE, sent)

    # one keyed sort lands the aligned tile-major layout
    keys = torch.cat([key_e.reshape(-1), key_t, key_s])
    srcs = torch.cat([src_e.reshape(-1), src_t,
                      torch.full((spare_cap,), -1, dtype=I32, device=dev)])
    m = keys.shape[0]
    if m < p_max:
        pad = p_max - m
        keys = torch.cat([keys, sent.expand(pad)])
        srcs = torch.cat([srcs, torch.full((pad,), -1, dtype=I32,
                                           device=dev)])
    dead = keys == sent
    srcs = torch.where(dead, torch.full_like(srcs, -1), srcs)
    # real keys are unique and the padding/dead slots carry -1 payloads, so
    # an unstable sort lands the same (src, gm) columns as the JAX sort
    sorted_keys, perm = torch.sort(keys)
    perm = perm[:p_max]
    pair_src = srcs[perm]
    pair_valid = pair_src >= 0
    pair_gm = pair_tile = None
    if ride_gm and not derive_gm:
        gms = torch.cat([gm_e.reshape(-1), gm_t,
                         torch.full((spare_cap,), -1, dtype=I32, device=dev)])
        if m < p_max:
            gms = torch.cat([gms, torch.full((p_max - m,), -1, dtype=I32,
                                             device=dev)])
        pair_gm = torch.where(dead, torch.full_like(gms, -1), gms)[perm]
    elif ride_gm:
        # derive mode: the sorted key's high field is the covered tile
        sk = sorted_keys[:p_max]
        real = (sk != _EMIT_SENT) & ((sk & _EMIT_SPARE) != _EMIT_SPARE)
        pair_tile = torch.where(real, sk >> gb, torch.full_like(sk, -1))

    padded_total = torch.where(
        tail_overflow, torch.full_like(padded_total, capacity + align),
        padded_total)
    return PairLists(
        pair_src=pair_src, pair_valid=pair_valid, tile_nonempty=tile_written,
        chunk_meta=chunk_meta, raw_total=raw_total,
        padded_total=padded_total, n_tiles_x=ntx, n_tiles_y=nty,
        capacity=capacity, tile_x=tile_x, tile_y=tile_y, sub_chunks=sub,
        pair_gm=pair_gm, seg_offs=offs if ride_gm else None,
        seg_area=area if ride_gm else None, pair_tile=pair_tile)


def build_pair_lists(
    rect_min: torch.Tensor,
    rect_max: torch.Tensor,
    visible: torch.Tensor,
    width: int,
    height: int,
    capacity: int,
    ride_gm: bool = False,
    tile_x: int = TILE_X,
    tile_y: int = TILE_Y,
    sub_chunks: int | None = None,
    rank: torch.Tensor | None = None,
    tail_cap: int | None = None,
    big_cap: int | None = None,
    derive_gm: bool = False,
    emit_k: int | None = None,
) -> PairLists:
    """Expand Gaussians into tile-grouped, depth-ordered pair lists.

    Without `rank` the inputs are depth-sorted and pair_src indexes the
    sorted table; with `rank` (emission path only) they stay in original
    order and pair_src indexes the original table. `ride_gm` adds the
    training fields (pair_gm, seg_offs, seg_area); with `derive_gm` the
    emission path returns pair_tile instead of pair_gm."""
    sub = SUB_CHUNKS if sub_chunks is None else sub_chunks
    align = G_CHUNK * sub
    assert capacity % align == 0
    dev = rect_min.device
    n = rect_min.shape[0]
    ntx, nty = tile_grid_dims(width, height, tile_x, tile_y)
    n_tiles = ntx * nty
    p_max = capacity
    max_chunks = capacity // G_CHUNK

    x0 = rect_min[:, 0].to(I32)
    y0 = rect_min[:, 1].to(I32)
    rw = torch.clamp(rect_max[:, 0] - x0, min=0).to(I32)
    rh = torch.clamp(rect_max[:, 1] - y0, min=0).to(I32)
    area = torch.where(visible, rw * rh, torch.zeros_like(rw)).to(I32)

    if ride_gm or not emit_active(n, n_tiles):
        offs = _cumsum(area) - area                  # exclusive prefix
        raw_total = offs[-1] + area[-1]
    else:
        offs = None
        raw_total = torch.sum(area, dtype=I32)

    if emit_active(n, n_tiles):
        return _build_pair_lists_emit(
            x0, y0, rw, area, offs, raw_total, capacity, align, sub,
            n_tiles, ntx, nty, max_chunks, tile_x, tile_y, ride_gm,
            rank=rank, tail_cap=tail_cap, big_cap=big_cap,
            derive_gm=derive_gm, emit_k=emit_k)
    assert rank is None, "rank requires the emission path (emit_active)"

    # one-scatter expansion: gaussian-id marker + cummax fill + one row
    # take of (tile base, segment start, rect width)
    gp1 = torch.arange(1, n + 1, dtype=I32, device=dev)
    mark = _scatter_max(p_max, offs, gp1)
    pair_g = _fill(mark) - 1
    rw_payload = torch.where(area > 0, rw, torch.zeros_like(rw))
    base0 = (y0 * ntx + x0).to(I32)
    tab = torch.stack([torch.where(area > 0, base0, torch.zeros_like(base0)),
                       offs, torch.clamp(rw_payload, min=1)], dim=1)
    rows_tab = tab[torch.clamp(pair_g, min=0).long()]
    g_base, seg_start, g_rw = rows_tab[:, 0], rows_tab[:, 1], rows_tab[:, 2]

    pair_idx = torch.arange(p_max, dtype=I32, device=dev)
    pair_ok = (pair_idx < raw_total) & (pair_g >= 0)
    pair_g = torch.clamp(pair_g, min=0)
    k = pair_idx - seg_start
    row = torch.floor((k.to(torch.float32) + 0.5)
                      / g_rw.to(torch.float32)).to(I32)
    col = k - row * g_rw
    tile = g_base + row * ntx + col
    tile = torch.where(pair_ok, tile, torch.full_like(tile, n_tiles))

    # per-tile counts (exact integer histogram; invalid pairs land in the
    # extra bin n_tiles). Not torch.bincount: on the card it reads the
    # largest index back to size its output, a host sync inside the frame
    counts = torch.zeros(n_tiles + 1, dtype=I32, device=dev).index_add_(
        0, tile.long(), torch.ones_like(tile))[:n_tiles]
    pcounts, pstarts, padded_total, chunk_meta, tile_written = \
        _chunk_and_pad(counts, align, capacity, n_tiles, max_chunks)

    # padded placement: label spare slots with the tile they pad, then one
    # stable sort of (tile, src) lands reals then their tile's padding
    pad_needed = pcounts - counts
    cum_pad_excl = _cumsum(pad_needed) - pad_needed
    spare_pos = raw_total + cum_pad_excl
    spare_marks = _scatter_max(
        p_max, spare_pos, torch.arange(1, n_tiles + 1, dtype=I32, device=dev))
    spare_fill = _fill(spare_marks) - 1
    n_spare_used = padded_total - raw_total
    spare_ok = (pair_idx >= raw_total) \
        & (pair_idx < raw_total + n_spare_used) & (spare_fill >= 0)
    key2 = torch.where(pair_ok, tile,
                       torch.where(spare_ok, spare_fill,
                                   torch.full_like(tile, n_tiles)))
    src2 = torch.where(pair_ok, pair_g, torch.full_like(pair_g, -1))
    perm = torch.sort(key2, stable=True).indices
    pair_src = src2[perm]
    pair_gm = None
    if ride_gm:
        pair_gm = torch.where(pair_ok, pair_idx,
                              torch.full_like(pair_idx, -1))[perm]
    return PairLists(
        pair_src=pair_src, pair_valid=pair_src >= 0,
        tile_nonempty=tile_written, chunk_meta=chunk_meta,
        raw_total=raw_total, padded_total=padded_total, n_tiles_x=ntx,
        n_tiles_y=nty, capacity=capacity, tile_x=tile_x, tile_y=tile_y,
        sub_chunks=sub, pair_gm=pair_gm,
        seg_offs=offs if ride_gm else None,
        seg_area=area if ride_gm else None)
