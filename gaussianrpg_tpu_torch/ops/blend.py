"""Blend forward (kernel B) and backward (kernel C): front-to-back alpha
compositing over the flat, tile-grouped, depth-ordered pair lists, and its
hand-derived gradient.

Counterpart of `gaussianrpg_tpu/ops/pallas_blend.py`: `blend_forward`
stands for the Pallas forward call (`_make_fwd_kernel`), `blend_backward`
for the backward call (`_make_bwd_kernel`), `_Blend` for the custom VJP
(`_make_blend`); `blend_pairs` and `planes_to_image` keep their JAX names.
On a CUDA tensor the two wrappers launch `csrc/blend_fwd.cu` and
`csrc/blend_bwd.cu`; on a CPU tensor they run the plain versions, which
vectorize the TPU kernel's formulation over tiles (per chunk: the log-step
exclusive product of (1 - alpha) along the pairs, the monotone stop
predicate, contractions over the pixels). A pair is always one device's:
the kernel forward with the kernel backward, the plain forward with the
plain backward, so the backward's contribution mask is the one that made
the planes.

Parity contract (the TPU kernel's): skip a pair where power > 0 or
alpha_raw < 1/255; alpha = min(0.99, op*exp(power)); a pixel stops before
the pair that would drive T*(1-alpha) below 1e-4; out = C + T_final*bg;
alpha and depth/semantics alpha-weighted. Padding rows are all zero and
therefore skipped. The backward ignores the 0.99 clamp and returns, per
pair slot and in gdata's column layout, dL/d{mx, my} (pixels), conic a, b,
c, opacity, r, g, b, depth, the AbsGS statistic sum(W/2 |gx| + H/2 |gy|)
in the F_RADIUS column, and semantics; other columns are zero.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build
from .binning import G_CHUNK

# gdata columns (pairs-major [P_pad, NF])
F_MX, F_MY, F_CA, F_CB, F_CC, F_OP, F_R, F_G, F_B, F_DEPTH, F_RADIUS = range(11)
NF_BASE = 11
F_SEM = NF_BASE
PLAIN_BATCH_ELEMS = 1 << 24  # (tile, pair, pixel) elements per plain step

launches = 0                 # kernel B launches through `blend_forward`
bwd_launches = 0             # kernel C launches through `blend_backward`


def tile_chunk_ranges(chunk_meta: torch.Tensor, n_tiles: int):
    """Per-tile [start, end) chunk range from the packed chunk metadata's
    first/last/valid bits; -1 where a tile has no first (or no last) chunk
    within capacity, i.e. where its block is not written."""
    dev = chunk_meta.device
    cm = chunk_meta
    tile = (cm & 0xFFFFFF).long()
    valid = ((cm >> 26) & 1).bool()
    first = ((cm >> 24) & 1).bool() & valid
    last = ((cm >> 25) & 1).bool() & valid
    cidx = torch.arange(cm.shape[0], dtype=torch.int32, device=dev)
    dummy = torch.full_like(tile, n_tiles)
    start = torch.full((n_tiles + 1,), -1, dtype=torch.int32, device=dev)
    end = torch.full((n_tiles + 1,), -1, dtype=torch.int32, device=dev)
    start.scatter_(0, torch.where(first, tile, dummy), cidx)
    end.scatter_(0, torch.where(last, tile, dummy), cidx + 1)
    return start[:n_tiles].contiguous(), end[:n_tiles].contiguous()


def _check(gdata, chunk_meta, bg, n_tiles, tx, ty, s_ch, name):
    if gdata.dim() != 2 or gdata.dtype != torch.float32:
        raise TypeError(f"{name}: gdata must be a 2-D float32 tensor")
    cap, nf = gdata.shape
    if cap % G_CHUNK:
        raise ValueError(f"{name}: capacity {cap} is not a multiple "
                         f"of {G_CHUNK}")
    if nf < NF_BASE + s_ch or nf % 4:
        raise ValueError(f"{name}: NF={nf} must be a multiple of 4 "
                         f"holding {NF_BASE}+{s_ch} columns")
    if (chunk_meta.dtype != torch.int32 or chunk_meta.dim() != 1
            or chunk_meta.shape[0] != cap // G_CHUNK):
        raise ValueError(f"{name}: chunk_meta must be int32 "
                         f"[{cap // G_CHUNK}]")
    if bg.dtype != torch.float32 or bg.numel() != 3:
        raise ValueError(f"{name}: bg must be float32 [3]")
    if not (gdata.device == chunk_meta.device == bg.device):
        raise ValueError(f"{name}: tensors on different devices")
    n_pix = tx * ty
    threads = 256 if n_pix >= 256 else n_pix
    if n_pix % threads or n_pix // threads not in (1, 2, 4, 8) \
            or threads % 32:
        raise ValueError(f"{name}: tile {tx}x{ty} not supported "
                         "(tx*ty must be 128..2048 and a power-of-two "
                         "multiple of 256 above 256)")


def _check_kernel(gdata, tx, ty, name):
    """What the card's kernels need beyond `_check`: the tile a whole
    number of the warps' pixel regions (`Layout` in csrc/blend_tile.cuh),
    16-byte aligned rows for the bulk copies. The shared memory is the C
    entry's own check (`_check_launch`)."""
    n_pix = tx * ty
    ppt = n_pix // min(n_pix, 256)
    bw = 2 if ppt >= 4 else 1
    if tx % (8 * bw) or ty % (4 * (ppt // bw)):
        raise ValueError(f"{name}: tile {tx}x{ty} is not a whole number "
                         f"of {8 * bw}x{4 * (ppt // bw)} warp regions")
    if gdata.data_ptr() % 16:
        raise ValueError(f"{name}: gdata's rows must be 16-byte aligned")


def _check_launch(err, s_ch, name):
    """Raise on a C entry's refusal: after `_check_kernel`, -1 means the
    block's shared memory (`smem_bytes` in the .cu) exceeds the card's."""
    if err == -1:
        raise ValueError(f"{name}: S={s_ch} needs more shared memory than "
                         "a block has")
    cuda_build.check(err, f"{name} launch")


def blend_forward(gdata, chunk_meta, bg, *, ntx: int, nty: int, tx: int,
                  ty: int, s_ch: int) -> torch.Tensor:
    """Per-tile planes [ntx*nty, 5+S, tx*ty] (r, g, b, depth, alpha, sem).
    Tiles whose block is not written hold unspecified values: mask them
    with `PairLists.tile_nonempty`."""
    global launches
    n_tiles = ntx * nty
    _check(gdata, chunk_meta, bg, n_tiles, tx, ty, s_ch, "blend_forward")
    if gdata.device.type == "cpu":
        return blend_forward_plain(gdata, chunk_meta, bg, ntx=ntx, nty=nty,
                                   tx=tx, ty=ty, s_ch=s_ch)
    if gdata.device.type != "cuda":
        raise ValueError(f"blend_forward: unsupported device {gdata.device}")
    gdata = gdata.contiguous()
    _check_kernel(gdata, tx, ty, "blend_forward")
    bg = bg.reshape(3).contiguous()
    start, end = tile_chunk_ranges(chunk_meta, n_tiles)
    out = torch.empty((n_tiles, 5 + s_ch, tx * ty), dtype=torch.float32,
                      device=gdata.device)
    lib = cuda_build.library("blend_fwd")
    fn = lib.grpg_blend_fwd
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(gdata.device).cuda_stream
    with torch.cuda.device(gdata.device):
        err = fn(gdata.data_ptr(), gdata.shape[1], start.data_ptr(),
                 end.data_ptr(), bg.data_ptr(), out.data_ptr(), n_tiles, ntx,
                 tx, ty, s_ch, stream)
    _check_launch(err, s_ch, "blend_forward")
    launches += 1
    return out


def _cumprod_excl(x: torch.Tensor) -> torch.Tensor:
    """Exclusive cumulative product along dim 1 (the 128 pairs of a
    chunk), by the TPU kernel's log-step ladder so that it rounds as the
    Pallas kernel does (`pallas_blend._sub_cumprod_excl`)."""
    y = x
    s = 1
    while s < x.shape[1]:
        y = y * torch.cat([torch.ones_like(y[:, :s]), y[:, :-s]], dim=1)
        s *= 2
    return torch.cat([torch.ones_like(y[:, :1]), y[:, :-1]], dim=1)


def _seqprod_excl(t_run: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """t_run [B, P] times the exclusive running product of x [B, G, P]
    along dim 1, one factor at a time in order: the transmittance as
    kernels B and C round it (a skipped pair's factor is 1, exact)."""
    cols = [t_run]
    for j in range(x.shape[1] - 1):
        cols.append(cols[-1] * x[:, j])
    return torch.stack(cols, dim=1)


def _plain_batches(chunk_meta, n_tiles, n_pix):
    """Live tiles in batches of similar chunk counts: yields (tiles,
    chunk counts, first chunks) of each batch, tiles sorted by count."""
    start, end = tile_chunk_ranges(chunk_meta, n_tiles)
    nchunks = torch.where((start >= 0) & (end > start), end - start,
                          torch.zeros_like(end))
    order = torch.argsort(nchunks, descending=True, stable=True)
    n_live_tiles = int((nchunks > 0).sum())
    order = order[:n_live_tiles]
    batch = max(1, PLAIN_BATCH_ELEMS // (G_CHUNK * n_pix))
    for b0 in range(0, n_live_tiles, batch):
        tb = order[b0:b0 + batch]
        yield tb, nchunks[tb], start[tb].long()


def _replay_chunk(gdata, rows, px, py, t_run, done, s_ch,
                  sequential=False):
    """One chunk of the forward for a batch of tiles, by the TPU kernel's
    formulation (`pallas_blend._alpha_terms` + `_blend_core`). rows [B, G]
    pair slots, px/py [B, P], t_run [B, P], done [B, P] bool. The
    transmittance is the TPU kernel's log-step product, or with
    `sequential` the kernels' product pair by pair."""
    gd = gdata[rows]                                      # [B, G, NF]
    t = {k: gd[:, :, f:f + 1] for k, f in (
        ("mx", F_MX), ("my", F_MY), ("ca", F_CA), ("cb", F_CB),
        ("cc", F_CC), ("op", F_OP))}
    dx = t["mx"] - px[:, None, :]
    dy = t["my"] - py[:, None, :]
    power = -0.5 * (t["ca"] * dx * dx + t["cc"] * dy * dy) \
        - t["cb"] * dx * dy
    g = torch.exp(power)
    alpha_raw = t["op"] * g
    alpha = torch.clamp(alpha_raw, max=0.99)
    skip = (power > 0.0) | (alpha_raw < (1.0 / 255.0))
    one_m = torch.where(skip, torch.ones_like(alpha), 1.0 - alpha)
    if sequential:
        t_excl = _seqprod_excl(t_run, one_m)
    else:
        t_excl = t_run[:, None, :] * _cumprod_excl(one_m)
    z = t_excl * one_m
    alive = z >= 1e-4
    contrib = (~skip) & alive & (~done[:, None, :])
    w = torch.where(contrib, alpha * t_excl, torch.zeros_like(z))
    t_new = torch.minimum(
        t_run, torch.where(contrib, z, torch.full_like(z, 2.0)).amin(dim=1))
    stop = (~skip) & (~alive)
    feats = torch.cat([gd[:, :, F_R:F_DEPTH + 1],
                       torch.ones_like(gd[:, :, :1]),
                       gd[:, :, F_SEM:F_SEM + s_ch]], dim=2)   # [B, G, C]
    return dict(t, dx=dx, dy=dy, g=g, one_m=one_m, t_excl=t_excl,
                contrib=contrib, w=w, t_new=t_new, stop=stop, feats=feats)


def _live_pairs(c, done):
    """Real pairs (nonzero opacity) met by a pixel before or at its
    stopping pair, in one replayed chunk."""
    stopped_before = torch.cummax(c["stop"].to(torch.int8), dim=1) \
        .values.bool()
    stopped_before = torch.cat([torch.zeros_like(stopped_before[:, :1]),
                                stopped_before[:, :-1]], dim=1)
    real = c["op"] != 0
    return (real & ~done[:, None, :] & ~stopped_before).sum()


def _pixel_coords(tb, p, ntx, tx, ty):
    px = (p % tx + (tb % ntx)[:, None] * tx).to(torch.float32)
    py = (p // tx + (tb // ntx)[:, None] * ty).to(torch.float32)
    return px, py


def blend_forward_plain(gdata, chunk_meta, bg, *, ntx: int, nty: int,
                        tx: int, ty: int, s_ch: int,
                        count_live: bool = False, sum_dtype=None,
                        sequential: bool = False):
    """Plain PyTorch version of the blend forward. Processes the r-th chunk
    of a batch of tiles at once. With `count_live`, also returns the number
    of (real pair, pixel) evaluations the blend needs: pairs with nonzero
    opacity met before or at the pixel's stopping pair. The planes are
    summed in gdata's dtype, as the TPU kernel sums them, or in
    `sum_dtype` (float64: as kernels B and C keep the sums that the
    backward's suffix subtracts; `chip_smoke.py` holds the kernels to that
    form on the card). `sequential` replays the kernels' transmittance
    product in place of the TPU kernel's (`_replay_chunk`)."""
    dev = gdata.device
    n_tiles = ntx * nty
    n_pix = tx * ty
    c_feat = 5 + s_ch
    dt = gdata.dtype           # float32; the tests also run it in float64
    sums = sum_dtype or dt
    planes = torch.zeros((n_tiles, c_feat, n_pix), dtype=dt, device=dev)
    p = torch.arange(n_pix, device=dev)
    gi = torch.arange(G_CHUNK, device=dev)
    bg = bg.reshape(3).to(dt)
    live = torch.zeros((), dtype=torch.int64, device=dev)
    for tb, nb, sb in _plain_batches(chunk_meta, n_tiles, n_pix):
        px, py = _pixel_coords(tb, p, ntx, tx, ty)
        nt = tb.shape[0]
        t_run = torch.ones((nt, n_pix), dtype=dt, device=dev)
        done = torch.zeros((nt, n_pix), dtype=torch.bool, device=dev)
        acc = torch.zeros((nt, c_feat, n_pix), dtype=sums, device=dev)
        for r in range(int(nb[0])):       # tiles sorted by chunk count
            ia = torch.nonzero(nb > r).flatten()
            rows = (sb[ia] + r)[:, None] * G_CHUNK + gi[None, :]
            d = done[ia]
            c = _replay_chunk(gdata, rows, px[ia], py[ia], t_run[ia], d,
                              s_ch, sequential)
            acc[ia] += torch.bmm(c["feats"].transpose(1, 2).to(sums),
                                 c["w"].to(sums))
            t_run[ia] = c["t_new"]
            if count_live:
                live += _live_pairs(c, d)
            done[ia] = d | c["stop"].any(dim=1)
        rgb = acc[:, 0:3] + (t_run[:, None, :] * bg[None, :, None]).to(sums)
        planes[tb] = torch.cat([rgb, acc[:, 3:]], dim=1).to(dt)
    if count_live:
        return planes, int(live)
    return planes


# The per-pair cull rectangle of kernels B and C (`cull_rect` in
# csrc/blend_tile.cuh, which derives it); float32 constants as there.
_F32 = torch.float32
CULL_OPACITY = float(torch.tensor(1.0 / 255.0, dtype=_F32)
                     * torch.tensor(1.0 - 2.0 ** -20, dtype=_F32))
CULL_MAX_SHEAR, CULL_MAX_CENTRE, CULL_MAX_VALUE = 1e5, 1e7, 1e20


def cull_rect_plain(rows: torch.Tensor) -> torch.Tensor:
    """(x_lo, x_hi, y_lo, y_hi) [..., 4] of pair rows [..., NF] (float32):
    every pixel at which the blend's exact test lets the pair through lies
    inside. The kernels' formula, written once more in PyTorch for the
    tests (tests/test_torch_blend_cull.py); nothing on the main path calls
    it. The whole plane where the conic is not positive definite, too
    sheared or the inputs too large; an empty rectangle where the opacity
    is below 1/255."""
    rows = rows.to(_F32)
    mx, my, ca, cb, cc, op = (rows[..., i] for i in range(6))
    f = functools.partial(torch.tensor, dtype=_F32, device=rows.device)
    inf = float("inf")
    bounded = ((mx.abs() <= CULL_MAX_CENTRE) & (my.abs() <= CULL_MAX_CENTRE)
               & (ca.abs() <= CULL_MAX_VALUE) & (cb.abs() <= CULL_MAX_VALUE)
               & (cc.abs() <= CULL_MAX_VALUE) & (op.abs() <= CULL_MAX_VALUE))
    det = ca * cc - cb * cb
    r = (ca * cc) / det
    ok = bounded & (ca > 0) & (cc > 0) & (det > 0) & (r <= CULL_MAX_SHEAR)
    tau = (torch.clamp(torch.log(op * f(255.0)), min=0.0) * f(1.0 + 1e-6)
           + f(4e-6))
    t2 = f(2.0) * tau * (f(1.0) + f(2.0 ** -18) * r + f(1e-5)) / det
    hx = torch.sqrt(t2 * cc)
    hy = torch.sqrt(t2 * ca)
    ex = f(1e-2) + f(1e-6) * (mx.abs() + hx)
    ey = f(1e-2) + f(1e-6) * (my.abs() + hy)
    rect = torch.stack([mx - hx - ex, mx + hx + ex, my - hy - ey,
                        my + hy + ey], dim=-1)
    everywhere = f([-inf, inf, -inf, inf]).expand_as(rect)
    empty = f([inf, -inf, inf, -inf]).expand_as(rect)
    rect = torch.where(ok[..., None], rect, everywhere)
    return torch.where((bounded & (op < CULL_OPACITY))[..., None], empty,
                       rect)


def check_backward(gdata, chunk_meta, bg, out, dout, *, n_tiles: int,
                   tx: int, ty: int, s_ch: int, name: str) -> None:
    """Raise on inputs kernel C does not take (shapes, types, devices, the
    tile shape)."""
    n_pix = tx * ty
    _check(gdata, chunk_meta, bg, n_tiles, tx, ty, s_ch, name)
    for what, planes in (("out", out), ("dout", dout)):
        if (planes.dtype != torch.float32 or planes.device != gdata.device
                or tuple(planes.shape) != (n_tiles, 5 + s_ch, n_pix)):
            raise ValueError(f"{name}: {what} must be float32 "
                             f"[{n_tiles}, {5 + s_ch}, {n_pix}] on "
                             f"{gdata.device}")


def blend_backward(gdata, chunk_meta, bg, out, dout, *, ntx: int, nty: int,
                   tx: int, ty: int, s_ch: int, stat_width: int,
                   stat_height: int) -> torch.Tensor:
    """Per-slot gradients [P_pad, NF] in gdata's column layout from the
    saved planes `out` and their cotangents `dout` ([ntx*nty, 5+S, tx*ty]).
    `stat_width`/`stat_height` scale the AbsGS statistic (the physical
    image). Slots of unwritten tiles and padding come back zero."""
    global bwd_launches
    n_tiles = ntx * nty
    check_backward(gdata, chunk_meta, bg, out, dout, n_tiles=n_tiles, tx=tx,
                   ty=ty, s_ch=s_ch, name="blend_backward")
    if gdata.device.type == "cpu":
        return blend_backward_plain(
            gdata, chunk_meta, bg, out, dout, ntx=ntx, nty=nty, tx=tx,
            ty=ty, s_ch=s_ch, stat_width=stat_width, stat_height=stat_height)
    if gdata.device.type != "cuda":
        raise ValueError(f"blend_backward: unsupported device {gdata.device}")
    grad = _launch_backward("grpg_blend_bwd", gdata, chunk_meta, bg, out,
                            dout, n_tiles=n_tiles, ntx=ntx, tx=tx, ty=ty,
                            s_ch=s_ch, stat_width=stat_width,
                            stat_height=stat_height)
    bwd_launches += 1
    return grad


def _launch_backward(symbol, gdata, chunk_meta, bg, out, dout, *,
                     n_tiles: int, ntx: int, tx: int, ty: int, s_ch: int,
                     stat_width: int, stat_height: int) -> torch.Tensor:
    """Launch the C entry `symbol` of csrc/blend_bwd.cu (kernel C, or its
    variant for tools/bwd_ablate.py) on checked CUDA tensors."""
    gdata = gdata.contiguous()
    _check_kernel(gdata, tx, ty, symbol)
    out = out.contiguous()
    dout = dout.contiguous()
    bg = bg.reshape(3).contiguous()
    start, end = tile_chunk_ranges(chunk_meta, n_tiles)
    grad = torch.empty_like(gdata)
    fn = getattr(cuda_build.library("blend_bwd"), symbol)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_float,
                   ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(gdata.device).cuda_stream
    with torch.cuda.device(gdata.device):
        err = fn(gdata.data_ptr(), gdata.shape[1], chunk_meta.data_ptr(),
                 chunk_meta.shape[0], start.data_ptr(), end.data_ptr(),
                 bg.data_ptr(), out.data_ptr(), dout.data_ptr(),
                 grad.data_ptr(), n_tiles, ntx, tx, ty, s_ch,
                 0.5 * stat_width, 0.5 * stat_height, stream)
    _check_launch(err, s_ch, symbol)
    return grad


def kernel_info(kernel: str, *, tx: int, ty: int, s_ch: int,
                nf: int) -> dict:
    """Occupancy of kernel B ("blend_fwd") or C ("blend_bwd") as launched
    for this tile shape on the current card: resident blocks per SM,
    registers per thread, dynamic and static shared memory per block,
    threads per block (`cudaOccupancyMaxActiveBlocksPerMultiprocessor`,
    `cudaFuncGetAttributes`)."""
    info = (ctypes.c_int * 5)()
    fn = getattr(cuda_build.library(kernel), f"grpg_{kernel}_info")
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    cuda_build.check(fn(tx, ty, s_ch, nf, ctypes.addressof(info)),
                     f"{kernel} occupancy query")
    return dict(zip(("blocks_per_sm", "registers", "dynamic_smem_bytes",
                     "static_smem_bytes", "threads"), info))


def blend_backward_plain(gdata, chunk_meta, bg, out, dout, *, ntx: int,
                         nty: int, tx: int, ty: int, s_ch: int,
                         stat_width: int, stat_height: int,
                         sum_dtype=None,
                         sequential: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the blend backward. Replays the plain
    forward chunk by chunk (so its masks are the plain forward's) and forms
    the TPU kernel's per-pixel terms (`pallas_blend._make_bwd_kernel`):
    e = feats . g, p_incl = running sum of w*e, dL/dalpha =
    e*T - (tot_ebt - p_incl)/(1 - alpha), then sums them over the pixels.
    tot_ebt and p_incl are summed in gdata's dtype, as the TPU kernel sums
    them, or in `sum_dtype` (float64: as kernel C keeps them; their
    difference is small where a pixel nears saturation). `sequential`
    replays the kernels' transmittance product (`_replay_chunk`)."""
    dev = gdata.device
    n_tiles = ntx * nty
    n_pix = tx * ty
    grad = torch.zeros_like(gdata)
    p = torch.arange(n_pix, device=dev)
    gi = torch.arange(G_CHUNK, device=dev)
    dt = gdata.dtype           # float32; the tests also run it in float64
    sums = sum_dtype or dt
    bg = bg.reshape(3).to(dt)
    half_w, half_h = 0.5 * stat_width, 0.5 * stat_height
    for tb, nb, sb in _plain_batches(chunk_meta, n_tiles, n_pix):
        px, py = _pixel_coords(tb, p, ntx, tx, ty)
        nt = tb.shape[0]
        outs = out[tb]                                    # [B, C, P]
        g_pix = dout[tb]
        t_final = 1.0 - outs[:, 4]
        tot = torch.cat([outs[:, 0:3] - t_final[:, None, :]
                         * bg[None, :, None], outs[:, 3:]], dim=1)
        bg_dot = g_pix[:, 0] * bg[0] + g_pix[:, 1] * bg[1] \
            + g_pix[:, 2] * bg[2]
        tot_ebt = torch.sum(tot.to(sums) * g_pix.to(sums), dim=1) \
            + t_final.to(sums) * bg_dot.to(sums)
        g_cols = torch.cat([g_pix[:, 0:4], g_pix[:, 5:]], dim=1)
        t_run = torch.ones((nt, n_pix), dtype=dt, device=dev)
        done = torch.zeros((nt, n_pix), dtype=torch.bool, device=dev)
        pref = torch.zeros((nt, n_pix), dtype=sums, device=dev)
        for r in range(int(nb[0])):
            ia = torch.nonzero(nb > r).flatten()
            rows = (sb[ia] + r)[:, None] * G_CHUNK + gi[None, :]
            d = done[ia]
            c = _replay_chunk(gdata, rows, px[ia], py[ia], t_run[ia], d,
                              s_ch, sequential)
            e = torch.bmm(c["feats"], g_pix[ia])          # [b, G, P]
            w = c["w"]
            p_incl = pref[ia][:, None, :] + torch.cumsum((w * e).to(sums),
                                                         dim=1)
            dl_da = e * c["t_excl"] - (tot_ebt[ia][:, None, :] - p_incl
                                       ).to(dt) / c["one_m"]
            dl_da = torch.where(c["contrib"], dl_da, torch.zeros_like(dl_da))
            q2 = c["g"] * dl_da
            q = c["op"] * q2
            dx, dy = c["dx"], c["dy"]
            gxp = q * (-(c["ca"] * dx + c["cb"] * dy))
            gyp = q * (-(c["cc"] * dy + c["cb"] * dx))
            absp = half_w * torch.abs(gxp) + half_h * torch.abs(gyp)
            mw = torch.bmm(w, g_cols[ia].transpose(1, 2))  # [b, G, 4+S]
            cols = torch.stack(
                [gxp.sum(2), gyp.sum(2), (-0.5 * q * dx * dx).sum(2),
                 (-q * dx * dy).sum(2), (-0.5 * q * dy * dy).sum(2),
                 q2.sum(2)], dim=2)
            gmat = torch.cat([cols, mw[:, :, :4], absp.sum(2)[:, :, None],
                              mw[:, :, 4:]], dim=2)       # [b, G, 11+S]
            grad[rows.reshape(-1), :NF_BASE + s_ch] = gmat.reshape(
                -1, NF_BASE + s_ch)
            t_run[ia] = c["t_new"]
            pref[ia] = p_incl[:, -1, :]
            done[ia] = d | c["stop"].any(dim=1)
    return grad


class _Blend(torch.autograd.Function):
    """Blend with its hand-derived backward (`pallas_blend._make_blend`):
    the forward saves (gdata, chunk_meta, bg, out), the backward returns
    d_gdata in gdata's column layout."""

    @staticmethod
    def forward(ctx, gdata, chunk_meta, bg, cfg):
        out = blend_forward(gdata, chunk_meta, bg, ntx=cfg["ntx"],
                            nty=cfg["nty"], tx=cfg["tx"], ty=cfg["ty"],
                            s_ch=cfg["s_ch"])
        ctx.save_for_backward(gdata, chunk_meta, bg, out)
        ctx.cfg = cfg
        return out

    @staticmethod
    def backward(ctx, dout):
        gdata, chunk_meta, bg, out = ctx.saved_tensors
        d_gdata = blend_backward(gdata, chunk_meta, bg, out,
                                 dout.contiguous(), **ctx.cfg)
        return d_gdata, None, None, None


def planes_to_image(planes, ntx: int, nty: int, height: int, width: int,
                    tx: int, ty: int) -> torch.Tensor:
    """Tile-major [ntx*nty, NFO, tx*ty] -> image planes [NFO, H, W]."""
    nfo = planes.shape[1]
    x = planes.reshape(nty, ntx, nfo, ty, tx).permute(2, 0, 3, 1, 4)
    return x.reshape(nfo, nty * ty, ntx * tx)[:, :height, :width]


def blend_pairs(gdata, lists, bg, *, width: int, height: int,
                s_ch: int = 0, stat_width: int | None = None,
                stat_height: int | None = None) -> torch.Tensor:
    """Image planes [5 + S, H, W] (rgb, depth, alpha, semantics) from the
    pair rows and their pair lists; tiles with no written block get the
    background. Differentiable in `gdata` (kernels B and C on the card);
    `stat_width`/`stat_height` (default: width/height) scale the AbsGS
    statistic, the physical image's size for strip renders."""
    tx, ty = lists.tile_x, lists.tile_y
    ntx, nty = lists.n_tiles_x, lists.n_tiles_y
    cfg = dict(ntx=ntx, nty=nty, tx=tx, ty=ty, s_ch=s_ch,
               stat_width=stat_width or width,
               stat_height=stat_height or height)
    planes = _Blend.apply(gdata, lists.chunk_meta, bg.reshape(3), cfg)
    nfo = planes.shape[1]
    bg_plane = torch.cat([bg.reshape(3),
                          torch.zeros(nfo - 3, dtype=planes.dtype,
                                      device=planes.device)])
    planes = torch.where(lists.tile_nonempty[:, None, None], planes,
                         bg_plane[None, :, None])
    return planes_to_image(planes, ntx, nty, height, width, tx, ty)
