"""Card-only tests of the port's CUDA kernels against their plain PyTorch
versions (kernel A: fused cummax, kernel B: blend forward, kernel C: blend
backward, and the kernels of the tools in `gaussianrpg_tpu_torch/tools`),
plus one frame and its gradients through `rasterize` on the card against
the CPU path, binning's marker path at the street scene's slot layout
against the CPU path, YOLOv5 perception (the graph against the CPU path, the
fused step against the unfused detector), and the evaluation apps (the
render app's PNGs, PSNR, SSIM and LPIPS on the card against the CPU
path).

They skip without a CUDA card. This file imports neither JAX nor the JAX
package, so on a machine with the card and no JAX it runs alone:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py
"""
import math

import numpy as np
import pytest
import torch

from gaussianrpg_tpu_torch.ops import binning, blend, scan
from gaussianrpg_tpu_torch.ops.rasterize import (pair_rows, primitive_fields,
                                                 rasterize)
from gaussianrpg_tpu_torch.render.camera import make_camera

RTOL, ATOL, ATOL_DEPTH = 1e-4, 1e-5, 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _scene(n, W, H, seed, device):
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                      rng.uniform(1, 8, n)], -1).astype(np.float32)
    q = rng.standard_normal((n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    host = dict(
        opacities=rng.uniform(0.05, 0.95, n).astype(np.float32),
        colors=rng.uniform(0, 1, (n, 3)).astype(np.float32),
        scales=np.exp(rng.uniform(-3.5, -1.0, (n, 3))).astype(np.float32),
        rotations=q,
        semantics=rng.uniform(0, 1, (n, 5)).astype(np.float32))
    fovx = math.radians(60.0)
    fovy = 2 * math.atan(math.tan(fovx / 2) * H / W)
    cam = make_camera(R=np.eye(3), T=np.zeros(3), K=None, width=W, height=H,
                      fovx=fovx, fovy=fovy, device=device)
    t = {k: torch.as_tensor(v, device=device) for k, v in host.items()}
    return cam, torch.as_tensor(means, device=device), t


def _assert_planes_close(got, ref, s_ch):
    atol = torch.full((5 + s_ch, 1), ATOL, device=got.device)
    atol[3] = ATOL_DEPTH
    bad = ((got - ref).abs() > atol + RTOL * ref.abs()).any(dim=1)
    # a stop-threshold flip (sequential vs cumulative product rounding)
    # may move at most one pixel of a small frame
    assert int(bad.sum()) <= 1, float((got - ref).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("p", [65536, 131072, 65536 * 9, 2 ** 25])
def test_fused_cummax_kernel_matches_cummax(cuda, k, p):
    gen = torch.Generator(device=cuda).manual_seed(k * p)
    xs = [torch.randint(-2 ** 31, 2 ** 31 - 1, (p,), dtype=torch.int32,
                        generator=gen, device=cuda) for _ in range(k)]
    n0 = scan.launches
    got = scan.fused_cummax(xs)
    torch.cuda.synchronize()
    assert scan.launches == n0 + 1
    for a, b in zip(got, scan.fused_cummax_plain(xs)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", ["marks", "int_min", "decreasing",
                                     "max_first", "max_last", "random"])
@pytest.mark.parametrize("p", [65536 * 37, 2 ** 25])
def test_fused_cummax_kernel_patterns(cuda, pattern, p):
    """k = 4 arrays of each adversarial pattern (`scan_bench.patterns`),
    bit for bit, one launch a call."""
    from gaussianrpg_tpu_torch.tools import scan_bench

    gen = torch.Generator(device=cuda).manual_seed(p)
    xs = scan_bench.patterns(p, 4, gen, cuda)[pattern]
    n0 = scan.launches
    got = scan.fused_cummax(xs)
    torch.cuda.synchronize()
    assert scan.launches == n0 + 1
    for a, b in zip(got, scan.fused_cummax_plain(xs)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_fused_cummax_kernel_repeated_calls_and_streams(cuda):
    """Calls back to back on other data (the scratch the caching allocator
    hands out again holds the last call's status words until the memset),
    then a call on a side stream, each bit for bit and one launch."""
    p = 65536 * 40
    gen = torch.Generator(device=cuda).manual_seed(11)
    calls = []
    for lo in (0, -2 ** 31, 5):
        xs = [torch.randint(lo, 2 ** 31 - 1, (p,), dtype=torch.int32,
                            generator=gen, device=cuda) for _ in range(2)]
        n0 = scan.launches
        calls.append((xs, scan.fused_cummax(xs)))
        assert scan.launches == n0 + 1
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        xs = [torch.flip(calls[0][0][0], [0]).contiguous()]
        n0 = scan.launches
        calls.append((xs, scan.fused_cummax(xs)))
        assert scan.launches == n0 + 1
    torch.cuda.synchronize()
    for xs, got in calls:
        for a, b in zip(got, scan.fused_cummax_plain(xs)):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_fused_cummax_rejects_bad_length(cuda):
    with pytest.raises(ValueError):
        scan.fused_cummax([torch.zeros(1000, dtype=torch.int32,
                                       device=cuda)])


@pytest.mark.cuda
def test_binning_fill_pads_into_kernel(cuda):
    """A fill length that is not a multiple of 65536 still launches
    kernel A (on zero-padded marks) and equals torch.cummax."""
    p = 65536 * 3 + 128
    gen = torch.Generator(device=cuda).manual_seed(5)
    marks = torch.zeros(p, dtype=torch.int32, device=cuda)
    pos = torch.randint(0, p, (500,), generator=gen, device=cuda)
    marks[pos] = torch.randint(1, 1 << 30, (500,), dtype=torch.int32,
                               generator=gen, device=cuda)
    n0 = scan.launches
    got = binning._fill(marks)
    torch.cuda.synchronize()
    assert scan.launches == n0 + 1
    assert got.shape == (p,)
    assert torch.equal(got, torch.cummax(marks, dim=0).values)


@pytest.mark.cuda
def test_marker_path_street_slots_match_cpu(cuda):
    """The street scene's slot layout on the marker path: 4,325,376 slots,
    the 3,659,840 inactive ones trailing the depth order. The card's pair
    lists equal the CPU's field for field."""
    n, active = 4_325_376, 665_536
    W, H, capacity = 1600, 1066, 1 << 23
    ntx, nty = binning.tile_grid_dims(W, H)
    rng = np.random.default_rng(17)
    x0 = rng.integers(0, ntx, n)
    y0 = rng.integers(0, nty, n)
    rmin = np.stack([x0, y0], -1)
    rmax = np.stack([np.minimum(x0 + rng.integers(0, 5, n), ntx),
                     np.minimum(y0 + rng.integers(0, 4, n), nty)], -1)
    vis = np.arange(n) < active
    rmin[~vis] = rmax[~vis] = 0
    got = {}
    for dev in ("cpu", cuda):
        got[str(dev)] = binning.build_pair_lists(
            torch.as_tensor(rmin, dtype=torch.int32, device=dev),
            torch.as_tensor(rmax, dtype=torch.int32, device=dev),
            torch.as_tensor(vis, device=dev), W, H, capacity)
    a, b = got["cpu"], got["cuda"]
    assert 0 < int(a.raw_total) < capacity and not bool(a.overflowed)
    for f in ("pair_src", "pair_valid", "tile_nonempty", "chunk_meta",
              "raw_total", "padded_total"):
        assert torch.equal(getattr(a, f), getattr(b, f).cpu()), f


@pytest.mark.cuda
@pytest.mark.parametrize("tx,ty,s_ch,sub", [(16, 16, 0, 1), (16, 16, 5, 2),
                                            (64, 32, 0, 1), (64, 32, 3, 2),
                                            (32, 16, 5, 1), (16, 8, 0, 1)])
def test_blend_kernel_matches_plain(cuda, tx, ty, s_ch, sub):
    W, H = 160, 96
    cam, means, t = _scene(1500, W, H, 7, cuda)
    fs = primitive_fields(
        means, t["opacities"], camera=cam, colors=t["colors"],
        scales=t["scales"], rotations=t["rotations"],
        semantics=t["semantics"][:, :s_ch] if s_ch else None, tile_x=tx,
        tile_y=ty)
    gdata, lists = pair_rows(fs, width=W, height=H, capacity=1 << 16,
                             sub_chunks=sub)
    assert not bool(lists.overflowed)
    bg = torch.tensor([0.1, 0.2, 0.3], device=cuda)
    kw = dict(ntx=lists.n_tiles_x, nty=lists.n_tiles_y, tx=tx, ty=ty,
              s_ch=s_ch)
    n0 = blend.launches
    got = blend.blend_forward(gdata, lists.chunk_meta, bg, **kw)
    torch.cuda.synchronize()
    assert blend.launches == n0 + 1
    ref = blend.blend_forward_plain(gdata, lists.chunk_meta, bg, **kw)
    m = lists.tile_nonempty
    _assert_planes_close(got[m], ref[m], s_ch)


@pytest.mark.cuda
def test_blend_kernel_skips_overflowed_tiles(cuda):
    """A capacity too small for the scene: unwritten tiles are masked to
    background and the kernel reads nothing past capacity."""
    W, H = 160, 96
    cam, means, t = _scene(1500, W, H, 8, cuda)
    fs = primitive_fields(means, t["opacities"], camera=cam,
                          colors=t["colors"], scales=t["scales"],
                          rotations=t["rotations"])
    gdata, lists = pair_rows(fs, width=W, height=H, capacity=2048)
    assert bool(lists.overflowed)
    bg = torch.tensor([0.1, 0.2, 0.3], device=cuda)
    kw = dict(ntx=lists.n_tiles_x, nty=lists.n_tiles_y, tx=16, ty=16,
              s_ch=0)
    got = blend.blend_pairs(gdata, lists, bg, width=W, height=H)
    torch.cuda.synchronize()
    ref = blend.blend_forward_plain(gdata, lists.chunk_meta, bg, **kw)
    m = lists.tile_nonempty
    planes = blend.blend_forward(gdata, lists.chunk_meta, bg, **kw)
    _assert_planes_close(planes[m], ref[m], 0)
    assert bool(torch.isfinite(got).all())


@pytest.mark.cuda
@pytest.mark.parametrize("tx,ty,emit", [(16, 16, True), (16, 16, False),
                                        (64, 32, True)])
def test_rasterize_cuda_matches_cpu(cuda, tx, ty, emit, monkeypatch):
    monkeypatch.setattr(binning, "EMIT_PAIRS", emit)
    W, H = 128, 96
    out = {}
    for dev in ("cpu", cuda):
        cam, means, t = _scene(2000, W, H, 3, dev)
        out[str(dev)] = rasterize(
            means, t.pop("opacities"), camera=cam,
            bg_color=torch.tensor([0.1, 0.2, 0.3], device=dev),
            capacity=1 << 16, tile_x=tx, tile_y=ty, device=dev, **t)
    a, b = out["cpu"], out["cuda"]
    assert not bool(b.overflow)
    assert torch.equal(a.radii, b.radii.cpu())
    assert int(a.n_pairs) == int(b.n_pairs)
    pa = torch.cat([a.color, a.depth, a.alpha, a.semantic]).reshape(10, -1)
    pb = torch.cat([b.color, b.depth, b.alpha, b.semantic]).cpu()
    _assert_planes_close(pb.reshape(10, -1)[None], pa[None], 5)


def _rel_err(got, ref):
    return float((got - ref).abs().max() / (ref.abs().max() + 1e-12))


@pytest.mark.cuda
@pytest.mark.parametrize("tx,ty,s_ch,sub", [(16, 16, 0, 1), (16, 16, 5, 2),
                                            (64, 32, 0, 1), (64, 32, 3, 2),
                                            (32, 16, 5, 1), (16, 8, 0, 1)])
def test_blend_backward_kernel_matches_plain(cuda, tx, ty, s_ch, sub):
    """Kernel C against the plain backward, each on its own forward's
    planes: every gradient column group within 5e-5 of its max."""
    W, H = 160, 96
    cam, means, t = _scene(1500, W, H, 7, cuda)
    fs = primitive_fields(
        means, t["opacities"], camera=cam, colors=t["colors"],
        scales=t["scales"], rotations=t["rotations"],
        semantics=t["semantics"][:, :s_ch] if s_ch else None, tile_x=tx,
        tile_y=ty)
    gdata, lists = pair_rows(fs, width=W, height=H, capacity=1 << 16,
                             sub_chunks=sub)
    bg = torch.tensor([0.1, 0.2, 0.3], device=cuda)
    kw = dict(ntx=lists.n_tiles_x, nty=lists.n_tiles_y, tx=tx, ty=ty,
              s_ch=s_ch)
    gen = torch.Generator(device=cuda).manual_seed(3)
    out_k = blend.blend_forward(gdata, lists.chunk_meta, bg, **kw)
    out_p = blend.blend_forward_plain(gdata, lists.chunk_meta, bg, **kw)
    dout = torch.randn(out_k.shape, generator=gen, device=cuda)
    n0 = blend.bwd_launches
    got = blend.blend_backward(gdata, lists.chunk_meta, bg, out_k, dout,
                               stat_width=W, stat_height=H, **kw)
    torch.cuda.synchronize()
    assert blend.bwd_launches == n0 + 1
    ref = blend.blend_backward_plain(gdata, lists.chunk_meta, bg, out_p,
                                     dout, stat_width=W, stat_height=H, **kw)
    for cols in ([0, 1], [2, 3, 4], [5], [6, 7, 8], [9], [10],
                 list(range(11, 11 + s_ch))):
        if cols:
            assert _rel_err(got[:, cols], ref[:, cols]) < 5e-5, cols
    assert not got[:, 11 + s_ch:].any()
    assert not got[~lists.pair_valid].any()


@pytest.mark.cuda
def test_blend_backward_kernel_zeroes_unowned_slots(cuda):
    """An overflowed capacity: slots of tiles whose block is not written
    come back zero (their planes are not read)."""
    W, H = 160, 96
    cam, means, t = _scene(1500, W, H, 8, cuda)
    fs = primitive_fields(means, t["opacities"], camera=cam,
                          colors=t["colors"], scales=t["scales"],
                          rotations=t["rotations"])
    gdata, lists = pair_rows(fs, width=W, height=H, capacity=2048)
    assert bool(lists.overflowed)
    bg = torch.tensor([0.1, 0.2, 0.3], device=cuda)
    kw = dict(ntx=lists.n_tiles_x, nty=lists.n_tiles_y, tx=16, ty=16,
              s_ch=0)
    out = blend.blend_forward(gdata, lists.chunk_meta, bg, **kw)
    dout = torch.ones_like(out)
    got = blend.blend_backward(gdata, lists.chunk_meta, bg, out, dout,
                               stat_width=W, stat_height=H, **kw)
    ref = blend.blend_backward_plain(
        gdata, lists.chunk_meta, bg,
        blend.blend_forward_plain(gdata, lists.chunk_meta, bg, **kw), dout,
        stat_width=W, stat_height=H, **kw)
    assert torch.isfinite(got).all()
    assert _rel_err(got, ref) < 5e-5
    start, end = blend.tile_chunk_ranges(lists.chunk_meta,
                                         kw["ntx"] * kw["nty"])
    owned = torch.zeros(lists.chunk_meta.shape[0], dtype=torch.bool,
                        device=cuda)
    for s, e in zip(start.tolist(), end.tolist()):
        if s >= 0 and e > s:
            owned[s:e] = True
    assert not got[~owned.repeat_interleave(128)].any()


@pytest.mark.cuda
@pytest.mark.parametrize("tx,ty,emit", [(16, 16, True), (16, 16, False),
                                        (64, 32, True)])
def test_rasterize_gradients_cuda_match_cpu(cuda, tx, ty, emit,
                                            monkeypatch):
    """Train-mode `rasterize` (hooks given) on the card against the CPU
    path: gradients of means, opacity, colours and the two hooks."""
    monkeypatch.setattr(binning, "EMIT_PAIRS", emit)
    W, H = 128, 96
    res = {}
    for dev in ("cpu", cuda):
        cam, means, t = _scene(2000, W, H, 3, dev)
        args = [means.requires_grad_(True),
                t.pop("opacities").requires_grad_(True),
                t.pop("colors").requires_grad_(True)]
        n = means.shape[0]
        hooks = [torch.zeros((n, 2), device=dev, requires_grad=True),
                 torch.zeros((n,), device=dev, requires_grad=True)]
        out = rasterize(
            args[0], args[1], camera=cam, colors=args[2],
            bg_color=torch.tensor([0.1, 0.2, 0.3], device=dev),
            capacity=1 << 16, tile_x=tx, tile_y=ty, device=dev,
            means2d_offset=hooks[0], absgrad_sink=hooks[1], **t)
        loss = (out.color ** 2).sum() + (out.depth ** 2).sum()
        res[str(dev)] = [x.cpu() for x in
                         torch.autograd.grad(loss, args + hooks)]
    for a, b in zip(res["cpu"], res["cuda"]):
        assert _rel_err(b, a) < 5e-5


@pytest.mark.cuda
def test_blocked_prefix_sums_on_card(cuda):
    """The segment sum's column prefix sums take the blocked form on the
    card; against a float64 cumulative sum (a capacity that is not a
    multiple of the block)."""
    from gaussianrpg_tpu_torch.ops import rasterize as R

    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((65536 * 3 + 128, 16), generator=gen, device=cuda)
    got = R._column_prefix_sums(x)
    ref = torch.cumsum(x.double(), dim=0).t()
    assert got.shape == (16, x.shape[0])
    assert torch.allclose(got.double(), ref, rtol=1e-5, atol=1e-2)


# --- the tools' kernels (gaussianrpg_tpu_torch/tools) ----------------------

def _rel_written(got, ref, written):
    """max |got - ref| over the written blocks, over max |ref| there."""
    g, r = got[written].double(), ref[written].double()
    return float((g - r).abs().max() / (r.abs().max() + 1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("n_rows,nf,rows", [(1000, 16, 1024), (777, 24, 1000),
                                            (5, 4, 129), (600, 92, 131),
                                            (300, 96, 257), (50, 452, 130)])
def test_gather_rows_kernel_matches_plain(cuda, n_rows, nf, rows):
    """Bit for bit, on ragged row counts and widths 4-452 (above 92 the
    kernel opts in to more than 48 KB of shared memory), with row ids
    that hit row 0, the last row, and padding / out-of-range ids."""
    from gaussianrpg_tpu_torch.ops import gather as gf

    gen = torch.Generator(device=cuda).manual_seed(rows)
    fields = torch.randn((n_rows, nf), generator=gen, device=cuda)
    src = torch.randint(0, n_rows, (rows,), dtype=torch.int32,
                        generator=gen, device=cuda)
    src[0], src[-1] = 0, n_rows - 1
    src[1::7] = -1
    src[2::11] = n_rows
    n0 = gf.launches
    got = gf.gather_rows(fields, src)
    torch.cuda.synchronize()
    assert gf.launches == n0 + 1
    assert torch.equal(got, gf.gather_rows_plain(fields, src))
    assert not got[1::7].any()


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["empty", "stage", "stage_done"])
@pytest.mark.parametrize("tx,ty,tight", [(16, 16, False), (16, 16, True),
                                         (64, 32, True), (16, 8, False)])
def test_stripped_blend_kernel_matches_plain(cuda, variant, tx, ty, tight):
    """The stripped forms of kernel B against their float64 plain version
    on the tiles with a chunk range (the scene's Gaussians all lie left of
    the camera axis, so the right-hand tiles have no chunks); `tight` sets
    the capacity to the padded pair count, so that a tile's last chunk is
    the last chunk of the capacity. Planes and the per-tile sum over every
    staged chunk both. Some tiles have a range of one chunk, some of three
    or more (the two staging buffers' barrier parity wraps)."""
    from gaussianrpg_tpu_torch.tools import blend_floor as bf

    W, H = 160, 96
    cam, means, t = _scene(3000, W, H, 9, cuda)
    means[:, 0] = -means[:, 0].abs() - 1.0
    fs = primitive_fields(means, t["opacities"], camera=cam,
                          colors=t["colors"], scales=t["scales"],
                          rotations=t["rotations"], tile_x=tx, tile_y=ty)
    gdata, lists = pair_rows(fs, width=W, height=H, capacity=1 << 16)
    if tight:
        gdata, lists = pair_rows(fs, width=W, height=H,
                                 capacity=int(lists.padded_total))
        assert int(lists.chunk_meta[-1]) >> 25 & 1
    assert not bool(lists.overflowed)
    n_tiles, n_pix = lists.n_tiles_x * lists.n_tiles_y, tx * ty
    start, end = blend.tile_chunk_ranges(lists.chunk_meta, n_tiles)
    lengths = (end - start)[(start >= 0) & (end > start)]
    assert int(lengths.min()) == 1 and int(lengths.max()) >= 3
    for cm in (lists.chunk_meta, lists.chunk_meta & ~bf.VALID_BIT):
        n0 = bf.launches
        got, staged = bf.stripped_forward(variant, gdata, cm,
                                          n_tiles=n_tiles, n_pix=n_pix)
        torch.cuda.synchronize()
        assert bf.launches == n0 + 1
        ref, staged_ref, written = bf.stripped_forward_plain(
            variant, gdata.double(), cm, n_tiles=n_tiles, n_pix=n_pix)
        if written.any():
            assert not written.all()
            assert _rel_written(got, ref, written) <= 1e-5
            if variant == "empty":
                assert not staged[written].any()
            else:
                assert _rel_written(staged, staged_ref, written) <= 1e-5


def _floor_cases(r, n_tiles, seed, device):
    """(name, chunk metadata) cases for the floor kernels, whose blocks
    take ranges of r steps: 1, r - 1, r, r + 1 and 9216 steps with tiles
    spread evenly and a mixed valid pattern; skip-all and valid-all at
    3r + 5 steps; uneven tile runs (one step, r + 3 and 2r + 1 steps
    crossing a range's end, tiles 2 and 4 valid only at the first step of
    their run) with tile ids at and past n_tiles between them; and the
    same with the last bit cleared on the final 2r steps, so that the
    final last-of-tile step lies ranges before the end."""
    from gaussianrpg_tpu_torch.tools import floor_bench as fb

    rng = np.random.default_rng(seed)
    cases = [(f"{n} steps", fb.chunk_meta(n, rng.random(n) < 0.5, n_tiles,
                                          device))
             for n in sorted({1, r - 1, r, r + 1, 9216} - {0})]
    n = 3 * r + 5
    cases += [(tag, fb.chunk_meta(n, v, n_tiles, device))
              for tag, v in (("skip-all", False), ("valid-all", True))]
    runs = [(0, 1), (1, 1), (n_tiles, 2), (2, r + 3), (3, 1),
            (n_tiles + 3, r + 1), (4, 2 * r + 1), (n_tiles - 1, 2)]
    tiles = np.concatenate([np.full(k, t) for t, k in runs])
    valid = rng.random(tiles.size) < 0.5
    for t in (2, 4):
        run = np.flatnonzero(tiles == t)
        valid[run] = False
        valid[run[0]] = True
    cm = fb.meta_from_tiles(tiles, valid, device)
    cases.append(("uneven", cm))
    tail = cm.clone()
    tail[-2 * r:] &= ~(1 << 25)
    cases.append(("uneven, no last bit at the end", tail))
    return cases


def _stale_words(fb, device):
    """Overwrite the status words of the scratch that the floor kernels
    keep for the current stream with words of its last call's epoch that
    claim a published prefix of 1e9; returns (words, that epoch). A call
    that read a word of an earlier call would take the 1e9."""
    words, epoch = fb.scratch_of(device)
    bits = int(np.float32(1e9).view(np.uint32))
    words.view(torch.int64)[1:] = ((((epoch << 2) | 2) << 32) | bits)
    return words, epoch


@pytest.mark.cuda
@pytest.mark.parametrize("block", [128, 256, 512, 1024])
@pytest.mark.parametrize("dyn_out", [True, False])
def test_floor_bench_kernel_matches_plain(cuda, block, dyn_out):
    """Every block size, dynamic and fixed output, on each of
    `_floor_cases` (boundary step counts against the kernel's range of
    RANGE_ROWS // block steps, skip-all, valid-all, uneven runs across
    ranges, tiles past n_tiles), each called twice in a row on different
    gdata, against the float64 plain version (1e-5 of the written
    blocks' max); one launch a call. At 9216 steps a third call follows
    on the same scratch, whose words of the earlier calls were made to
    claim false prefixes (`_stale_words`): it must not read them."""
    from gaussianrpg_tpu_torch.ops import cuda_build
    from gaussianrpg_tpu_torch.tools import floor_bench as fb

    r = fb.RANGE_ROWS // block
    assert cuda_build.library("step_floor").grpg_step_floor_range(block) == r
    n_tiles, n_pix = 5, 100
    gen = torch.Generator(device=cuda).manual_seed(block)
    kw = dict(block=block, dyn_out=dyn_out, n_tiles=n_tiles, n_pix=n_pix)
    for name, cm in _floor_cases(r, n_tiles, block, cuda):
        n_steps = cm.shape[0]
        gs = [torch.rand((n_steps * block, 16), generator=gen, device=cuda)
              for _ in range(2)]
        n0 = fb.launches
        got = [fb.floor_bench(g, cm, **kw) for g in gs]
        torch.cuda.synchronize()
        assert fb.launches == n0 + 2, name
        if name == "9216 steps":
            words, epoch = _stale_words(fb, gs[0].device)
            gs.append(gs[0] * 0.5)
            got.append(fb.floor_bench(gs[-1], cm, **kw))
            torch.cuda.synchronize()
            assert fb.scratch_of(gs[0].device)[0].data_ptr() == \
                words.data_ptr()
            assert fb.scratch_of(gs[0].device)[1] == epoch + 1
        for g, out in zip(gs, got):
            ref, written = fb.floor_bench_plain(g.double(), cm, **kw)
            last = (cm >> 25) & 1 == 1
            if dyn_out:
                last &= (cm & 0xFFFFFF) < n_tiles
            assert bool(written.any()) == bool(last.any()), name
            if written.any():
                assert _rel_written(out, ref, written) <= 1e-5, name


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["A dyn-out", "B cmaj-out",
                                  "E cmaj-out +1 dyn-in",
                                  "F cmaj-out +2 dyn-in",
                                  "G cmaj-out +2 cmaj-in"])
def test_floor_bench2_kernel_matches_plain(cuda, name):
    """Each variant on each of `_floor_cases` (ranges of 32 steps of 128
    rows), with distinct inputs, each called twice in a row on different
    gdata and inputs, against the float64 plain version; one launch a
    call; at 9216 steps a third call after `_stale_words`."""
    from gaussianrpg_tpu_torch.tools import floor_bench as fb
    from gaussianrpg_tpu_torch.tools import floor_bench2 as fb2

    n_tiles, n_pix = 5, 100
    n_in, dyn_in, dyn_out = fb2.VARIANTS[name]
    gen = torch.Generator(device=cuda).manual_seed(3)
    kw = dict(dyn_in=dyn_in, dyn_out=dyn_out, n_tiles=n_tiles, n_pix=n_pix)
    r = fb.RANGE_ROWS // fb2.BLOCK
    for case, cm in _floor_cases(r, n_tiles, n_in, cuda):
        n_steps = cm.shape[0]
        calls = [(torch.rand((n_steps * fb2.BLOCK, 16), generator=gen,
                             device=cuda),
                  [torch.rand((n_tiles if dyn_in else n_steps, 5, n_pix),
                              generator=gen, device=cuda)
                   for _ in range(n_in)]) for _ in range(2)]
        n0 = fb2.launches
        got = [fb2.floor_bench2(g, cm, ins, **kw) for g, ins in calls]
        torch.cuda.synchronize()
        assert fb2.launches == n0 + 2, case
        if case == "9216 steps":
            words, epoch = _stale_words(fb, cm.device)
            calls.append((calls[0][0] * 0.5, calls[0][1]))
            got.append(fb2.floor_bench2(calls[-1][0], cm, calls[-1][1],
                                        **kw))
            torch.cuda.synchronize()
            assert fb.scratch_of(cm.device)[0].data_ptr() == \
                words.data_ptr()
            assert fb.scratch_of(cm.device)[1] == epoch + 1
        for (g, ins), out in zip(calls, got):
            ref, written = fb2.floor_bench2_plain(
                g.double(), cm, [x.double() for x in ins], **kw)
            valid = (cm >> 26) & 1 == 1
            if dyn_out:
                valid &= (cm & 0xFFFFFF) < n_tiles
            assert bool(written.any()) == bool(valid.any()), case
            if written.any():
                assert _rel_written(out, ref, written) <= 1e-5, case


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["A", "B", "B+T"])
@pytest.mark.parametrize("g4,p,n_steps", [(64, 128, 1), (192, 640, 7),
                                          (512, 2048, 33)])
def test_mm_orient_kernel_matches_plain(cuda, form, g4, p, n_steps):
    """Each orientation at small and odd shapes (one block, several
    blocks and step splits), seeded uniform operands, against the float64
    plain version (1e-5 of its max)."""
    from gaussianrpg_tpu_torch.tools import mm_orient as mo

    gen = torch.Generator(device=cuda).manual_seed(g4 + n_steps)
    st = torch.rand((g4, p), generator=gen, device=cuda) * 2 - 1
    ba = torch.rand(mo.ba_shape(form, p), generator=gen, device=cuda) * 2 - 1
    x = torch.rand((n_steps,), generator=gen, device=cuda)
    n0 = mo.launches
    got = mo.mm_orient(form, st, ba, x)
    torch.cuda.synchronize()
    assert mo.launches == n0 + 1
    ref = mo.mm_orient_plain(form, st.double(), ba.double(), x.double())
    assert got.shape == ref.shape == mo.out_shape(form, g4)
    assert _rel_err(got.double(), ref) <= 1e-5


# --- kernels B and C on the cull test's adversarial pairs -------------------

def _adversarial_scene(tx, ty, s_ch, device):
    """gdata and chunk_meta of a 5x3-tile image holding every adversarial
    pair of tests/test_torch_blend_cull.py (centres in [0, 64]^2, on tile
    and block edges among them), each listed by the tile holding its
    rounded centre, 128 pairs to a chunk; random colours, depths and
    semantics."""
    from .test_torch_blend_cull import ADVERSARIAL, adversarial_rows

    ntx, nty = 5, 3
    rows = torch.cat([adversarial_rows(c) for c in ADVERSARIAL])
    rng = np.random.default_rng(6)
    n = rows.shape[0]
    rows[:, 6:10] = torch.as_tensor(rng.uniform(0, 1, (n, 4))
                                    .astype(np.float32))
    rows[:, 11:11 + s_ch] = torch.as_tensor(rng.uniform(0, 1, (n, s_ch))
                                            .astype(np.float32))
    tile_x = torch.clamp(torch.round(rows[:, 0]) // tx, 0, ntx - 1)
    tile_y = torch.clamp(torch.round(rows[:, 1]) // ty, 0, nty - 1)
    tile = (tile_y * ntx + tile_x).long()
    chunks, meta = [], []
    for t in range(ntx * nty):
        mine = rows[tile == t]
        if not mine.shape[0]:
            continue
        pad = -mine.shape[0] % 128
        mine = torch.cat([mine, torch.zeros((pad, rows.shape[1]))])
        k = mine.shape[0] // 128
        for i in range(k):
            meta.append(t | (i == 0) << 24 | (i == k - 1) << 25 | 1 << 26)
        chunks.append(mine)
    gdata = torch.cat(chunks).to(device)
    cm = torch.tensor(meta, dtype=torch.int32, device=device)
    return gdata, cm, dict(ntx=ntx, nty=nty, tx=tx, ty=ty, s_ch=s_ch)


@pytest.mark.cuda
@pytest.mark.parametrize("tx,ty,s_ch", [(16, 16, 0), (16, 16, 3),
                                        (64, 32, 0), (64, 32, 3)])
def test_blend_kernels_on_adversarial_pairs(cuda, tx, ty, s_ch):
    """Kernels B and C, whose warps cull pairs by rectangle, against their
    plain versions (which cull nothing) on the cull test's adversarial
    pairs: planes at the blend tolerances, gradients within 5e-5 of each
    column group's max."""
    gdata, cm, kw = _adversarial_scene(tx, ty, s_ch, cuda)
    bg = torch.tensor([0.1, 0.2, 0.3], device=cuda)
    start, end = blend.tile_chunk_ranges(cm, kw["ntx"] * kw["nty"])
    m = (start >= 0) & (end > start)
    got = blend.blend_forward(gdata, cm, bg, **kw)
    ref = blend.blend_forward_plain(gdata, cm, bg, **kw)
    _assert_planes_close(got[m], ref[m], s_ch)
    gen = torch.Generator(device=cuda).manual_seed(9)
    dout = torch.randn(got.shape, generator=gen, device=cuda)
    stat = dict(stat_width=80, stat_height=48)
    g_k = blend.blend_backward(gdata, cm, bg, got, dout, **kw, **stat)
    g_p = blend.blend_backward_plain(gdata, cm, bg, ref, dout, **kw, **stat)
    for cols in ([0, 1], [2, 3, 4], [5], [6, 7, 8], [9], [10],
                 list(range(11, 11 + s_ch))):
        if cols:
            assert _rel_err(g_k[:, cols], g_p[:, cols]) < 5e-5, cols


@pytest.mark.cuda
def test_yolo_card_matches_cpu(cuda):
    """YOLOv5s (seed-0 weights) on one letterboxed 1066x1600 frame: the
    card's decoded [15120, 85] predictions within 1e-4 + 1e-4 x each column
    group's max (xywh; obj and class scores) of the CPU path's, TF32 off."""
    from gaussianrpg_tpu_torch.sim import yolo

    img = np.random.default_rng(0).uniform(0, 1, (1066, 1600, 3)).astype(
        np.float32)
    boxed = torch.from_numpy(yolo.letterbox(img, (384, 640))[0])[None]
    spec = yolo.spec_yolov5()
    got = yolo.forward(spec, yolo.init_params(spec, 0, device=cuda),
                       boxed.to(cuda))[0].cpu()
    ref = yolo.forward(spec, yolo.init_params(spec, 0, device="cpu"),
                       boxed)[0]
    assert got.shape == (15120, 85)
    for cols in (slice(0, 4), slice(4, None)):
        err = float((got[:, cols] - ref[:, cols]).abs().max())
        assert err <= 1e-4 + 1e-4 * float(ref[:, cols].abs().max()), cols


@pytest.mark.cuda
def test_fused_step_matches_unfused_detector_on_card(cuda):
    """The fused step (letterbox, YOLOv5s and top-K on the card, NMS on the
    host) against the unfused detector (host letterbox, the graph on the
    card, NMS over the full prediction) on one image: the same detections
    (tests/test_torch_yolo.py's case, on the card)."""
    from gaussianrpg_tpu_torch.sim import pipeline, yolo
    from gaussianrpg_tpu_torch.sim.detector import VEHICLE_CLASSES

    H, W = 96, 160
    img = np.random.default_rng(3).uniform(0, 1, (3, H, W)).astype(
        np.float32)
    spec = yolo.spec_yolov5()
    params = yolo.init_params(spec, seed=1, device=cuda)
    step, gain, pad = pipeline.make_fused_step(
        lambda cam: torch.from_numpy(img).to(cuda), spec, params, (H, W),
        size=(64, 96), k=128, classes=VEHICLE_CLASSES)
    out = pipeline.finish_detections(step(None), gain, pad, (H, W),
                                     conf_thres=0.25)
    ref = yolo.YoloDetector(spec=spec, params=params, size=(64, 96),
                            conf_thres=0.25, classes=VEHICLE_CLASSES,
                            device=cuda)(img.transpose(1, 2, 0))
    assert ref.shape[0] > 5 and out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("tx,ty,emit", [(64, 32, True), (16, 16, True),
                                        (16, 16, False)])
def test_fused_step_waits_for_the_card_only_at_its_copy(cuda, tx, ty, emit,
                                                        monkeypatch):
    """The fused step's device part (render through `rasterize` on either
    binning path, letterbox, YOLOv5s, top-K) makes no host sync: under
    torch's sync debug mode it raises no warning once warmed up, so the
    copy of the [K, 6] candidates is the frame's one wait. Warmed up means
    the render's CUDA graph captured (the second call), so the armed call
    replays it."""
    import warnings

    monkeypatch.setattr(binning, "EMIT_PAIRS", emit)

    from gaussianrpg_tpu_torch.ops.rasterize import (graph_counts,
                                                     suggest_binning_sizes)
    from gaussianrpg_tpu_torch.sim import pipeline, yolo

    W, H = 320, 192
    cam, means, t = _scene(3000, W, H, 5, cuda)
    op, sem = t.pop("opacities"), t.pop("semantics")
    sizes = suggest_binning_sizes(primitive_fields(
        means, op, camera=cam, tile_x=tx, tile_y=ty, **t), width=W,
        height=H)
    bg = torch.zeros(3, device=cuda)

    def render(c):
        return rasterize(means, op, camera=c, bg_color=bg,
                         capacity=sizes.capacity, tile_x=tx, tile_y=ty,
                         tail_cap=sizes.tail_cap, big_cap=sizes.big_cap,
                         emit_k=sizes.emit_k, device=cuda, **t).color

    spec = yolo.spec_yolov5()
    step, _, _ = pipeline.make_fused_step(
        render, spec, yolo.init_params(spec, 0, device=cuda), (H, W),
        size=(192, 320), k=64)
    first = step(cam)
    np.testing.assert_array_equal(step(cam), first)
    torch.cuda.synchronize()
    replays = graph_counts["replays"]
    # armed outside the record: the first arming in a process warns once
    # from the call that arms it
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            cand = step.device_step(cam)
        with warnings.catch_warnings(record=True) as control:
            warnings.simplefilter("always")
            bool(cand[0, 4] > 0)          # a host read: must be seen
    finally:
        torch.cuda.set_sync_debug_mode("default")

    def syncs(ws):
        return [str(w.message)[:200] for w in ws
                if "synchroniz" in str(w.message)]

    assert not syncs(seen), syncs(seen)
    assert syncs(control)
    assert graph_counts["replays"] == replays + 1
    np.testing.assert_array_equal(cand.cpu().numpy(), first)


@pytest.mark.cuda
def test_render_app_on_card_matches_cpu(cuda, tmp_path):
    """`apps.render` on the synthetic scene (as built: no checkpoint) on
    the card and on the CPU: the same files, PNGs within 1/255; both
    launch their kernels only on the card: kernel B once a frame, and
    once more for each capture of the render's CUDA graph (its warm-up
    run)."""
    import os

    from gaussianrpg_tpu_torch.apps import render
    from gaussianrpg_tpu_torch.data.image_io import read_png
    from gaussianrpg_tpu_torch.ops.rasterize import graph_counts

    outs = {}
    for dev in ("cuda", "cpu"):
        out = tmp_path / dev
        before = blend.launches
        captures = graph_counts["captures"]
        render.main(["--device", dev, "model_path", str(out),
                     "render.save_video", "False"])
        outs[dev] = (out / "evaluate_train", blend.launches - before,
                     graph_counts["captures"] - captures)
    assert outs["cuda"][1] == 10 + outs["cuda"][2] and outs["cpu"][1] == 0
    assert outs["cpu"][2] == 0
    names = sorted(os.listdir(outs["cuda"][0]))
    assert names == sorted(os.listdir(outs["cpu"][0])) and len(names) == 10
    for n in names:
        a = read_png(str(outs["cuda"][0] / n)).astype(int)
        b = read_png(str(outs["cpu"][0] / n)).astype(int)
        assert np.abs(a - b).max() <= 1, n


@pytest.mark.cuda
def test_metrics_and_lpips_on_card_match_cpu(cuda, tmp_path):
    """`apps.metrics.evaluate_dir` with VGG16 LPIPS weights (random, in
    the torchvision / richzhang layouts) on the card against the CPU path,
    TF32 off: PSNR and SSIM within 1e-5, LPIPS within 1e-4, relative."""
    from gaussianrpg_tpu_torch.apps.metrics import evaluate_dir
    from gaussianrpg_tpu_torch.data.image_io import write_png
    from gaussianrpg_tpu_torch.utils.lpips import (VGG16_SPEC, init_params,
                                                   save_torch_lpips)

    rng = np.random.default_rng(5)
    d = tmp_path / "evaluate_train"
    d.mkdir()
    for n in ("000", "001"):
        a = rng.integers(0, 255, (96, 128, 3), dtype=np.uint8)
        b = np.clip(a + rng.integers(-20, 20, a.shape), 0,
                    255).astype(np.uint8)
        write_png(str(d / f"{n}_rgb.png"), a)
        write_png(str(d / f"{n}_gt.png"), b)
    save_torch_lpips(VGG16_SPEC, init_params(VGG16_SPEC, 0),
                     str(tmp_path / "vgg.pth"), str(tmp_path / "lin.pth"))
    cfg = {"backbone_path": str(tmp_path / "vgg.pth"),
           "lin_path": str(tmp_path / "lin.pth"), "net_type": "vgg"}
    got, _ = evaluate_dir(str(d), cfg, device="cuda")
    ref, _ = evaluate_dir(str(d), cfg, device="cpu")
    assert got["n_views"] == ref["n_views"] == 2
    for k, rtol in (("psnr", 1e-5), ("ssim", 1e-5), ("lpips", 1e-4)):
        assert got[k] == pytest.approx(ref[k], rel=rtol), k
