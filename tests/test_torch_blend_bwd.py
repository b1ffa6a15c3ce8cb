"""The port's training blend and binning held against the JAX package on
the CPU: kernel C's plain version against the VJP of the Pallas blend
(interpret mode) at 5e-5 relative to each column group's max
(tests/test_pallas.py:56-77), the training outputs of the binning
element for element, and the pair-gather backward's pieces (segment sum,
prefix sums, permutation take). The `rasterize` gradients are in
tests/test_torch_raster_grad.py. Pixels whose skip (1/255) or stop
(1e-4) test lands within float32 rounding of its threshold are found in
float64 and their cotangent is zeroed: XLA's and PyTorch's exp differ by
an ulp and may decide them either way."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from gaussianrpg_tpu.ops import binning as jb  # noqa: E402
from gaussianrpg_tpu.ops import pallas_blend as jpb  # noqa: E402
from gaussianrpg_tpu.ops import rasterize as jr  # noqa: E402

from gaussianrpg_tpu_torch.ops import binning as tb  # noqa: E402
from gaussianrpg_tpu_torch.ops import blend as tblend  # noqa: E402
from gaussianrpg_tpu_torch.ops import rasterize as tr  # noqa: E402

from .conftest import random_gaussians  # noqa: E402
from .torch_parity import (camera_pair, one_cpu_thread,  # noqa: E402,F401
                           threshold_pixels, tt)

BG = np.array([0.1, 0.2, 0.3], np.float32)
GRAD_RTOL = 5e-5     # relative to the column's (or gradient's) max


def _assert_grad(got, ref, what="", rtol=GRAD_RTOL):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    scale = np.abs(ref).max() + 1e-8
    err = np.abs(got - ref).max() / scale
    assert err < rtol, (what, err)


def _scene(n, seed, W, H, cam_seed=None, s_ch=0):
    rng = np.random.default_rng(seed)
    jc, tc = camera_pair(W, H, seed=cam_seed)
    means, scales, q, opac, colors = random_gaussians(n, rng)
    sem = rng.uniform(0, 1, (n, s_ch)).astype(np.float32) if s_ch else None
    return jc, tc, dict(means=means, scales=scales, q=q, opac=opac,
                        colors=colors, sem=sem), rng


def _jax_lists(lists, tx, ty, sub):
    return jb.PairLists(
        pair_src=jnp.asarray(lists.pair_src.numpy()),
        pair_valid=jnp.asarray(lists.pair_valid.numpy()),
        tile_nonempty=jnp.asarray(lists.tile_nonempty.numpy()),
        chunk_meta=jnp.asarray(lists.chunk_meta.numpy()),
        raw_total=jnp.asarray(lists.raw_total.numpy()),
        padded_total=jnp.asarray(lists.padded_total.numpy()),
        n_tiles_x=lists.n_tiles_x, n_tiles_y=lists.n_tiles_y,
        capacity=lists.capacity, tile_x=tx, tile_y=ty, sub_chunks=sub)


@pytest.mark.parametrize("tile,s_ch,sub", [((16, 16), 0, 1),
                                           ((16, 16), 5, 2),
                                           ((64, 32), 0, 1),
                                           ((64, 32), 5, 1)])
def test_plain_blend_backward_matches_pallas_vjp(tile, s_ch, sub):
    """Identical gdata / chunk_meta / cotangent into both blends' VJPs;
    every gradient column group at 5e-5 of its max."""
    W, H = 96, 64
    tx, ty = tile
    jc, tc, g, rng = _scene(300, 4, W, H, cam_seed=3, s_ch=s_ch)
    fs = tr.primitive_fields(
        tt(g["means"]), tt(g["opac"]), camera=tc, colors=tt(g["colors"]),
        scales=tt(g["scales"]), rotations=tt(g["q"]),
        semantics=None if g["sem"] is None else tt(g["sem"]), tile_x=tx,
        tile_y=ty)
    gdata, lists = tr.pair_rows(fs, width=W, height=H, capacity=16384,
                                sub_chunks=sub)
    assert not bool(lists.overflowed)
    near = threshold_pixels(fs.fields, fs.radii, fs.depths, W, H)
    assert near.sum() <= near.size // 200
    ct = rng.standard_normal((5 + s_ch, H, W)).astype(np.float32)
    ct[:, near] = 0.0
    stat = dict(stat_width=2 * W, stat_height=H + 7)

    gd = gdata.detach().clone().requires_grad_(True)
    out = tblend.blend_pairs(gd, lists, tt(BG), width=W, height=H,
                             s_ch=s_ch, **stat)
    (got,) = torch.autograd.grad(out, gd, grad_outputs=tt(ct))
    assert tblend.bwd_launches == 0

    def f(x):
        return jpb.blend_pairs(x, _jax_lists(lists, tx, ty, sub),
                               jnp.asarray(BG), jnp.zeros((x.shape[0],)),
                               width=W, height=H, s_ch=s_ch, interpret=True,
                               **stat)
    _, vjp = jax.vjp(f, jnp.asarray(gdata.numpy()))
    (ref,) = vjp(jnp.asarray(ct))
    ref = np.asarray(ref)
    got = got.numpy()
    groups = {"mean": [0, 1], "conic": [2, 3, 4], "opacity": [5],
              "color": [6, 7, 8], "depth": [9], "absgrad": [10]}
    if s_ch:
        groups["semantic"] = list(range(11, 11 + s_ch))
    for name, cols in groups.items():
        _assert_grad(got[:, cols], ref[:, cols], name)
    # columns past 11+S (spare / packed) carry no gradient
    assert not got[:, 11 + s_ch:].any()
    assert np.abs(ref[:, 10]).max() > 0


def test_blend_backward_wrapper_is_plain_on_cpu():
    """On CPU tensors the wrapper is the plain version (no launch), and
    unwritten tiles' and padding slots come back zero."""
    W, H = 96, 64
    _, tc, g, rng = _scene(600, 8, W, H)
    fs = tr.primitive_fields(tt(g["means"]), tt(g["opac"]), camera=tc,
                             colors=tt(g["colors"]), scales=tt(g["scales"]),
                             rotations=tt(g["q"]))
    gdata, lists = tr.pair_rows(fs, width=W, height=H, capacity=1024)
    assert bool(lists.overflowed)
    kw = dict(ntx=lists.n_tiles_x, nty=lists.n_tiles_y, tx=16, ty=16,
              s_ch=0)
    out = tblend.blend_forward(gdata, lists.chunk_meta, tt(BG), **kw)
    dout = torch.as_tensor(rng.standard_normal(out.shape).astype(np.float32))
    a = tblend.blend_backward(gdata, lists.chunk_meta, tt(BG), out, dout,
                              stat_width=W, stat_height=H, **kw)
    b = tblend.blend_backward_plain(gdata, lists.chunk_meta, tt(BG), out,
                                    dout, stat_width=W, stat_height=H, **kw)
    assert torch.equal(a, b)
    assert tblend.bwd_launches == 0
    start, end = tblend.tile_chunk_ranges(lists.chunk_meta,
                                          kw["ntx"] * kw["nty"])
    owned = torch.zeros(lists.chunk_meta.shape[0], dtype=torch.bool)
    for s, e in zip(start.tolist(), end.tolist()):
        if s >= 0 and e > s:
            owned[s:e] = True
    rows_owned = owned.repeat_interleave(128)
    assert not a[~rows_owned].any()
    assert not a[~lists.pair_valid].any()
    assert a[rows_owned].abs().sum() > 0


@pytest.fixture
def emit_flag():
    """Set EMIT_PAIRS in both packages; restore afterwards."""
    old = (jb.EMIT_PAIRS, tb.EMIT_PAIRS)

    def set_(v):
        jb.EMIT_PAIRS = tb.EMIT_PAIRS = v
        jr._rasterize_jit.clear_cache()   # the flag is read at trace time
    yield set_
    jb.EMIT_PAIRS, tb.EMIT_PAIRS = old
    jr._rasterize_jit.clear_cache()


@pytest.mark.parametrize("emit,derive", [(True, False), (True, True),
                                         (False, False)])
@pytest.mark.parametrize("case", [
    dict(tile=(16, 16), capacity=8192, sub=1),
    dict(tile=(16, 16), capacity=16384, sub=2, k=2),
    dict(tile=(64, 32), capacity=8192, sub=1, W=256, H=128),
    dict(tile=(16, 16), capacity=1024, sub=1),       # overflow
])
def test_build_pair_lists_training_outputs_match(emit_flag, emit, derive,
                                                 case):
    """pair_gm / seg_offs / seg_area / pair_tile (and every eval field)
    equal the JAX package's element for element."""
    emit_flag(emit)
    W, H = case.get("W", 96), case.get("H", 64)
    tx, ty = case["tile"]
    ntx, nty = jb.tile_grid_dims(W, H, tx, ty)
    rng = np.random.default_rng(11)
    n = 400
    x0 = rng.integers(0, ntx, n)
    y0 = rng.integers(0, nty, n)
    rmin = np.stack([x0, y0], -1).astype(np.int32)
    rmax = np.stack([np.minimum(x0 + rng.integers(0, 6, n), ntx),
                     np.minimum(y0 + rng.integers(0, 4, n), nty)],
                    -1).astype(np.int32)
    vis = rng.random(n) < 0.9
    kw = dict(capacity=case["capacity"], tile_x=tx, tile_y=ty,
              sub_chunks=case["sub"], ride_gm=True, emit_k=case.get("k"))
    extra = {}
    if emit:
        extra = dict(rank=rng.permutation(n).astype(np.int32),
                     derive_gm=derive)
    a = jb.build_pair_lists(jnp.asarray(rmin), jnp.asarray(rmax),
                            jnp.asarray(vis), W, H,
                            **kw, **{k: (jnp.asarray(v)
                                         if isinstance(v, np.ndarray) else v)
                                     for k, v in extra.items()})
    b = tb.build_pair_lists(tt(rmin), tt(rmax), tt(vis), W, H, **kw,
                            **{k: (tt(v) if isinstance(v, np.ndarray) else v)
                               for k, v in extra.items()})
    for f in ("pair_src", "pair_valid", "tile_nonempty", "chunk_meta",
              "raw_total", "padded_total", "pair_gm", "seg_offs",
              "seg_area", "pair_tile"):
        va, vb = getattr(a, f), getattr(b, f)
        assert (va is None) == (vb is None), f
        if va is not None:
            np.testing.assert_array_equal(vb.numpy(), np.asarray(va),
                                          err_msg=f)
    assert (b.pair_tile is not None) == (emit and derive)
    if case["capacity"] == 1024:
        assert bool(b.overflowed)


def test_segment_sum_matches_scatter_add():
    """The sort-free segment sum equals a float64 index_add_ of the pair
    cotangents onto their gaussians."""
    rng = np.random.default_rng(2)
    n, p, nf = 300, 4096, 16
    area = rng.integers(0, 6, n).astype(np.int32)
    offs = (np.cumsum(area) - area).astype(np.int32)
    total = int(area.sum())
    # a random tile-major placement of the expansion slots, padding = -1
    gm = np.full(p, -1, np.int32)
    slots = rng.permutation(p)[:total]
    gm[slots] = np.arange(total, dtype=np.int32)
    valid = (gm >= 0).astype(np.float32)
    d = rng.standard_normal((p, nf)).astype(np.float32)
    got = tr._unpermute_and_segment_sum(tt(d), tt(valid), tt(gm), tt(offs),
                                        tt(area))
    owner = np.repeat(np.arange(n), area)
    ref = torch.zeros((n, nf), dtype=torch.float64)
    ref.index_add_(0, torch.as_tensor(owner[gm[slots]]),
                   torch.as_tensor(d[slots], dtype=torch.float64))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("p", [4096, 4224])
def test_blocked_prefix_sums_match_float64(p):
    """The blocked column prefix sum (the form every device runs), with a
    capacity that is and one that is not a multiple of the block, equals
    a float64 cumulative sum."""
    assert p > tr.SCAN_BLOCK
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.standard_normal((p, 16)).astype(np.float32))
    got = tr._column_prefix_sums(x)
    ref = torch.cumsum(x.double(), dim=0).t()
    assert got.shape == (16, p)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-4)


def test_perm_take_backward_is_inverse_gather():
    rng = np.random.default_rng(4)
    x = torch.tensor(rng.standard_normal((50, 8)).astype(np.float32),
                     requires_grad=True)
    perm = torch.as_tensor(rng.permutation(50))
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(50)
    y = tr._PermTake.apply(x, perm, inv)
    ct = torch.as_tensor(rng.standard_normal((50, 8)).astype(np.float32))
    (gx,) = torch.autograd.grad(y, x, grad_outputs=ct)
    assert torch.equal(y, x[perm])
    assert torch.equal(gx, ct[inv])
