"""The port's tile binning held against the JAX package on the CPU: every
PairLists field equal element for element, on the emission path and on
the marker path (EMIT_PAIRS flipped in both packages, as
tests/test_pallas.py does), including rank mode, the compacted tail,
sub-chunk alignment, the fused-fill capacity and overflow, a street-like
table whose inactive slots trail the depth order, and a long padding run
in the compacted tail. The marker scatter's helper is held to the plain
atomic formula on sorted and unsorted input."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from gaussianrpg_tpu.ops import binning as jb  # noqa: E402

from gaussianrpg_tpu_torch.ops import binning as tb  # noqa: E402

from .torch_parity import one_cpu_thread, tt  # noqa: E402,F401

FIELDS = ("pair_src", "pair_valid", "tile_nonempty", "chunk_meta",
          "raw_total", "padded_total")


@pytest.fixture
def emit_flag():
    """Set EMIT_PAIRS in both packages; restore afterwards."""
    old = (jb.EMIT_PAIRS, tb.EMIT_PAIRS)

    def set_(v):
        jb.EMIT_PAIRS = tb.EMIT_PAIRS = v
    yield set_
    jb.EMIT_PAIRS, tb.EMIT_PAIRS = old


def _rects(seed, n, ntx, nty, max_w=5, max_h=4):
    rng = np.random.default_rng(seed)
    x0 = rng.integers(0, ntx, n)
    y0 = rng.integers(0, nty, n)
    x1 = np.minimum(x0 + rng.integers(0, max_w, n), ntx)
    y1 = np.minimum(y0 + rng.integers(0, max_h, n), nty)
    return (np.stack([x0, y0], -1).astype(np.int32),
            np.stack([x1, y1], -1).astype(np.int32), rng.random(n) < 0.9,
            rng)


def _assert_same(a, b):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(b, f).numpy(),
                                      np.asarray(getattr(a, f)), err_msg=f)
    assert bool(b.overflowed) == bool(a.overflowed)
    assert (b.n_tiles_x, b.n_tiles_y, b.capacity) == (
        a.n_tiles_x, a.n_tiles_y, a.capacity)


@pytest.mark.parametrize("emit", [True, False])
@pytest.mark.parametrize("case", [
    dict(W=96, H=64, tile=(16, 16), capacity=8192, sub=1),
    dict(W=96, H=64, tile=(16, 16), capacity=65536, sub=2),
    dict(W=256, H=128, tile=(64, 32), capacity=8192, sub=1, max_w=3),
    dict(W=96, H=64, tile=(16, 16), capacity=256, sub=1),     # overflow
])
def test_build_pair_lists_matches(emit_flag, emit, case):
    emit_flag(emit)
    W, H = case["W"], case["H"]
    tx, ty = case["tile"]
    ntx, nty = jb.tile_grid_dims(W, H, tx, ty)
    rmin, rmax, vis, _ = _rects(7, 300, ntx, nty, case.get("max_w", 5))
    kw = dict(capacity=case["capacity"], tile_x=tx, tile_y=ty,
              sub_chunks=case["sub"])
    a = jb.build_pair_lists(jnp.asarray(rmin), jnp.asarray(rmax),
                            jnp.asarray(vis), W, H, **kw)
    b = tb.build_pair_lists(tt(rmin), tt(rmax), tt(vis), W, H, **kw)
    _assert_same(a, b)
    if case["capacity"] == 256:
        assert bool(b.overflowed)


@pytest.mark.parametrize("emit_k,tail_cap,big_cap", [(1, None, None),
                                                     (2, 1024, 128),
                                                     (4, 256, 16)])
def test_emission_rank_and_tail_match(emit_k, tail_cap, big_cap):
    """Rank mode (inputs in original order) with the compacted tail of
    rects wider than emit_k, including a tail that overflows."""
    W, H = 96, 64
    ntx, nty = jb.tile_grid_dims(W, H)
    rmin, rmax, vis, rng = _rects(3, 300, ntx, nty)
    rank = rng.permutation(300).astype(np.int32)
    kw = dict(capacity=8192, emit_k=emit_k, tail_cap=tail_cap,
              big_cap=big_cap)
    a = jb.build_pair_lists(jnp.asarray(rmin), jnp.asarray(rmax),
                            jnp.asarray(vis), W, H,
                            rank=jnp.asarray(rank), **kw)
    b = tb.build_pair_lists(tt(rmin), tt(rmax), tt(vis), W, H,
                            rank=tt(rank), **kw)
    _assert_same(a, b)


@pytest.mark.parametrize("p", [1000, 65536, 65536 * 3 + 128])
def test_fill_matches_xla_cummax(p):
    """The binning's running-max fill (kernel A's plain version here, the
    marks zero-padded to a multiple of 65536) equals XLA's cummax, which
    the JAX package uses for such lengths."""
    rng = np.random.default_rng(p)
    marks = np.zeros(p, np.int32)
    pos = rng.integers(0, p, 50)
    marks[pos] = rng.integers(1, 1 << 30, 50)
    got = tb._fill(tt(marks))
    assert got.shape == (p,)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax.lax.cummax(jnp.asarray(marks))))


def test_marker_path_kernel_a_capacity(emit_flag):
    """A capacity that is a multiple of 65536, where the JAX package's
    marker fills go through its fused_cummax too."""
    emit_flag(False)
    W, H = 160, 96
    ntx, nty = jb.tile_grid_dims(W, H)
    rmin, rmax, vis, _ = _rects(9, 600, ntx, nty)
    a = jb.build_pair_lists(jnp.asarray(rmin), jnp.asarray(rmax),
                            jnp.asarray(vis), W, H, capacity=65536)
    b = tb.build_pair_lists(tt(rmin), tt(rmax), tt(vis), W, H,
                            capacity=65536)
    _assert_same(a, b)
    assert int(b.pair_valid.sum()) == int(b.raw_total)


def _scatter_max_drop(size, idx, vals):
    """The scatter-max formula the helper had: out-of-range entries to one
    shared slot `size`, then the atomic amax over every entry."""
    out = torch.zeros(size + 1, dtype=torch.int32)
    keep = (idx >= 0) & (idx < size)
    idx = torch.where(keep, idx, torch.full_like(idx, size)).long()
    return out.scatter_reduce_(0, idx, vals, "amax")[:size]


def _scatter_case(name, rng):
    n = 4000
    up = np.arange(1, n + 1)
    if name == "sorted_runs":
        # offsets of depth-sorted rects: runs where the area is 0, and a
        # trailing run of 75% of the entries at the total
        area = rng.integers(0, 4, n) * (rng.random(n) < 0.7)
        area[n // 4:] = 0
        return 6000, np.cumsum(area) - area, up
    if name == "unsorted_repeats":
        return 64, rng.integers(0, 64, n), rng.integers(-50, 1 << 20, n)
    if name == "out_of_range":
        # runs of negative and of >= size indices among in-range ones
        idx = np.repeat(rng.integers(-40, 140, n // 8), 8)
        return 100, idx, up
    if name == "run_at_size":
        idx = np.sort(rng.integers(0, 500, n))
        idx[-n // 2:] = 500
        return 500, idx, up
    if name == "values_not_increasing":
        idx = np.repeat(np.arange(n // 10), 10)
        return n // 10, idx, rng.integers(0, 30, n)
    if name == "decreasing_in_runs":
        idx = np.sort(rng.integers(0, 300, n))
        return 300, idx, up[::-1].copy()
    if name == "single":
        return 4, np.array([2]), np.array([5])
    assert name == "empty"
    return 4, np.zeros(0, np.int64), np.zeros(0, np.int64)


@pytest.mark.parametrize("name", [
    "sorted_runs", "unsorted_repeats", "out_of_range", "run_at_size",
    "values_not_increasing", "decreasing_in_runs", "single", "empty"])
def test_scatter_max_equals_the_atomic_formula(name):
    """`_scatter_max` routes superseded and out-of-range entries to private
    slots; the result equals the plain formula element for element, on
    sorted and unsorted input."""
    size, idx, vals = _scatter_case(name, np.random.default_rng(len(name)))
    idx, vals = idx.astype(np.int32), vals.astype(np.int32)
    got = tb._scatter_max(size, tt(idx), tt(vals))
    ref = _scatter_max_drop(size, tt(idx), tt(vals))
    assert got.shape == (size,) and got.dtype == torch.int32
    assert torch.equal(got, ref)
    if name == "sorted_runs":         # the trailing run is there
        assert len(idx) - len(np.unique(idx)) >= 3 * len(idx) // 4 - 1


def _street_rects(seed, n, ntx, nty, active):
    """Depth-sorted rects as the street frame has them: `active` visible
    rects (a few degenerate), then inactive slots with zero rects."""
    rmin, rmax, vis, _ = _rects(seed, n, ntx, nty)
    vis[active:] = False
    rmin[active:] = rmax[active:] = 0
    return rmin, rmax, vis


def test_marker_path_street_layout(emit_flag):
    """The marker path on a street-like table: 80% of the slots inactive
    at the end of the depth order, `raw_total` below the capacity, so the
    marker scatter's trailing run is 1600 entries long. Equal to the JAX
    package."""
    emit_flag(False)
    W, H, n, active = 96, 64, 2000, 400
    ntx, nty = jb.tile_grid_dims(W, H)
    rmin, rmax, vis = _street_rects(11, n, ntx, nty, active)
    a = jb.build_pair_lists(jnp.asarray(rmin), jnp.asarray(rmax),
                            jnp.asarray(vis), W, H, capacity=8192)
    b = tb.build_pair_lists(tt(rmin), tt(rmax), tt(vis), W, H,
                            capacity=8192)
    _assert_same(a, b)
    assert 0 < int(b.raw_total) < 8192 and not bool(b.overflowed)


def test_emission_path_long_tail_padding():
    """The emission path with `big_cap` well above the rects wider than
    K: `markb`'s padding rows past `n_big` form one run. Equal to the JAX
    package."""
    W, H, n, big_cap = 96, 64, 300, 256
    ntx, nty = jb.tile_grid_dims(W, H)
    rmin, rmax, vis = _street_rects(5, n, ntx, nty, 150)
    kw = dict(capacity=8192, tail_cap=2048, big_cap=big_cap)
    a = jb.build_pair_lists(jnp.asarray(rmin), jnp.asarray(rmax),
                            jnp.asarray(vis), W, H, **kw)
    b = tb.build_pair_lists(tt(rmin), tt(rmax), tt(vis), W, H, **kw)
    _assert_same(a, b)
    assert not bool(b.overflowed)
    area = np.where(vis, np.clip(rmax - rmin, 0, None).prod(-1), 0)
    n_big = int(np.sum(area > tb.EMIT_K))
    assert 0 < n_big < big_cap // 2
