"""Kernel A's single-pass scan (csrc/cummax.cu), emulated in plain Python on
the CPU and held against `fused_cummax_plain` and the JAX package's Pallas
`fused_cummax` in interpret mode, before any card time is spent on it.

The emulation mirrors the kernel's two halves:
- within a tile, its register arrangement: warp w owns kItems/4 rows of
  128 contiguous elements, a lane one int4 of each row; each int4 is
  scanned in place, each row across the lanes, the rows by a running
  carry, the warps through their totals (`tile_scan`);
- across tiles, the decoupled look-back: tiles taken by ticket (ticket i is
  tile i // k of array i % k), each (array, tile) with one 64-bit status
  word (state << 32) | value, zeroed before the launch; a tile publishes
  its aggregate, reads a window of predecessors at a time (a tile a lane
  of the look-back warp, waiting while any is not ready), takes the
  nearest inclusive prefix and the aggregates after it, publishes its own
  prefix and writes its outputs. Blocks are
  advanced in a seeded random interleaving, with at most `resident` of them
  running, each step one round of reads or one write of the status words.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from gaussianrpg_tpu.ops.pallas_scan import \
    fused_cummax as j_fused_cummax  # noqa: E402

from gaussianrpg_tpu_torch.ops import scan  # noqa: E402
from gaussianrpg_tpu_torch.tools import blend_floor as bf  # noqa: E402
from gaussianrpg_tpu_torch.tools import scan_bench  # noqa: E402

from .torch_parity import one_cpu_thread  # noqa: E402,F401

INT_MIN, INT_MAX = -2 ** 31, 2 ** 31 - 1
# the kernel's status states (csrc/cummax.cu); 0 is what the memset leaves
NOT_READY, AGGREGATE, PREFIX = 0, 1, 2
THREADS, ITEMS = 256, 64   # the kernel's block and int32 a thread


def pack(state: int, v: int) -> int:
    return (state << 32) | (v & 0xFFFFFFFF)


def state_of(s: int) -> int:
    return s >> 32


def value_of(s: int) -> int:
    v = s & 0xFFFFFFFF
    return v - (1 << 32) if v >= 1 << 31 else v


def tile_scan(seg: np.ndarray, threads: int, items: int):
    """(inclusive running max of one tile, its aggregate), computed in the
    kernel's register arrangement: [warps, rows, lanes, 4]."""
    warps, rows = threads // 32, items // 4
    q = seg.astype(np.int64).reshape(warps, rows, 32, 4)
    q = np.maximum.accumulate(q, axis=3)                 # within an int4
    incl = np.maximum.accumulate(q[..., 3], axis=2)      # across lanes
    before = np.concatenate([np.full((warps, rows, 1), INT_MIN),
                             incl[:, :, :-1]], axis=2)
    row_tot = incl[:, :, 31]
    carry = np.concatenate([np.full((warps, 1), INT_MIN),
                            np.maximum.accumulate(row_tot, axis=1)[:, :-1]],
                           axis=1)
    pre = np.maximum(before, carry[:, :, None])          # [warps, rows, 32]
    warp_tot = np.maximum.accumulate(row_tot, axis=1)[:, -1]
    wpre = np.concatenate([[INT_MIN], np.maximum.accumulate(warp_tot)[:-1]])
    pre = np.maximum(pre, wpre[:, None, None])
    out = np.maximum(q, pre[..., None]).reshape(-1)
    return out, int(warp_tot.max())


def tile_program(j, t, xs, outs, status, tile, threads, items, lanes):
    """One block's life for tile t of array j; yields between steps (one
    round of status reads or one write each). The look-back warp has
    `lanes` lanes; lane l reads tile last - l."""
    local, agg = tile_scan(xs[j][t * tile:(t + 1) * tile], threads, items)
    st_j = status[j]
    excl = INT_MIN
    if t == 0:
        st_j[0] = pack(PREFIX, agg)
        yield
    else:
        st_j[t] = pack(AGGREGATE, agg)
        yield
        last = t - 1
        while True:
            idx = [last - lane for lane in range(lanes)]
            words = [st_j[i] if i >= 0 else pack(PREFIX, INT_MIN)
                     for i in idx]
            yield
            while any(state_of(w) == NOT_READY for w in words):
                words = [st_j[i] if state_of(w) == NOT_READY else w
                         for i, w in zip(idx, words)]
                yield
            # the nearest prefix (lowest lane) and the aggregates before it
            pm = [lane for lane, w in enumerate(words)
                  if state_of(w) == PREFIX]
            upto = pm[0] + 1 if pm else lanes
            excl = max([excl] + [value_of(w) for w in words[:upto]])
            if pm:
                break
            last -= lanes
        st_j[t] = pack(PREFIX, max(excl, agg))
        yield
    outs[j][t * tile:(t + 1) * tile] = np.maximum(local, excl)


def lookback_scan(xs, *, threads=THREADS, items=ITEMS, lanes=32,
                  resident=8, seed=0):
    """Kernel A's result on the int32 arrays xs (each a multiple of the
    tile long), its blocks advanced in a seeded random interleaving."""
    k, p = len(xs), len(xs[0])
    tile = threads * items
    assert p % tile == 0
    tiles = p // tile
    rng = np.random.default_rng(seed)
    status = [[0] * tiles for _ in range(k)]   # the memset
    outs = [np.zeros(p, np.int64) for _ in range(k)]
    ticket, running = 0, []
    while ticket < k * tiles or running:
        start = ticket < k * tiles and (
            len(running) < resident and (not running or rng.random() < 0.5))
        if start:
            running.append(tile_program(ticket % k, ticket // k, xs, outs,
                                        status, tile, threads, items,
                                        lanes))
            ticket += 1
            continue
        i = int(rng.integers(len(running)))
        try:
            next(running[i])
        except StopIteration:
            running.pop(i)
    assert all(state_of(s) == PREFIX for st_j in status for s in st_j)
    return [o.astype(np.int32) for o in outs]


def plain(xs):
    return [x.numpy() for x in scan.fused_cummax_plain(
        [torch.as_tensor(x) for x in xs])]


def assert_same(got, ref):
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("v", [INT_MIN, -1, 0, INT_MAX])
def test_status_word_round_trip(v):
    """State and value share one 64-bit word and come back apart intact;
    the memset's zero word reads as not ready."""
    assert state_of(0) == NOT_READY
    for state in (NOT_READY, AGGREGATE, PREFIX):
        s = pack(state, v)
        assert 0 <= s < 1 << 64
        assert (state_of(s), value_of(s)) == (state, v)


@pytest.mark.parametrize("seed", range(6))
def test_lookback_interleavings(seed):
    """Small tiles and a narrow window (1-3 lanes), so that a look-back
    crosses several windows and waits on tiles not yet ready; k = 1..3
    arrays."""
    rng = np.random.default_rng(100 + seed)
    k = seed % 3 + 1
    xs = [rng.integers(-50, 50, 64 * 24).astype(np.int32) for _ in range(k)]
    got = lookback_scan(xs, threads=32, items=4, lanes=seed % 3 + 1,
                        resident=1 + seed, seed=seed)
    assert_same(got, plain(xs))


@settings(max_examples=40, deadline=None)
@given(n_tiles=st.integers(1, 24), k=st.integers(1, 4),
       threads=st.sampled_from([32, 64, 128]),
       items=st.sampled_from([4, 8, 16, 64]),
       lanes=st.sampled_from([1, 2, 5, 32]),
       resident=st.integers(1, 12), spread=st.integers(1, 2 ** 31 - 1),
       seed=st.integers(0, 2 ** 16))
def test_lookback_hypothesis(n_tiles, k, threads, items, lanes, resident,
                             spread, seed):
    rng = np.random.default_rng(seed)
    p = n_tiles * threads * items
    xs = [np.clip(rng.integers(-spread, spread, p), INT_MIN, INT_MAX)
          .astype(np.int32) for _ in range(k)]
    got = lookback_scan(xs, threads=threads, items=items, lanes=lanes,
                        resident=resident, seed=seed)
    assert_same(got, plain(xs))


PATTERNS = ["marks", "int_min", "decreasing", "max_first", "max_last",
            "random"]


@pytest.mark.parametrize("pattern", PATTERNS)
def test_lookback_patterns_match_pallas(pattern):
    """The kernel's own tile (256 x 64) and look-back (32 lanes), two 64K
    blocks, k
    = 2: the emulation, the plain version and the Pallas kernel in
    interpret mode agree element for element on each pattern."""
    p, k = 65536 * 2, 2
    gen = torch.Generator().manual_seed(PATTERNS.index(pattern))
    xs = [x.numpy() for x in scan_bench.patterns(p, k, gen, "cpu")[pattern]]
    ref = plain(xs)
    assert_same(lookback_scan(xs, seed=PATTERNS.index(pattern)), ref)
    assert_same(j_fused_cummax([jnp.asarray(x) for x in xs],
                               interpret=True), ref)


def test_patterns_are_the_named_shapes():
    """`scan_bench.patterns`, which the card tests and chip_smoke.py check
    kernel A on, gives the shapes it names."""
    p = 65536
    xs = scan_bench.patterns(p, 3, torch.Generator().manual_seed(0), "cpu")
    assert set(xs) == set(PATTERNS)
    for arrays in xs.values():
        assert len(arrays) == 3
        assert all(x.dtype == torch.int32 and x.shape == (p,)
                   for x in arrays)
    assert all(bool((x == INT_MIN).all()) for x in xs["int_min"])
    assert all(bool((x[1:] < x[:-1]).all()) for x in xs["decreasing"])
    assert all(int(x[0]) == INT_MAX and int(x[1:].max()) < INT_MAX
               for x in xs["max_first"])
    assert all(int(x[-1]) == INT_MAX and int(x[:-1].max()) < INT_MAX
               for x in xs["max_last"])
    m = xs["marks"][0]
    assert int(m.min()) == 0 and 0 < int((m > 0).sum()) <= p // 50


def test_measure_on_cpu_is_exact():
    """`scan_bench.measure` on the CPU (the plain version through the
    wrapper): every pattern exact, the bound 8 k P bytes at 3.35 TB/s."""
    rec = scan_bench.measure(65536, 2, "cpu", n_marks=100, reps=1)
    assert rec["max_abs_err"] == 0 and set(rec["errors"]) == set(PATTERNS)
    assert rec["bound_ms"] == pytest.approx(8 * 2 * 65536 / 3.35e12 * 1e3)
    assert scan.launches == 0


def test_range_counts():
    """`blend_floor.range_counts`: chunks in the written tiles' ranges and
    the longest range, tiles without a range left out."""
    start = torch.tensor([0, -1, 3, 7, 9], dtype=torch.int32)
    end = torch.tensor([3, -1, 4, 7, 14], dtype=torch.int32)
    assert bf.range_counts(start, end) == dict(chunks_in_ranges=9,
                                               max_tile_chunks=5)
    none = torch.full((3,), -1, dtype=torch.int32)
    assert bf.range_counts(none, none) == dict(chunks_in_ranges=0,
                                               max_tile_chunks=0)
