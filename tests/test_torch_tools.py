"""The port's tools (`gaussianrpg_tpu_torch/tools/`) held against the repo's
`tools/` Pallas microbenchmarks on the CPU.

The JAX tools define their kernels inside `main()`, so they cannot be
imported: each kernel body below is a verbatim copy, with the file and
line it was copied from, run by `pallas_call(..., interpret=True)` at a
small size on seeded numpy inputs. The port's plain version of the same
function takes the same inputs. Tolerances: the gather exact; the blend
inputs at the package's forward (rtol 1e-4, atol 1e-5, depth 1e-4) and
gradient (5e-5 of each column group's max) tolerances; the floor sums
rtol 1e-6 and mm_orient rtol 1e-5 of the largest magnitude. Unwritten
output blocks are NaN in interpret mode and unspecified in the port, so
the floor benches and the stripped blend bodies compare written blocks.
"""
import importlib
import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from gaussianrpg_tpu.ops import pallas_blend as jpb  # noqa: E402

from gaussianrpg_tpu_torch.ops import blend as tblend  # noqa: E402
from gaussianrpg_tpu_torch.ops import cuda_build  # noqa: E402
from gaussianrpg_tpu_torch.ops import gather as tgather  # noqa: E402
from gaussianrpg_tpu_torch.tools import _scene  # noqa: E402
from gaussianrpg_tpu_torch.tools import blend_floor as tbf  # noqa: E402
from gaussianrpg_tpu_torch.tools import floor_bench as tfb  # noqa: E402
from gaussianrpg_tpu_torch.tools import floor_bench2 as tfb2  # noqa: E402
from gaussianrpg_tpu_torch.tools import gather_fold as tgf  # noqa: E402
from gaussianrpg_tpu_torch.tools import mm_orient as tmm  # noqa: E402

from .conftest import random_gaussians  # noqa: E402
from .torch_parity import camera_pair, one_cpu_thread, tt  # noqa: E402,F401

TOOLS = ("gather_fold", "blend_floor", "floor_bench", "floor_bench2",
         "mm_orient", "bwd_ablate")
# the module holding a tool's launch counter, where it is not the tool's
COUNTER = {"gather_fold": "gaussianrpg_tpu_torch.ops.gather"}


def _rel_err(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


# --- gather_fold -----------------------------------------------------------

def _pallas_gather(fields, src, G, NF):
    """tools/gather_fold.py:40-74, interpret=True."""
    P = src.shape[0]
    n_chunks = P // G

    def kernel(src_ref, f_hbm, out_ref):
        # src_ref: this chunk's 128 row ids in SMEM (a full [P] i32
        # scalar-prefetch operand would be 4.7 MB — over the ~1 MB SMEM)
        def body(scratch, sem):
            def start(i, _):
                pltpu.make_async_copy(
                    f_hbm.at[src_ref[i]], scratch.at[i], sem).start()
                return 0

            jax.lax.fori_loop(0, G, start, 0)

            def wait(i, _):
                pltpu.make_async_copy(
                    f_hbm.at[src_ref[i]], scratch.at[i], sem).wait()
                return 0

            jax.lax.fori_loop(0, G, wait, 0)
            out_ref[...] = scratch[...]

        pl.run_scoped(
            body,
            scratch=pltpu.VMEM((G, NF), jnp.float32),
            sem=pltpu.SemaphoreType.DMA(()),
        )

    call = pl.pallas_call(
        kernel,
        grid=(n_chunks,),
        in_specs=[
            pl.BlockSpec((G,), lambda c: (c,), memory_space=pltpu.SMEM),
            pl.BlockSpec(memory_space=pltpu.ANY),
        ],
        out_specs=pl.BlockSpec((G, NF), lambda c: (c, 0)),
        out_shape=jax.ShapeDtypeStruct((P, NF), jnp.float32),
        interpret=True,
    )
    return np.asarray(call(jnp.asarray(src), jnp.asarray(fields)))


def test_gather_rows_matches_pallas_row_dma():
    """N=1000, P=1024: the port's gather equals the per-row-DMA kernel and
    the tool's own `jnp.take` baseline (gather_fold.py:36) bit for bit."""
    rng = np.random.default_rng(0)
    fields = rng.normal(0, 1, (1000, 16)).astype(np.float32)
    src = rng.integers(0, 1000, 1024).astype(np.int32)
    src[:2] = [0, 999]
    ref = _pallas_gather(fields, src, 128, 16)
    got = tgf.gather_rows(tt(fields), tt(src)).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        got, np.asarray(jnp.take(jnp.asarray(fields), jnp.asarray(src),
                                 axis=0)))
    assert tgather.launches == 0


def test_gather_rows_zeroes_padding_rows():
    """Row ids outside [0, N) (pair-list padding, -1) give zero rows, as
    the pair gather's `take * valid` does."""
    fields = tt(np.arange(48, dtype=np.float32).reshape(6, 8) + 1)
    src = torch.tensor([5, -1, 0, 6, 2], dtype=torch.int32)
    got = tgf.gather_rows(fields, src)
    assert torch.equal(got[[0, 2, 4]], fields[[5, 0, 2]])
    assert not got[[1, 3]].any()
    with pytest.raises(ValueError):
        tgf.gather_rows(torch.zeros((4, 6)), src)


# --- blend_floor ------------------------------------------------------------

def _small_pair_inputs(tx, ty, capacity):
    rng = np.random.default_rng(21)
    W, H = 192, 128
    _, cam = camera_pair(W, H, seed=2)
    means, scales, q, opac, colors = random_gaussians(1200, rng)
    args = tuple(tt(a) for a in (means, opac, colors, scales, q))
    return _scene.sorted_pair_inputs((cam, args, H, W), tx, ty, capacity)


def _blend_inputs(tx, ty):
    inp = _small_pair_inputs(tx, ty, 8192 if tx * ty > 256 else 16384)
    cm = inp.lists.chunk_meta
    return inp, {"real": (cm, inp.gdata),
                 "all-exec": (cm, torch.zeros_like(inp.gdata)),
                 "floor": (cm & ~tbf.VALID_BIT, inp.gdata)}


@pytest.mark.parametrize("tile", [(64, 32), (16, 16)])
def test_blend_floor_inputs_match_pallas_blend(tile):
    """The tool's three inputs through the Pallas forward and backward
    (`_blend_fns`, interpret mode; tools/blend_floor.py:69) and through
    the port's kernel B / C plain versions: forward planes on the tiles the
    port writes, gradients (from the real input's planes, cotangent ones,
    as the tool) per column group."""
    tx, ty = tile
    inp, inputs = _blend_inputs(tx, ty)
    lists = inp.lists
    ntx, nty = lists.n_tiles_x, lists.n_tiles_y
    cap, nf = inp.gdata.shape
    fwd_call, bwd_call = jpb._blend_fns(ntx, nty, 0, cap, nf, inp.width,
                                        inp.height, True, tx, ty, 1)
    kw = dict(ntx=ntx, nty=nty, tx=tx, ty=ty, s_ch=0)
    bg = np.zeros(3, np.float32)
    planes_j = fwd_call(jnp.asarray(lists.chunk_meta.numpy()),
                        jnp.asarray(bg), jnp.asarray(inp.gdata.numpy()))
    planes_t = tblend.blend_forward(inp.gdata, lists.chunk_meta, tt(bg),
                                    **kw)
    dout = np.ones(planes_t.shape, np.float32)
    n_written = {}
    for tag, (cm, g) in inputs.items():
        got = tblend.blend_forward(g, cm, tt(bg), **kw).numpy()
        ref = np.asarray(fwd_call(jnp.asarray(cm.numpy()), jnp.asarray(bg),
                                  jnp.asarray(g.numpy())))
        start, end = tblend.tile_chunk_ranges(cm, ntx * nty)
        w = ((start >= 0) & (end > start)).numpy()
        n_written[tag] = int(w.sum())
        np.testing.assert_allclose(got[w][:, [0, 1, 2, 4]],
                                   ref[w][:, [0, 1, 2, 4]], rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(got[w][:, 3], ref[w][:, 3], rtol=1e-4,
                                   atol=1e-4)
        d_t = tblend.blend_backward(g, cm, tt(bg), planes_t, tt(dout),
                                    stat_width=inp.width,
                                    stat_height=inp.height, **kw).numpy()
        d_j = np.asarray(bwd_call(jnp.asarray(cm.numpy()), jnp.asarray(bg),
                                  jnp.asarray(g.numpy()), planes_j,
                                  jnp.asarray(dout))).reshape(cap, -1)
        for cols in ([0, 1], [2, 3, 4], [5], [6, 7, 8], [9], [10]):
            if np.abs(d_j[:, cols]).max() == 0:
                assert not d_t[:, cols].any(), (tag, cols)
            else:
                assert _rel_err(d_t[:, cols], d_j[:, cols]) < 5e-5, (tag,
                                                                     cols)
    assert n_written["real"] == n_written["all-exec"] > 0
    assert n_written["floor"] == 0
    assert tblend.launches == tblend.bwd_launches == 0


def _pallas_stripped(name, cm, gdata, ntx, nty, tx, ty):
    """tools/blend_floor.py:92-155 (`build`, `k_empty`, `k_meta`,
    `k_ndone`), interpret=True."""
    G_CHUNK = 128
    nf_cols = gdata.shape[1]
    n_steps = gdata.shape[0] // G_CHUNK
    n_pix = tx * ty
    c_feat = 5

    def build(kernel, n_scratch):
        scratch = [pltpu.VMEM((1, n_pix), jnp.float32),
                   pltpu.VMEM((1, n_pix), jnp.float32),
                   pltpu.VMEM((c_feat, n_pix), jnp.float32),
                   pltpu.SMEM((1,), jnp.int32)][:n_scratch]
        return pl.pallas_call(
            kernel,
            grid_spec=pltpu.PrefetchScalarGridSpec(
                num_scalar_prefetch=2,
                grid=(n_steps,),
                in_specs=[pl.BlockSpec((G_CHUNK, nf_cols),
                                       lambda c, cm, bg: (c, 0))],
                out_specs=pl.BlockSpec(
                    (1, c_feat, n_pix),
                    lambda c, cm, bg: (cm[c] & 0xFFFFFF, 0, 0)),
                scratch_shapes=scratch,
            ),
            out_shape=jax.ShapeDtypeStruct((ntx * nty, c_feat, n_pix),
                                           jnp.float32),
            interpret=True,
        )

    def k_empty(cm_ref, bg_ref, gdata_ref, out_ref):
        c = pl.program_id(0)

        @pl.when(c == 0)
        def _():
            out_ref[0, :, :] = jnp.zeros((c_feat, n_pix), jnp.float32)

    def k_meta(cm_ref, bg_ref, gdata_ref, out_ref, t_run_s, done_s, acc_s):
        c = pl.program_id(0)
        meta = cm_ref[c]
        first = (meta >> 24) & 1
        valid = (meta >> 26) & 1

        @pl.when(first == 1)
        def _():
            t_run_s[...] = jnp.ones((1, n_pix), jnp.float32)
            done_s[...] = jnp.zeros((1, n_pix), jnp.float32)
            acc_s[...] = jnp.zeros((c_feat, n_pix), jnp.float32)

        @pl.when(valid == 1)
        def _():
            out_ref[0, :, :] = acc_s[...] + jnp.sum(gdata_ref[...])

    def k_ndone(cm_ref, bg_ref, gdata_ref, out_ref, t_run_s, done_s, acc_s):
        c = pl.program_id(0)
        meta = cm_ref[c]
        first = (meta >> 24) & 1
        valid = (meta >> 26) & 1

        @pl.when(first == 1)
        def _():
            t_run_s[...] = jnp.ones((1, n_pix), jnp.float32)
            done_s[...] = jnp.zeros((1, n_pix), jnp.float32)
            acc_s[...] = jnp.zeros((c_feat, n_pix), jnp.float32)

        n_done = jnp.sum(done_s[...])

        @pl.when((valid == 1) & (n_done < n_pix))
        def _():
            out_ref[0, :, :] = acc_s[...] + jnp.sum(gdata_ref[...])

    kern, ns = {"empty": (k_empty, 0), "stage": (k_meta, 3),
                "stage_done": (k_ndone, 3)}[name]
    return np.asarray(build(kern, ns)(jnp.asarray(cm.numpy()),
                                      jnp.zeros(3, jnp.float32),
                                      jnp.asarray(gdata.numpy())))


@pytest.mark.parametrize("tile", [(64, 32), (16, 16)])
@pytest.mark.parametrize("variant", tbf.VARIANTS)
def test_stripped_blend_bodies_match_pallas(variant, tile):
    """Each stripped body (k_empty / k_meta / k_ndone against the port's
    empty / stage / stage_done) at the real and the floor input, on the
    blocks both write: k_meta and k_ndone write exactly the tiles with a
    chunk range, k_empty the block of chunk 0's tile (the port's empty
    writes zeros to every tile with a range). At 64x32 tiles hold several
    chunks, so the sum written must be the last chunk's. The port's
    `staged` (no counterpart in the Pallas bodies) must hold the sum over
    every chunk of the tile's range (a float64 numpy sum), 0 for empty."""
    tx, ty = tile
    inp, inputs = _blend_inputs(tx, ty)
    ntx, nty = inp.lists.n_tiles_x, inp.lists.n_tiles_y
    start, end = tblend.tile_chunk_ranges(inp.lists.chunk_meta, ntx * nty)
    assert int((end - start).max()) > 1 or tx * ty == 256
    for tag in ("real", "floor"):
        cm, g = inputs[tag]
        ref = _pallas_stripped(variant, cm, g, ntx, nty, tx, ty)
        got, staged = tbf.stripped_forward(variant, g, cm, n_tiles=ntx * nty,
                                           n_pix=tx * ty)
        got = got.numpy()
        _, _, w_port = tbf.stripped_forward_plain(variant, g, cm,
                                                  n_tiles=ntx * nty,
                                                  n_pix=tx * ty)
        w_port = w_port.numpy()
        chunk_sums = g.numpy().astype(np.float64).reshape(
            -1, 128 * g.shape[1]).sum(axis=1)
        want = [chunk_sums[s:e].sum() if w and variant != "empty" else 0.0
                for s, e, w in zip(start.tolist(), end.tolist(), w_port)]
        np.testing.assert_allclose(staged.numpy()[w_port],
                                   np.asarray(want)[w_port], rtol=1e-6,
                                   atol=1e-6)
        w_jax = ~np.isnan(ref).any(axis=(1, 2))
        if variant == "empty":
            assert w_jax.sum() == 1
        else:
            np.testing.assert_array_equal(w_jax, w_port)
        both = w_jax & w_port
        assert both.any() == (tag == "real")
        np.testing.assert_allclose(got[both], ref[both], rtol=1e-6,
                                   atol=1e-6)
    assert tbf.launches == 0


# --- floor_bench ------------------------------------------------------------

FB_TILES, FB_NFO, FB_PIX = 8, 5, 128


def _pallas_floor_bench(cm, gdata, block, dyn_out):
    """tools/floor_bench.py:44-95 (`make_kernel`, the `pallas_call` of
    `build` with the given chunk metadata), interpret=True."""
    NFO, N_PIX, N_TILES, NF = FB_NFO, FB_PIX, FB_TILES, 16
    n_steps = cm.shape[0]

    def make_kernel(read_gdata, dyn_out):
        def kernel(cm_ref, gdata_ref, out_ref, acc_s):
            c = pl.program_id(0)
            meta = cm_ref[c]
            valid = (meta >> 26) & 1

            @pl.when(c == 0)
            def _():
                acc_s[...] = jnp.zeros((NFO, N_PIX), jnp.float32)

            @pl.when(valid == 1)
            def _():
                if read_gdata:
                    acc_s[...] += jnp.sum(gdata_ref[...]) * jnp.ones(
                        (NFO, N_PIX), jnp.float32)
                else:
                    acc_s[...] += 1.0

            @pl.when((meta >> 25) & 1 == 1)
            def _():
                out_ref[0, :, :] = acc_s[...]
        return kernel

    gspec = pl.BlockSpec((block, NF), lambda c, cm: (c, 0))
    if dyn_out:
        out_spec = pl.BlockSpec((1, NFO, N_PIX),
                                lambda c, cm: (cm[c] & 0xFFFFFF, 0, 0))
    else:
        out_spec = pl.BlockSpec((1, NFO, N_PIX), lambda c, cm: (0, 0, 0))
    call = pl.pallas_call(
        make_kernel(read_gdata=True, dyn_out=dyn_out),
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1,
            grid=(n_steps,),
            in_specs=[gspec],
            out_specs=out_spec,
            scratch_shapes=[pltpu.VMEM((NFO, N_PIX), jnp.float32)],
        ),
        out_shape=jax.ShapeDtypeStruct((N_TILES, NFO, N_PIX),
                                       jnp.float32),
        interpret=True,
    )
    return np.asarray(call(jnp.asarray(cm.numpy()),
                           jnp.asarray(gdata.numpy())))


def _valid_pattern(pattern, n_steps, tool_valid, seed):
    if pattern == "tool":
        return tool_valid
    return np.random.default_rng(seed).random(n_steps) < 0.5


def _uneven_meta(block, seed):
    """Chunk metadata whose tile runs are uneven against the kernel's
    ranges of r = RANGE_ROWS // block steps: runs of one step, runs of r + 3
    and 2r + 1 steps that cross a range's end, and two tiles (2 and 5)
    whose only valid step is the first of their run; the other steps
    valid at random."""
    r = tfb.RANGE_ROWS // block
    lengths = [1, 1, r + 3, 2, 1, 2 * r + 1, 1, 2]
    tiles = np.repeat(np.arange(FB_TILES), lengths)
    valid = np.random.default_rng(seed).random(tiles.size) < 0.5
    for t in (2, 5):
        run = np.flatnonzero(tiles == t)
        valid[run] = False
        valid[run[0]] = True
    return tfb.meta_from_tiles(tiles, valid, "cpu")


def _floor_meta(pattern, n_steps, block, tool_valid, seed):
    if pattern == "uneven":
        return _uneven_meta(block, seed)
    return tfb.chunk_meta(n_steps, _valid_pattern(
        pattern, n_steps, tool_valid, seed), FB_TILES, "cpu")


def _assert_written_close(got, ref, written):
    w_jax = ~np.isnan(ref).any(axis=(1, 2))
    np.testing.assert_array_equal(w_jax, written)
    if written.any():
        assert _rel_err(got[written], ref[written]) <= 1e-6


@pytest.mark.parametrize("pattern", ["tool", "mixed", "uneven"])
@pytest.mark.parametrize("name", list(tfb.VARIANTS))
def test_floor_bench_matches_pallas(name, pattern):
    """Every variant at n_steps / 288 (32, 16, 8 or 4 steps), with the
    tool's valid pattern (all or none) and a mixed one, and on uneven tile
    runs (`_uneven_meta`: r + 14 steps); seeded uniform gdata (the tool's
    are zeros)."""
    n_steps, block, valid, dyn = tfb.variant_shape(name, small=True)
    cm = _floor_meta(pattern, n_steps, block, valid, n_steps + block)
    n_steps = cm.shape[0]
    gdata = tt(np.random.default_rng(block).uniform(
        0, 1, (n_steps * block, 16)).astype(np.float32))
    ref = _pallas_floor_bench(cm, gdata, block, dyn)
    got = tfb.floor_bench(gdata, cm, block=block, dyn_out=dyn,
                          n_tiles=FB_TILES, n_pix=FB_PIX).numpy()
    _, written = tfb.floor_bench_plain(gdata, cm, block=block, dyn_out=dyn,
                                       n_tiles=FB_TILES, n_pix=FB_PIX)
    _assert_written_close(got, ref, written.numpy())
    assert tfb.launches == 0


# --- floor_bench2 -----------------------------------------------------------

def _pallas_floor_bench2(cm, gdata, ins, dyn_in, dyn_out):
    """tools/floor_bench2.py:39-82 (block specs, `make_kernel`, the
    `pallas_call` of `build`), interpret=True."""
    N_STEPS, BLOCK, NF = cm.shape[0], 128, 16
    NFO, N_PIX, N_TILES = FB_NFO, FB_PIX, FB_TILES
    gspec = pl.BlockSpec((BLOCK, NF), lambda c, cm: (c, 0))
    tile_in = pl.BlockSpec((1, NFO, N_PIX),
                           lambda c, cm: (cm[c] & 0xFFFFFF, 0, 0))
    cmaj_in = pl.BlockSpec((1, NFO, N_PIX), lambda c, cm: (c, 0, 0))
    dyn_out_spec = pl.BlockSpec((1, NFO, N_PIX),
                                lambda c, cm: (cm[c] & 0xFFFFFF, 0, 0))
    cmaj_out = pl.BlockSpec((1, NFO, N_PIX), lambda c, cm: (c, 0, 0))

    def make_kernel(n_in):
        def kernel(cm_ref, gdata_ref, *rest):
            ins = rest[:n_in]
            out_ref = rest[n_in]
            acc_s = rest[n_in + 1]
            c = pl.program_id(0)
            meta = cm_ref[c]
            valid = (meta >> 26) & 1

            @pl.when(c == 0)
            def _():
                acc_s[...] = jnp.zeros((NFO, N_PIX), jnp.float32)

            @pl.when(valid == 1)
            def _():
                x = jnp.sum(gdata_ref[...])
                for r in ins:
                    x += jnp.sum(r[...])
                acc_s[...] += x
                out_ref[0, :, :] = acc_s[...]
        return kernel

    n_in = len(ins)
    in_spec = tile_in if dyn_in else cmaj_in
    out_spec = dyn_out_spec if dyn_out else cmaj_out
    out_tiles = N_TILES if dyn_out else N_STEPS
    call = pl.pallas_call(
        make_kernel(n_in),
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1,
            grid=(N_STEPS,),
            in_specs=[gspec] + [in_spec] * n_in,
            out_specs=out_spec,
            scratch_shapes=[pltpu.VMEM((NFO, N_PIX), jnp.float32)],
        ),
        out_shape=jax.ShapeDtypeStruct((out_tiles, NFO, N_PIX),
                                       jnp.float32),
        interpret=True,
    )
    args = [jnp.asarray(cm.numpy()), jnp.asarray(gdata.numpy())] + [
        jnp.asarray(x.numpy()) for x in ins]
    return np.asarray(call(*args))


@pytest.mark.parametrize("pattern", ["tool", "mixed", "uneven"])
@pytest.mark.parametrize("name", list(tfb2.VARIANTS))
def test_floor_bench2_matches_pallas(name, pattern):
    """Every variant at 32 steps of 128 rows, skip-all (the tool's) and a
    mixed valid pattern, and on uneven tile runs (`_uneven_meta`: 46
    steps); seeded uniform gdata and two distinct input arrays (the tool
    passes one array twice)."""
    n_in, dyn_in, dyn_out = tfb2.VARIANTS[name]
    cm = _floor_meta(pattern, tfb2.SMALL["n_steps"], tfb2.BLOCK, False, 7)
    n_steps = cm.shape[0]
    rng = np.random.default_rng(n_in)
    gdata = tt(rng.uniform(0, 1, (n_steps * 128, 16)).astype(np.float32))
    n_blocks = FB_TILES if dyn_in else n_steps
    ins = [tt(rng.uniform(0, 1, (n_blocks, FB_NFO, FB_PIX)).astype(
        np.float32)) for _ in range(n_in)]
    ref = _pallas_floor_bench2(cm, gdata, ins, dyn_in, dyn_out)
    kw = dict(dyn_in=dyn_in, dyn_out=dyn_out, n_tiles=FB_TILES,
              n_pix=FB_PIX)
    got = tfb2.floor_bench2(gdata, cm, ins, **kw).numpy()
    _, written = tfb2.floor_bench2_plain(gdata, cm, ins, **kw)
    assert written.any() == (pattern != "tool")
    _assert_written_close(got, ref, written.numpy())
    assert tfb2.launches == 0


def _expected_bytes(name):
    """Bytes a floor variant must move on its tool's inputs, counted from
    the tools' shapes: 4 a metadata word, 64 a gdata row of valid chunks
    (A2, D4: all), 4 * 5 * 2048 an output block (dynamic out: one a tile;
    fixed: one; floor_bench2's skip-all forms write none)."""
    if name in tfb.VARIANTS:
        n_steps, block, valid, dyn = tfb.variant_shape(name, False)
        return 4 * n_steps + valid * n_steps * block * 64 + (
            tfb.FULL["n_tiles"] if dyn else 1) * 4 * 5 * 2048
    return 4 * tfb2.FULL["n_steps"]


@pytest.mark.parametrize("name", list(tfb.VARIANTS) + list(tfb2.VARIANTS))
def test_floor_bytes_needed_on_the_tools_inputs(name):
    """`bytes_needed`, the byte bound `chip_smoke.py` and `floor_sweep`
    print, on each variant's full-size tool inputs."""
    size = tfb.FULL
    if name in tfb.VARIANTS:
        n_steps, block, valid, dyn = tfb.variant_shape(name, False)
        cm = tfb.chunk_meta(n_steps, valid, size["n_tiles"], "cpu")
        got = tfb.bytes_needed(cm, block=block, dyn_out=dyn,
                               n_tiles=size["n_tiles"], n_pix=size["n_pix"])
    else:
        n_in, dyn_in, dyn_out = tfb2.VARIANTS[name]
        cm = tfb.chunk_meta(tfb2.FULL["n_steps"], False, size["n_tiles"],
                            "cpu")
        got = tfb2.bytes_needed(cm, n_in, dyn_in=dyn_in, dyn_out=dyn_out,
                                n_tiles=size["n_tiles"], n_pix=size["n_pix"])
    assert got == _expected_bytes(name)


def test_floor_bytes_needed_follow_the_data():
    """On uneven runs with a mixed valid pattern the bounds count each
    valid chunk, each input block read (a tile's once) and each written
    block once, as the plain versions write them."""
    cm = _uneven_meta(128, 3)
    n_steps = cm.shape[0]
    tile = (cm & 0xFFFFFF).long()
    valid = ((cm >> 26) & 1).bool()
    gdata = torch.zeros((n_steps * 128, 16))
    blk = 4 * 5 * FB_PIX
    kw = dict(n_tiles=FB_TILES, n_pix=FB_PIX)
    for dyn in (True, False):
        _, written = tfb.floor_bench_plain(gdata, cm, block=128, dyn_out=dyn,
                                           **kw)
        assert tfb.bytes_needed(cm, block=128, dyn_out=dyn, **kw) == (
            4 * n_steps + int(valid.sum()) * 128 * 64
            + int(written.sum()) * blk)
    n_tile_blocks = int(torch.unique(tile[valid]).numel())
    for dyn_in in (True, False):
        for dyn_out in (True, False):
            ins = [torch.zeros((FB_TILES if dyn_in else n_steps, 5, FB_PIX))
                   for _ in range(2)]
            _, written = tfb2.floor_bench2_plain(
                gdata, cm, ins, dyn_in=dyn_in, dyn_out=dyn_out, **kw)
            n_read = n_tile_blocks if dyn_in else int(valid.sum())
            assert tfb2.bytes_needed(cm, 2, dyn_in=dyn_in, dyn_out=dyn_out,
                                     **kw) == (
                4 * n_steps + int(valid.sum()) * 128 * 64
                + (2 * n_read + int(written.sum())) * blk)


def test_floor_range_rows_mirror_the_kernel():
    """The wrappers' RANGE_ROWS is `csrc/step_floor.cu`'s kRangeRows, and
    a range of the smallest block's steps fits one warp's lanes, as the
    kernel's metadata decisions need."""
    src = (cuda_build.CSRC / "step_floor.cu").read_text()
    assert f"constexpr int kRangeRows = {tfb.RANGE_ROWS};" in src
    assert tfb.RANGE_ROWS // min(tfb.BLOCKS) <= 32
    assert all(tfb.RANGE_ROWS % b == 0 for b in tfb.BLOCKS)


def test_floor_sweep_needs_the_card():
    """`tools/floor_sweep` raises without a card, before it builds."""
    from gaussianrpg_tpu_torch.tools import floor_sweep as sw

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            sw.main([])


# --- mm_orient --------------------------------------------------------------

def _pallas_mm_orient(form, x0, G4, P, C, N_STEPS):
    """tools/mm_orient.py:24-71 (`mk`), interpret=True."""
    def mk(form):
        def kernel(x_ref, out_ref, st_s, ba_s, acc_s):
            c = pl.program_id(0)

            @pl.when(c == 0)
            def _():
                st_s[...] = jnp.full((G4, P), 0.5, jnp.float32)
                if form == "A":
                    ba_s[...] = jnp.full((P, C), 0.25, jnp.float32)
                else:
                    ba_s[...] = jnp.full((C, P), 0.25, jnp.float32)
                acc_s[...] = jnp.zeros_like(acc_s)

            x = st_s[...] + x_ref[0, 0]
            if form == "A":
                mom = jax.lax.dot_general(
                    x, ba_s[...], (((1,), (0,)), ((), ())),
                    preferred_element_type=jnp.float32,
                    precision=jax.lax.Precision.HIGHEST)      # (4G, C)
            elif form == "B":
                mom = jax.lax.dot_general(
                    ba_s[...], x, (((1,), (1,)), ((), ())),
                    preferred_element_type=jnp.float32,
                    precision=jax.lax.Precision.HIGHEST)      # (C, 4G)
            else:  # "B+T": swapped matmul plus the (C, 4G)->(4G, C) move
                momt = jax.lax.dot_general(
                    ba_s[...], x, (((1,), (1,)), ((), ())),
                    preferred_element_type=jnp.float32,
                    precision=jax.lax.Precision.HIGHEST)
                mom = momt.T
            acc_s[...] += mom

            @pl.when(c == N_STEPS - 1)
            def _():
                out_ref[...] = acc_s[...]

        acc_shape = (C, G4) if form == "B" else (G4, C)
        ba_shape = (C, P) if form != "A" else (P, C)
        return pl.pallas_call(
            kernel,
            grid=(N_STEPS,),
            in_specs=[pl.BlockSpec((1, 128), lambda c: (0, 0))],
            out_specs=pl.BlockSpec(acc_shape, lambda c: (0, 0)),
            scratch_shapes=[pltpu.VMEM((G4, P), jnp.float32),
                            pltpu.VMEM(ba_shape, jnp.float32),
                            pltpu.VMEM(acc_shape, jnp.float32)],
            out_shape=jax.ShapeDtypeStruct(acc_shape, jnp.float32),
            interpret=True,
        )

    return np.asarray(mk(form)(jnp.full((1, 128), x0, jnp.float32)))


@pytest.mark.parametrize("form", tmm.FORMS)
def test_mm_orient_matches_pallas(form):
    """4 steps, G4=64, P=256, C=16: the tool's operands (st 0.5, ba 0.25,
    a seeded x) through the Pallas body and the port's plain version."""
    G4, P, C, n = 64, 256, 16, 4
    x0 = float(np.random.default_rng(3).uniform(0.5, 1.5))
    ref = _pallas_mm_orient(form, x0, G4, P, C, n)
    st = torch.full((G4, P), 0.5)
    ba = torch.full(tmm.ba_shape(form, P), 0.25)
    got = tmm.mm_orient(form, st, ba, torch.full((n,), x0)).numpy()
    assert got.shape == ref.shape == tmm.out_shape(form, G4)
    assert _rel_err(got, ref) <= 1e-5
    assert tmm.launches == 0


@pytest.mark.parametrize("form", tmm.FORMS)
def test_mm_orient_plain_and_library_match_float64(form):
    """Seeded random operands (the Pallas body's are constants): the plain
    version and the addmm_ yardstick against a float64 numpy sum."""
    G4, P, n = 64, 256, 5
    rng = np.random.default_rng(4)
    st = rng.uniform(-1, 1, (G4, P)).astype(np.float32)
    ba = rng.uniform(-1, 1, tmm.ba_shape(form, P)).astype(np.float32)
    x = rng.uniform(-1, 1, n).astype(np.float32)
    xs = st.astype(np.float64)[None] + x.astype(np.float64)[:, None, None]
    b64 = ba.astype(np.float64)
    if form == "A":
        ref = np.einsum("sgp,pc->gc", xs, b64)
    else:
        ref = np.einsum("cp,sgp->cg", b64, xs)
        if form == "B+T":
            ref = ref.T
    for fn in (tmm.mm_orient_plain, tmm.mm_orient_library):
        got = fn(form, tt(st), tt(ba), tt(x)).numpy()
        assert got.shape == ref.shape
        assert _rel_err(got, ref) <= 1e-5


def test_tf32_control_fails_the_mm_orient_limit():
    """The control of `chip_smoke.py`'s mm_orient check: the plain form
    with each step's operands rounded to TF32 (as a tensor-core TF32
    kernel reads them) must miss the 1e-5 limit that the float32 plain
    version meets, on seeded continuous operands. TF32 rounding keeps 10
    mantissa bits, to nearest."""
    G4, P, n = 64, 256, 5
    rng = np.random.default_rng(5)
    st = tt(rng.uniform(-1, 1, (G4, P)).astype(np.float32))
    ba = tt(rng.uniform(-1, 1, (P, tmm.C)).astype(np.float32))
    x = tt(rng.uniform(-1, 1, n).astype(np.float32))
    r = tmm.tf32_round(st)
    assert not (r.view(torch.int32) & 0x1FFF).any()
    assert float(((r - st).abs() / st.abs()).max()) <= 2.0 ** -11
    ref = tmm.mm_orient_plain("A", st.double(), ba.double(), x.double())
    assert _rel_err(tmm.mm_orient_plain("A", st, ba, x), ref) <= 1e-5
    assert _rel_err(tmm.mm_orient_tf32("A", st, ba, x), ref) > 1e-5


# --- the command lines ------------------------------------------------------

@pytest.mark.parametrize("tool", TOOLS)
def test_tool_main_runs_on_cpu(tool, capsys):
    """`python -m gaussianrpg_tpu_torch.tools.<tool> --device cpu --small`
    runs the plain versions and prints its lines (host-clock times)."""
    mod = importlib.import_module(f"gaussianrpg_tpu_torch.tools.{tool}")
    res = mod.main(["--device", "cpu", "--small"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "device cpu, host clock"
    assert len(lines) >= 4
    assert res["small"] and res["device"] == "cpu"
    assert all(math.isfinite(float(tok)) for line in lines[1:]
               for tok in line.replace("(", " ").split()
               if tok.replace(".", "", 1).isdigit())
    counter = importlib.import_module(COUNTER.get(
        tool, f"gaussianrpg_tpu_torch.tools.{tool}"))
    assert counter.launches == 0


def test_tools_need_cuda_unless_told_cpu(monkeypatch):
    """Without CUDA a tool's run() raises unless device="cpu"."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for tool in TOOLS:
        mod = importlib.import_module(f"gaussianrpg_tpu_torch.tools.{tool}")
        with pytest.raises(RuntimeError, match="CUDA"):
            mod.run()
