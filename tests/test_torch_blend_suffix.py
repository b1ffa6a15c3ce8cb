"""Kernel C's dL/dalpha on saturated pixels, emulated on the CPU.

dL/dalpha = e*T - (tot - prefix)/(1 - alpha) subtracts a running sum of
w*e from the planes' total. Where hundreds of opacity-0.1 pairs saturate a
pixel (the closed loop's and the trainer's scenes, whose Gaussians start
from points), that difference is small against both sums. Kernels B and C
kept them in float32, summed pair by pair in depth order; on the loop's
frames kernel C's mean columns then left the plain backward by up to
2.4e-4 of their max (limit 5e-5). Kernel B now keeps its depth plane,
and kernel C its total and prefix, in double, and the plain versions do
the same with `sum_dtype=torch.float64`. B's r, g, b and alpha planes stay
float32 sums, as the TPU kernel's and the CPU path's.

A second, separate effect: the kernels take the transmittance as a
sequential product, the plain version by default by the TPU kernel's
log-step ladder, so a pixel whose stop test lies within rounding of 1e-4
may stop one pair apart, which shifts every earlier pair's sums there by
the flipped pair's w*e. With `sequential=True` the plain versions take
the kernels' product and stop where they do; `chip_smoke.py` holds the
kernels to that form, kernel C on kernel B's planes.

The kernels' arithmetic is emulated here pair by pair (sequential
transmittance; the sums in float32 as before or in float64 as now) on a
small scene that saturates, against `blend_forward_plain` and
`blend_backward_plain`.
"""
import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from gaussianrpg_tpu_torch.ops import blend
from gaussianrpg_tpu_torch.ops.binning import G_CHUNK
from gaussianrpg_tpu_torch.ops.rasterize import pair_rows, primitive_fields
from gaussianrpg_tpu_torch.render.camera import make_camera

from .torch_parity import one_cpu_thread  # noqa: F401

GRAD_RTOL = 5e-5
W, H = 64, 48


@pytest.fixture(scope="module")
def saturated():
    """12 tiles of 16x16 under ~2000 pairs each: 12000 Gaussians 50-120 m
    away, opacity 0.1, a few px to a tile wide; every pixel saturates."""
    rng = np.random.default_rng(3)
    n = 12000
    z = rng.uniform(50, 120, n)
    means = np.stack([rng.uniform(-1, 1, n) * z * 0.6,
                      rng.uniform(-1, 1, n) * z * 0.45, z],
                     -1).astype(np.float32)
    q = rng.standard_normal((n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    fovx = math.radians(60.0)
    cam = make_camera(R=np.eye(3), T=np.zeros(3), K=None, width=W, height=H,
                      fovx=fovx,
                      fovy=2 * math.atan(math.tan(fovx / 2) * H / W),
                      device="cpu")
    fs = primitive_fields(
        torch.as_tensor(means), torch.full((n,), 0.1), camera=cam,
        colors=torch.as_tensor(rng.uniform(0, 1, (n, 3)).astype(np.float32)),
        scales=torch.as_tensor(np.exp(rng.uniform(0.5, 1.5, (n, 3)))
                               .astype(np.float32)),
        rotations=torch.as_tensor(q), tile_x=16, tile_y=16)
    gdata, lists = pair_rows(fs, width=W, height=H, capacity=1 << 15)
    assert not bool(lists.overflowed)
    kw = dict(ntx=lists.n_tiles_x, nty=lists.n_tiles_y, tx=16, ty=16,
              s_ch=0)
    bg = torch.tensor([0.1, 0.2, 0.3])
    dout = torch.as_tensor(rng.standard_normal(
        (kw["ntx"] * kw["nty"], 5, 256)).astype(np.float32))
    return gdata, lists.chunk_meta, bg, kw, dout


def sequential_blend(gdata, cm, bg, dout, *, ntx, nty, tx, ty, s_ch, sums):
    """Kernels B and C pair by pair: the transmittance as a sequential
    float32 product, B's r, g, b, alpha planes float32 running sums and
    its depth plane, C's total and prefix running sums in `sums`. Returns
    (planes [n_tiles, 5, n_pix], contributing pairs a pixel, gradient
    columns mean x, mean y, opacity [capacity, 3]); C replays B's
    decisions on B's planes."""
    n_tiles, n_pix = ntx * nty, tx * ty
    planes = torch.zeros((n_tiles, 5, n_pix))
    count = torch.zeros((n_tiles, n_pix), dtype=torch.int64)
    grad = torch.zeros((gdata.shape[0], 3))
    p = torch.arange(n_pix)
    gi = torch.arange(G_CHUNK)
    batches = list(blend._plain_batches(cm, n_tiles, n_pix))

    def replay(tb, nb, sb, visit):
        """Walk each tile's pairs in order; visit(i, c, T, con) per pair."""
        px, py = blend._pixel_coords(tb, p, ntx, tx, ty)
        nt = tb.shape[0]
        state = dict(T=torch.ones((nt, n_pix)),
                     done=torch.zeros((nt, n_pix), dtype=torch.bool))
        for r in range(int(nb[0])):
            ia = torch.nonzero(nb > r).flatten()
            rows = (sb[ia] + r)[:, None] * G_CHUNK + gi[None, :]
            c = blend._replay_chunk(gdata, rows, px[ia], py[ia],
                                    state["T"][ia], state["done"][ia], s_ch)
            T, done = state["T"][ia], state["done"][ia]
            for i in range(G_CHUNK):
                one_m = c["one_m"][:, i]
                test_t = T * one_m
                live = (one_m != 1.0) & ~done
                con = live & (test_t >= 1e-4)
                done = done | (live & (test_t < 1e-4))
                visit(ia, rows[:, i], i, c, T, con)
                T = torch.where(con, test_t, T)
            state["T"][ia], state["done"][ia] = T, done
        return state["T"]

    for tb, nb, sb in batches:           # kernel B
        acc = torch.zeros((tb.shape[0], 4, n_pix))
        dep = torch.zeros((tb.shape[0], n_pix), dtype=sums)
        cnt = torch.zeros((tb.shape[0], n_pix), dtype=torch.int64)

        def fwd(ia, rows, i, c, T, con):
            alpha = torch.clamp(c["op"][:, i] * c["g"][:, i], max=0.99)
            w = torch.where(con, alpha * T, torch.zeros_like(T))
            f = c["feats"][:, i]
            acc[ia] += torch.stack([w * f[:, 0:1], w * f[:, 1:2],
                                    w * f[:, 2:3], w], dim=1)
            dep[ia] += (w * f[:, 3:4]).to(sums)
            cnt[ia] += con.long()

        t_final = replay(tb, nb, sb, fwd)
        rgb = acc[:, 0:3] + t_final[:, None, :] * bg[None, :, None]
        planes[tb] = torch.cat([rgb, dep.float()[:, None], acc[:, 3:4]], 1)
        count[tb] = cnt
    for tb, nb, sb in batches:           # kernel C on B's planes
        o, g = planes[tb], dout[tb]
        t_fin = 1.0 - o[:, 4]
        tot = sum((o[:, ch] - t_fin * bg[ch]).to(sums) * g[:, ch]
                  for ch in range(3))
        tot = tot + o[:, 3].to(sums) * g[:, 3] + o[:, 4].to(sums) * g[:, 4]
        tot = tot + t_fin.to(sums) * (g[:, 0] * bg[0] + g[:, 1] * bg[1]
                                      + g[:, 2] * bg[2])
        pref = torch.zeros((tb.shape[0], n_pix), dtype=sums)

        def bwd(ia, rows, i, c, T, con):
            f, gp = c["feats"][:, i], g[ia]
            alpha = torch.clamp(c["op"][:, i] * c["g"][:, i], max=0.99)
            w = torch.where(con, alpha * T, torch.zeros_like(T))
            e = (f[:, 0:1] * gp[:, 0] + f[:, 1:2] * gp[:, 1]
                 + f[:, 2:3] * gp[:, 2] + f[:, 3:4] * gp[:, 3] + gp[:, 4])
            pref[ia] += (w * e).to(sums)
            dl = e * T - (tot[ia] - pref[ia]).float() / c["one_m"][:, i]
            dl = torch.where(con, dl, torch.zeros_like(dl))
            q = c["op"][:, i] * (c["g"][:, i] * dl)
            dx, dy = c["dx"][:, i], c["dy"][:, i]
            grad[rows, 0] = (-q * (c["ca"][:, i] * dx
                                   + c["cb"][:, i] * dy)).sum(1)
            grad[rows, 1] = (-q * (c["cc"][:, i] * dy
                                   + c["cb"][:, i] * dx)).sum(1)
            grad[rows, 2] = (c["g"][:, i] * dl).sum(1)

        replay(tb, nb, sb, bwd)
    return planes, count, grad


def contributing(gdata, cm, *, ntx, nty, tx, ty, s_ch, sequential=False):
    """Contributing pairs a pixel under the plain replay."""
    n_tiles, n_pix = ntx * nty, tx * ty
    count = torch.zeros((n_tiles, n_pix), dtype=torch.int64)
    p = torch.arange(n_pix)
    gi = torch.arange(G_CHUNK)
    for tb, nb, sb in blend._plain_batches(cm, n_tiles, n_pix):
        px, py = blend._pixel_coords(tb, p, ntx, tx, ty)
        t_run = torch.ones((tb.shape[0], n_pix))
        done = torch.zeros((tb.shape[0], n_pix), dtype=torch.bool)
        cnt = torch.zeros((tb.shape[0], n_pix), dtype=torch.int64)
        for r in range(int(nb[0])):
            ia = torch.nonzero(nb > r).flatten()
            rows = (sb[ia] + r)[:, None] * G_CHUNK + gi[None, :]
            c = blend._replay_chunk(gdata, rows, px[ia], py[ia], t_run[ia],
                                    done[ia], s_ch, sequential)
            cnt[ia] += c["contrib"].long().sum(dim=1)
            t_run[ia] = c["t_new"]
            done[ia] = done[ia] | c["stop"].any(dim=1)
        count[tb] = cnt
    return count


def rel(got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


def test_saturated_scene_saturates(saturated):
    gdata, cm, bg, kw, _ = saturated
    out = blend.blend_forward_plain(gdata, cm, bg, **kw)
    assert float(out[:, 4].min()) > 0.998          # T below 2e-3 everywhere
    assert int(contributing(gdata, cm, **kw).min()) >= 100


def test_kernel_sums_meet_the_limit_on_saturated_pixels(saturated):
    """The kernels' arithmetic with float64 sums against the plain versions
    with float64 sums and the kernels' transmittance product, as
    `chip_smoke.py` holds them: mean and opacity columns within 5e-5 of
    their max, and at most half the error of the same arithmetic with
    float32 sums (kernels B and C before)."""
    gdata, cm, bg, kw, dout = saturated
    out = blend.blend_forward_plain(gdata, cm, bg, sum_dtype=torch.float64,
                                    sequential=True, **kw)
    ref = blend.blend_backward_plain(gdata, cm, bg, out, dout, stat_width=W,
                                     stat_height=H, sum_dtype=torch.float64,
                                     sequential=True, **kw)
    ref = ref[:, [blend.F_MX, blend.F_MY, blend.F_OP]]
    errs = {}
    for sums in (torch.float32, torch.float64):
        planes, _, got = sequential_blend(gdata, cm, bg, dout, sums=sums,
                                          **kw)
        assert rel(planes, out) <= 1e-5
        errs[sums] = (rel(got[:, :2], ref[:, :2]), rel(got[:, 2], ref[:, 2]))
    mean64, op64 = errs[torch.float64]
    assert mean64 <= GRAD_RTOL and op64 <= GRAD_RTOL, errs
    assert mean64 <= 0.5 * errs[torch.float32][0], errs


def test_log_step_and_sequential_products_differ(saturated):
    """The plain version's default product (the TPU kernel's log-step
    ladder) and the kernels' sequential one round differently: on the
    saturated scene their final transmittances differ."""
    gdata, cm, bg, kw, _ = saturated
    ladder = blend.blend_forward_plain(gdata, cm, bg, **kw)
    seq = blend.blend_forward_plain(gdata, cm, bg, sequential=True, **kw)
    assert not torch.equal(ladder[:, 4], seq[:, 4])
    assert rel(seq, ladder) <= 1e-5


@settings(max_examples=40, deadline=None)
@given(n=st.integers(1, G_CHUNK), lo=st.floats(0.2, 0.999),
       seed=st.integers(0, 2 ** 16))
def test_seqprod_is_the_sequential_float32_product(n, lo, seed):
    """`_seqprod_excl` multiplies pair by pair from the carried product,
    bit for bit as a float32 loop does."""
    rng = np.random.default_rng(seed)
    f = rng.uniform(lo, 1.0, (2, n, 3)).astype(np.float32)
    t0 = rng.uniform(1e-3, 1.0, (2, 3)).astype(np.float32)
    got = blend._seqprod_excl(torch.as_tensor(t0), torch.as_tensor(f))
    want = np.empty_like(f)
    t = t0.copy()
    for j in range(n):
        want[:, j] = t
        t = (t * f[:, j]).astype(np.float32)
    assert np.array_equal(got.numpy(), want)


def test_sequential_plain_replays_the_kernels(saturated):
    """With `sequential`, the plain versions stop every pixel where the
    kernels' emulation does, their planes match it and their backward on
    its planes matches its gradients (float64 sums on both sides), closer
    than with the log-step product (4.0e-7 on the planes; 3.8e-6 and
    2.6e-6 on the mean and opacity columns)."""
    gdata, cm, bg, kw, dout = saturated
    planes, count, got = sequential_blend(gdata, cm, bg, dout,
                                          sums=torch.float64, **kw)
    assert torch.equal(contributing(gdata, cm, sequential=True, **kw), count)
    out = blend.blend_forward_plain(gdata, cm, bg, sum_dtype=torch.float64,
                                    sequential=True, **kw)
    assert rel(planes, out) <= 2e-7
    ref = blend.blend_backward_plain(gdata, cm, bg, planes, dout,
                                     stat_width=W, stat_height=H,
                                     sum_dtype=torch.float64,
                                     sequential=True, **kw)
    ref = ref[:, [blend.F_MX, blend.F_MY, blend.F_OP]]
    assert rel(got[:, :2], ref[:, :2]) <= 2e-6
    assert rel(got[:, 2], ref[:, 2]) <= 2e-6
