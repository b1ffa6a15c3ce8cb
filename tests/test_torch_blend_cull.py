"""Kernels B and C cull a pair from a warp's pixels by a rectangle, and
kernel C sums over pixels in the moment form; both are checked here on the
CPU, before any card time is spent on them.

- The cull rectangle is conservative: `ops/blend.cull_rect_plain` (the
  kernels' formula, csrc/blend_tile.cuh, in float32 PyTorch) holds every
  (pair, pixel) that the blend's explicitly rounded test lets through, over
  seeded random pairs, adversarial ones (opacity at and near 1/255 and
  0.99, near-degenerate and strongly sheared conics, centres on tile and
  8x4-block edges), hypothesis-drawn ones and the frozen bench scene's
  real footprints.
- The moment form meets the gradient tolerance: kernel C's reduction is
  emulated in float32 (per pixel the staged q, gx, gy and w; per 8x4 block
  the moments of q against block-local [1, x, y, x^2, xy, y^2], the sums
  of absp = W/2 |gx| + H/2 |gy|, gx, gy and of w times the cotangents;
  the conic and opacity columns recombined per block as
  pallas_blend.py:474-496 does) and held against `blend_backward_plain`
  at 5e-5 of each column group's max (`GRAD_RTOL`, chip_smoke.py). The
  mean columns are summed from the staged gx, gy, not recombined from the
  moments: on the adversarial pairs' shear the recombination
  -(ca sum q dx + cb sum q dy) cancels, and on the card it missed the
  limit (1.2e-4 of the max; 3.2e-5 in this emulation's summation order).
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
from gaussianrpg_tpu_torch.utils.synthetic import build_frozen_scene

from .torch_parity import one_cpu_thread  # noqa: F401

F32 = torch.float32
C_MIN = torch.tensor(1.0 / 255.0, dtype=F32)    # the kernels' 1/255
GRAD_RTOL = 5e-5


def _exact_pass(rows, px, py):
    """The blend's skip test at pixels (px, py) [N, K] for rows [N, NF],
    each operation rounded on its own as the kernels round it: True where
    the pair is not skipped (power <= 0 and op*exp(power) >= 1/255)."""
    mx, my, ca, cb, cc, op = (rows[:, i:i + 1] for i in range(6))
    dx = mx - px
    dy = my - py
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    alpha_raw = op * torch.exp(power)
    return ~(power > 0) & ~(alpha_raw < C_MIN)


def _assert_conservative(rows, half=48):
    """Every passing pixel within `half` px of a pair's rounded centre lies
    inside its rectangle; returns the number of passing (pair, pixel)."""
    rows = rows.to(F32)
    rect = blend.cull_rect_plain(rows)
    off = torch.arange(-half, half + 1, dtype=F32)
    cx = torch.round(torch.nan_to_num(rows[:, 0:1], posinf=0, neginf=0))
    cy = torch.round(torch.nan_to_num(rows[:, 1:2], posinf=0, neginf=0))
    px = (cx + off[None, :])[:, :, None].expand(-1, -1, off.numel())
    py = (cy + off[None, :])[:, None, :].expand(-1, off.numel(), -1)
    px = px.reshape(rows.shape[0], -1)
    py = py.reshape(rows.shape[0], -1)
    passes = _exact_pass(rows, px, py)
    inside = ((px >= rect[:, 0:1]) & (px <= rect[:, 1:2])
              & (py >= rect[:, 2:3]) & (py <= rect[:, 3:4]))
    bad = passes & ~inside
    assert not bool(bad.any()), rows[bad.any(dim=1)][:4]
    return int(passes.sum())


def _rows(mx, my, conic, op, nf=16):
    """Pair rows from centres [N], conics [N, 3] (a, b, c) and opacities."""
    n = len(mx)
    rows = torch.zeros((n, nf), dtype=F32)
    rows[:, 0] = torch.as_tensor(np.asarray(mx, np.float32))
    rows[:, 1] = torch.as_tensor(np.asarray(my, np.float32))
    rows[:, 2:5] = torch.as_tensor(np.asarray(conic, np.float32))
    rows[:, 5] = torch.as_tensor(np.asarray(op, np.float32))
    return rows


def _conics(sigma_major, ratio, theta):
    """Conics (inverse covariances) of ellipses with the given major
    standard deviation (px), axis ratio and angle."""
    s1 = np.asarray(sigma_major, np.float64)
    s2 = s1 / np.asarray(ratio, np.float64)
    c, s = np.cos(theta), np.sin(theta)
    sxx = c * c * s1 ** 2 + s * s * s2 ** 2
    syy = s * s * s1 ** 2 + c * c * s2 ** 2
    sxy = c * s * (s1 ** 2 - s2 ** 2)
    det = sxx * syy - sxy * sxy
    return np.stack([syy / det, -sxy / det, sxx / det], -1)


def _near(x, n=3):
    """x and its n float32 neighbours on each side."""
    x = np.float32(x)
    out = [x]
    lo = hi = x
    for _ in range(n):
        lo = np.nextafter(lo, np.float32(-np.inf))
        hi = np.nextafter(hi, np.float32(np.inf))
        out += [lo, hi]
    return out


def test_cull_rect_random_pairs():
    rng = np.random.default_rng(0)
    n = 4000
    conic = _conics(rng.uniform(0.3, 8.0, n), rng.uniform(1.0, 20.0, n),
                    rng.uniform(0, np.pi, n))
    rows = _rows(rng.uniform(0, 64, n), rng.uniform(0, 64, n), conic,
                 rng.uniform(0.0, 1.0, n))
    assert _assert_conservative(rows, half=40) > 0


ADVERSARIAL = ("opacity", "degenerate", "sheared", "edge_centres")


def adversarial_rows(case):
    """Seeded adversarial pair rows [N, 16] (centres within [0, 64]^2):
    `opacity` at and near 1/255 (as the kernels hold it), the whole-pair
    cull threshold, 0.99 (the clamp) and 1, at integer centres (power = 0
    there) and off them; `degenerate` axis ratios 50-900 (shear r =
    ca*cc/det up to and past the kernels' cap of 1e5); `sheared` at 45
    degrees; `edge_centres` on tile (16, 64) and 8x4-block edges and one
    or two float32 steps either side."""
    rng = np.random.default_rng(1)
    if case == "opacity":
        ops = np.array(_near(C_MIN.item()) + _near(blend.CULL_OPACITY)
                       + _near(0.99) + _near(1.0) + [0.0, 1e-3, 0.5],
                       np.float32)
        n = ops.size * 4
        mx = np.tile([16.0, 16.5, 15.25, 8.0 + 2 ** -20], ops.size)
        conic = _conics(rng.uniform(0.5, 5.0, n), rng.uniform(1, 4, n),
                        rng.uniform(0, np.pi, n))
        return _rows(mx, mx[::-1].copy(), conic, np.repeat(ops, 4))
    if case == "degenerate":
        n = 3000
        ratio = np.exp(rng.uniform(np.log(50), np.log(900), n))
        conic = _conics(rng.uniform(1.0, 12.0, n), ratio,
                        rng.uniform(0, np.pi, n))
        return _rows(rng.uniform(0, 32, n), rng.uniform(0, 32, n), conic,
                     rng.uniform(0.3, 0.99, n))
    if case == "sheared":
        n = 3000
        conic = _conics(rng.uniform(2.0, 10.0, n), rng.uniform(5, 40, n),
                        np.pi / 4 + rng.uniform(-0.05, 0.05, n))
        return _rows(rng.uniform(0, 32, n), rng.uniform(0, 32, n), conic,
                     rng.uniform(0.5, 0.99, n))
    edges = [e for x in (0.0, 4.0, 8.0, 16.0, 32.0, 64.0)
             for e in _near(x, 2)] + [7.5, 3.5, 15.5]
    mx = np.array(edges * len(edges), np.float32)
    my = np.repeat(np.array(edges, np.float32), len(edges))
    n = mx.size
    conic = _conics(rng.uniform(0.3, 3.0, n), rng.uniform(1, 3, n),
                    rng.uniform(0, np.pi, n))
    return _rows(mx, my, conic, rng.uniform(0.004, 0.99, n))


@pytest.mark.parametrize("case", ADVERSARIAL)
def test_cull_rect_adversarial_pairs(case):
    rows = adversarial_rows(case)
    if case == "degenerate":
        r = blend.cull_rect_plain(rows)
        sheared = (rows[:, 2] * rows[:, 4]
                   / (rows[:, 2] * rows[:, 4] - rows[:, 3] ** 2))
        assert bool((sheared > blend.CULL_MAX_SHEAR).any())
        assert bool(torch.isinf(r[sheared > blend.CULL_MAX_SHEAR]).all())
    assert _assert_conservative(rows) > 0


@settings(max_examples=300, deadline=None, derandomize=True)
@given(mx=st.floats(-40, 100, width=32), my=st.floats(-40, 100, width=32),
       sigma=st.floats(0.2, 15.0), ratio=st.floats(1.0, 400.0),
       theta=st.floats(0.0, math.pi),
       op=st.one_of(st.floats(0.0, 1.0, width=32),
                    st.sampled_from(_near(C_MIN.item()) + _near(0.99))))
def test_cull_rect_hypothesis(mx, my, sigma, ratio, theta, op):
    rows = _rows([mx], [my], _conics([sigma], [ratio], [theta]), [op])
    _assert_conservative(rows, half=32)


def test_cull_rect_special_rows():
    """Below-threshold opacity culls the pair whole; a conic that is not
    positive definite, a NaN and an input past the overflow bounds cull
    nothing (the exact test may let a NaN power through)."""
    nan, inf = float("nan"), float("inf")
    rows = _rows([5, 5, 5, 5, nan, 5, 2e7],
                 [5, 5, 5, 5, 5, 5, 5],
                 [[1, 0, 1], [1, 2, 1], [-1, 0, 1], [nan, 0, 1], [1, 0, 1],
                  [1e30, 0, 1], [1, 0, 1]],
                 [0.0039, 0.9, 0.9, 0.9, 0.9, 0.9, 0.9])
    r = blend.cull_rect_plain(rows)
    assert r[0].tolist() == [inf, -inf, inf, -inf]
    for i in range(1, 7):
        assert r[i].tolist() == [-inf, inf, -inf, inf], i
    assert not bool(torch.isnan(r).any())


def test_cull_rect_frozen_scene_footprints():
    """The frozen bench scene's real footprints: 20k of its Gaussians
    (seeded pick) projected by its camera, every pixel within 24 px."""
    cam, (means, opac, colors, scales, quats), H, W = build_frozen_scene(
        device="cpu")
    pick = torch.as_tensor(np.random.default_rng(2).choice(
        means.shape[0], 20_000, replace=False))
    fs = primitive_fields(means[pick], opac[pick], camera=cam,
                          colors=colors[pick], scales=scales[pick],
                          rotations=quats[pick], tile_x=16, tile_y=16)
    rows = fs.fields[fs.radii > 0]
    assert rows.shape[0] > 5000
    assert _assert_conservative(rows, half=24) > 0
    rect = blend.cull_rect_plain(rows)
    # the rectangles are tight: a few pixels, not the whole plane
    width = (rect[:, 1] - rect[:, 0]).median()
    assert 2.0 < float(width) < 60.0


def test_kernel_tile_check():
    """Shapes the card's pixel layout takes, one it does not, and rows the
    bulk copies cannot take (shared memory is the C entries' check)."""
    g = torch.zeros((G_CHUNK, 16))
    for tx, ty in ((16, 16), (64, 32), (32, 16), (16, 8), (8, 16)):
        blend._check_kernel(g, tx, ty, "t")
    with pytest.raises(ValueError, match="warp regions"):
        blend._check_kernel(g, 4, 32, "t")
    shifted = torch.zeros(G_CHUNK * 16 + 1)[1:].view(G_CHUNK, 16)
    with pytest.raises(ValueError, match="16-byte"):
        blend._check_kernel(shifted, 16, 16, "t")


# --- kernel C's moment form ------------------------------------------------

def _moment_backward(gdata, chunk_meta, bg, out, dout, *, ntx, nty, tx, ty,
                     s_ch, stat_width, stat_height):
    """Kernel C's reduction in float32 PyTorch: the plain backward's
    per-pixel terms (the same replay), summed per 8x4 block in the moment
    form and recombined per block, then summed over the blocks."""
    n_tiles, n_pix = ntx * nty, tx * ty
    grad = torch.zeros_like(gdata)
    p = torch.arange(n_pix)
    gi = torch.arange(G_CHUNK)
    bg = bg.reshape(3)
    half_w, half_h = 0.5 * stat_width, 0.5 * stat_height
    # block-local coordinates and block origins of the tile's pixels
    x, y = p % tx, p // tx
    nbx = tx // 8
    blk = (y // 4) * nbx + x // 8
    nblk = n_pix // 32
    lx, ly = (x % 8).to(F32), (y % 4).to(F32)
    box = (torch.arange(nblk) % nbx * 8).to(F32)     # block origins
    boy = (torch.arange(nblk) // nbx * 4).to(F32)
    onehot = torch.nn.functional.one_hot(blk, nblk).to(F32)   # [P, nblk]
    basis = torch.stack([torch.ones_like(lx), lx, ly, lx * lx, lx * ly,
                         ly * ly], dim=1)                     # [P, 6]
    for tb, nb, sb in blend._plain_batches(chunk_meta, n_tiles, n_pix):
        px, py = blend._pixel_coords(tb, p, ntx, tx, ty)
        outs, g_pix = out[tb], dout[tb]
        t_final = 1.0 - outs[:, 4]
        tot = torch.cat([outs[:, 0:3] - t_final[:, None, :]
                         * bg[None, :, None], outs[:, 3:]], dim=1)
        bg_dot = g_pix[:, 0] * bg[0] + g_pix[:, 1] * bg[1] \
            + g_pix[:, 2] * bg[2]
        # the total and the running sum of w*e in float64, as kernel C
        tot_ebt = torch.sum(tot.double() * g_pix.double(), dim=1) \
            + t_final.double() * bg_dot.double()
        g_cols = torch.cat([g_pix[:, 0:4], g_pix[:, 5:]], dim=1)
        nt = tb.shape[0]
        t_run = torch.ones((nt, n_pix))
        done = torch.zeros((nt, n_pix), dtype=torch.bool)
        pref = torch.zeros((nt, n_pix), dtype=torch.float64)
        tile_ox = ((tb % ntx) * tx).to(F32)
        tile_oy = ((tb // ntx) * ty).to(F32)
        for r in range(int(nb[0])):
            ia = torch.nonzero(nb > r).flatten()
            rows = (sb[ia] + r)[:, None] * G_CHUNK + gi[None, :]
            d = done[ia]
            c = blend._replay_chunk(gdata, rows, px[ia], py[ia], t_run[ia],
                                    d, s_ch)
            e = torch.bmm(c["feats"], g_pix[ia])
            w = c["w"]
            p_incl = pref[ia][:, None, :] + torch.cumsum((w * e).double(),
                                                         dim=1)
            dl_da = e * c["t_excl"] - (tot_ebt[ia][:, None, :] - p_incl
                                       ).float() / c["one_m"]
            dl_da = torch.where(c["contrib"], dl_da, torch.zeros_like(dl_da))
            q = c["op"] * (c["g"] * dl_da)                   # staged q
            dx, dy = c["dx"], c["dy"]
            gx = -q * (c["ca"] * dx + c["cb"] * dy)
            gy = -q * (c["cc"] * dy + c["cb"] * dx)
            absp = half_w * gx.abs() + half_h * gy.abs()
            # per block: moments [b, G, nblk, 6], absp and w . g sums
            mom = torch.einsum("bgp,pk,pm->bgkm", q, onehot, basis)
            sab = torch.einsum("bgp,pk->bgk", absp, onehot)
            wg = torch.einsum("bgp,bcp,pk->bgkc", w, g_cols[ia], onehot)
            s0, sx, sy, sxx, sxy, syy = mom.unbind(-1)
            mx = c["mx"][..., 0][:, :, None]      # [b, G, 1]
            my = c["my"][..., 0][:, :, None]
            M = mx - (tile_ox[ia][:, None, None] + box)   # [b, G, nblk]
            N = my - (tile_oy[ia][:, None, None] + boy)
            ca, cb, cc = (c[k][..., 0][:, :, None] for k in ("ca", "cb",
                                                              "cc"))
            qdxx = M * M * s0 - 2.0 * M * sx + sxx
            qdyy = N * N * s0 - 2.0 * N * sy + syy
            qdxy = M * N * s0 - M * sy - N * sx + sxy
            op = c["op"][..., 0][:, :, None]
            cols = torch.stack(
                [torch.einsum("bgp,pk->bgk", gx, onehot),    # staged gx, gy
                 torch.einsum("bgp,pk->bgk", gy, onehot), -0.5 * qdxx,
                 -qdxy, -0.5 * qdyy, s0 / torch.clamp(op, min=1e-20)],
                dim=-1).sum(dim=2)                # [b, G, 6]
            wsum = wg.sum(dim=2)                  # [b, G, 4 + S]
            gmat = torch.cat([cols, wsum[..., :4], sab.sum(dim=2)[..., None],
                              wsum[..., 4:]], dim=-1)
            grad[rows.reshape(-1), :blend.NF_BASE + s_ch] = gmat.reshape(
                -1, blend.NF_BASE + s_ch)
            t_run[ia] = c["t_new"]
            pref[ia] = p_incl[:, -1, :]
            done[ia] = d | c["stop"].any(dim=1)
    return grad


@pytest.mark.parametrize("tile,s_ch", [((16, 16), 0), ((16, 16), 3),
                                       ((64, 32), 0), ((64, 32), 3)])
def test_moment_form_meets_gradient_tolerance(tile, s_ch):
    tx, ty = tile
    W, H = 128, 96
    rng = np.random.default_rng(4)
    n = 1200
    means = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                      rng.uniform(1, 8, n)], -1).astype(np.float32)
    q = rng.standard_normal((n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    fovx = math.radians(60.0)
    cam = make_camera(R=np.eye(3), T=np.zeros(3), K=None, width=W, height=H,
                      fovx=fovx,
                      fovy=2 * math.atan(math.tan(fovx / 2) * H / W),
                      device="cpu")
    sem = rng.uniform(0, 1, (n, s_ch)).astype(np.float32) if s_ch else None
    fs = primitive_fields(
        torch.as_tensor(means), torch.as_tensor(rng.uniform(
            0.05, 0.99, n).astype(np.float32)), camera=cam,
        colors=torch.as_tensor(rng.uniform(0, 1, (n, 3)).astype(np.float32)),
        scales=torch.as_tensor(np.exp(rng.uniform(-3.5, -1.0, (n, 3)))
                               .astype(np.float32)),
        rotations=torch.as_tensor(q),
        semantics=None if sem is None else torch.as_tensor(sem),
        tile_x=tx, tile_y=ty)
    gdata, lists = pair_rows(fs, width=W, height=H, capacity=1 << 15)
    assert not bool(lists.overflowed)
    kw = dict(ntx=lists.n_tiles_x, nty=lists.n_tiles_y, tx=tx, ty=ty,
              s_ch=s_ch)
    bg = torch.tensor([0.1, 0.2, 0.3])
    out = blend.blend_forward_plain(gdata, lists.chunk_meta, bg, **kw)
    dout = torch.as_tensor(rng.standard_normal(tuple(out.shape))
                           .astype(np.float32))
    stat = dict(stat_width=W, stat_height=H)
    ref = blend.blend_backward_plain(gdata, lists.chunk_meta, bg, out, dout,
                                     **kw, **stat, sum_dtype=torch.float64)
    got = _moment_backward(gdata, lists.chunk_meta, bg, out, dout, **kw,
                           **stat)
    groups = {"mean": [0, 1], "conic": [2, 3, 4], "opacity": [5],
              "color": [6, 7, 8], "depth": [9], "absgrad": [10]}
    if s_ch:
        groups["semantic"] = list(range(11, 11 + s_ch))
    for name, cols in groups.items():
        scale = float(ref[:, cols].abs().max())
        assert scale > 0, name
        err = float((got[:, cols] - ref[:, cols]).abs().max()) / scale
        assert err <= GRAD_RTOL, (name, err)
