"""The port's reference rasterizer (`gaussianrpg_tpu_torch/ops/oracle.py`)
held against the JAX package's oracle (forward planes and gradients of
every input and the viewspace hook) and against the port's own
`rasterize` on the CPU, at the blend tolerances (forward rtol 1e-4 /
atol 1e-5, depth atol 1e-4; gradients 5e-5 of each gradient's max,
scales and rotations at COND_RTOL, tests/test_torch_raster_grad.py)
outside the pixels that sit on a skip/stop threshold; and the opaque
wall of tests/test_oracle.py (early termination)."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from gaussianrpg_tpu.ops.oracle import rasterize_oracle as joracle  # noqa

from gaussianrpg_tpu_torch.ops import rasterize as tr  # noqa: E402
from gaussianrpg_tpu_torch.ops.oracle import \
    rasterize_oracle as toracle  # noqa: E402

from .np_reference import rasterize_np  # noqa: E402
from .test_torch_blend_bwd import BG, _assert_grad  # noqa: E402
from .test_torch_raster_grad import (COND_RTOL, GRAD_RTOL,  # noqa: E402
                                     _grads_jax, _inputs, _loss, _near)
from .torch_parity import (assert_planes, camera_pair,  # noqa: E402,F401
                           one_cpu_thread, tt)

GRAD_NAMES = ("means", "opacity", "colors", "scales", "rotations",
              "means2d_offset")


def _forward(g, jc, tc, with_sh=False):
    """Both oracles' RasterOut on the same inputs."""
    col = "shs" if with_sh else "colors"
    extra = dict(sh_degree=3) if with_sh else {}
    jx, tx = dict(extra), dict(extra)
    if g["sem"] is not None:
        jx["semantics"] = jnp.asarray(g["sem"])
        tx["semantics"] = tt(g["sem"])
    a = joracle(jnp.asarray(g["means"]), jnp.asarray(g["opac"]), camera=jc,
                bg_color=jnp.asarray(BG), scales=jnp.asarray(g["scales"]),
                rotations=jnp.asarray(g["q"]), **{col: jnp.asarray(g[col])},
                **jx)
    b = toracle(tt(g["means"]), tt(g["opac"]), camera=tc, bg_color=tt(BG),
                scales=tt(g["scales"]), rotations=tt(g["q"]),
                **{col: tt(g[col])}, **tx)
    return a, b


@pytest.mark.parametrize("seed,cam_seed,s_ch,with_sh", [
    (1, None, 0, False), (2, 3, 5, True)])
def test_forward_matches_jax_oracle(seed, cam_seed, s_ch, with_sh):
    """Colour, depth, alpha and semantics planes, radii and means2d."""
    jc, tc, g, _ = _inputs(300, seed, 64, 48, cam_seed=cam_seed, s_ch=s_ch,
                           with_sh=with_sh)
    a, b = _forward(g, jc, tc, with_sh)
    near = _near(g, tc, 64, 48, (16, 16))
    np.testing.assert_array_equal(b.radii.numpy(), np.asarray(a.radii))
    np.testing.assert_allclose(b.means2d.numpy(), np.asarray(a.means2d),
                               rtol=1e-5, atol=1e-4)
    assert_planes(b.color, a.color, skip=near)
    assert_planes(b.depth, a.depth, atol=1e-4, skip=near)
    assert_planes(b.alpha, a.alpha, skip=near)
    assert b.semantic.shape == (s_ch, 48, 64)
    if s_ch:
        assert_planes(b.semantic, a.semantic, skip=near)


def _grads_oracle(g, tc, spec):
    """The port oracle's gradients of `_loss` (as `_grads_jax`)."""
    n = g["means"].shape[0]
    args = [tt(g[k]).requires_grad_(True)
            for k in ("means", "opac", "colors", "scales", "q")]
    off = torch.zeros((n, 2), requires_grad=True)
    out = toracle(args[0], args[1], camera=tc, bg_color=tt(BG),
                  colors=args[2], scales=args[3], rotations=args[4],
                  means2d_offset=off)
    tot = _loss(out, spec, torch, tt)
    return [x.numpy() for x in torch.autograd.grad(tot, args + [off])]


@pytest.mark.parametrize("kind", ["l2", "linear"])
def test_gradients_match_jax_oracle_and_rasterize(kind):
    """Gradients of means, opacity, colours, scales, rotations and the
    means2d_offset hook: the port's oracle against the JAX oracle and
    against the port's `rasterize` (both hooks on, as in training)."""
    jc, tc, g, rng = _inputs(300, 3, 64, 48)
    keep = (~_near(g, tc, 64, 48, (16, 16))).astype(np.float32)
    if kind == "l2":
        spec = ("l2", [rng.uniform(0, 1, (3, 48, 64)).astype(np.float32),
                       keep])
    else:
        spec = ("linear", [rng.uniform(-1, 1, (c, 48, 64)).astype(
            np.float32) * keep for c in (3, 1, 1, 1)])
    got = _grads_oracle(g, tc, spec)
    with jax.default_matmul_precision("highest"):
        want = _grads_jax(joracle, g, jc, spec)
    n = g["means"].shape[0]
    args = [tt(g[k]).requires_grad_(True)
            for k in ("means", "opac", "colors", "scales", "q")]
    hooks = [torch.zeros((n, 2), requires_grad=True),
             torch.zeros((n,), requires_grad=True)]
    out = tr.rasterize(args[0], args[1], camera=tc, bg_color=tt(BG),
                       colors=args[2], scales=args[3], rotations=args[4],
                       capacity=8192, means2d_offset=hooks[0],
                       absgrad_sink=hooks[1], device="cpu")
    ras = [x.numpy() for x in torch.autograd.grad(
        _loss(out, spec, torch, tt), args + hooks[:1])]
    for i, nm in enumerate(GRAD_NAMES):
        rtol = COND_RTOL if nm in ("scales", "rotations") else GRAD_RTOL
        assert np.isfinite(got[i]).all() and np.abs(got[i]).max() > 0
        _assert_grad(got[i], want[i], nm + " vs JAX oracle", rtol)
        _assert_grad(got[i], ras[i], nm + " vs rasterize", rtol)


def test_oracle_matches_rasterize_forward():
    """The port's oracle against the port's `rasterize` (binning, pair
    lists, the plain blend) on a rotated camera with semantics."""
    jc, tc, g, _ = _inputs(400, 4, 96, 64, cam_seed=5, s_ch=3)
    b = toracle(tt(g["means"]), tt(g["opac"]), camera=tc, bg_color=tt(BG),
                colors=tt(g["colors"]), scales=tt(g["scales"]),
                rotations=tt(g["q"]), semantics=tt(g["sem"]))
    r = tr.rasterize(tt(g["means"]), tt(g["opac"]), camera=tc,
                     bg_color=tt(BG), colors=tt(g["colors"]),
                     scales=tt(g["scales"]), rotations=tt(g["q"]),
                     semantics=tt(g["sem"]), capacity=16384, device="cpu")
    assert not bool(r.overflow)
    near = _near(g, tc, 96, 64, (16, 16))
    np.testing.assert_array_equal(b.radii.numpy(), r.radii.numpy())
    for plane in ("color", "alpha", "semantic"):
        assert_planes(getattr(b, plane), getattr(r, plane), skip=near)
    assert_planes(b.depth, r.depth, atol=1e-4, skip=near)


def test_opaque_early_termination():
    """Dense opaque wall (tests/test_oracle.py): the early stop agrees
    with the JAX oracle and the scalar NumPy gold of the CUDA pipeline
    (rtol / atol 2e-4, the JAX test's)."""
    rng = np.random.default_rng(5)
    n = 400
    jc, tc = camera_pair(32, 32)
    means = np.stack([rng.uniform(-0.6, 0.6, n), rng.uniform(-0.6, 0.6, n),
                      rng.uniform(1.0, 3.0, n)], -1).astype(np.float32)
    scales = np.full((n, 3), 0.25, np.float32)
    q = np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1))
    opac = np.full(n, 0.97, np.float32)
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    b = toracle(tt(means), tt(opac), camera=tc, bg_color=torch.zeros(3),
                colors=tt(colors), scales=tt(scales), rotations=tt(q))
    a = joracle(jnp.asarray(means), jnp.asarray(opac), camera=jc,
                bg_color=jnp.zeros(3), colors=jnp.asarray(colors),
                scales=jnp.asarray(scales), rotations=jnp.asarray(q))
    ref = rasterize_np(means, opac, colors, np.asarray(jc.viewmatrix),
                       np.asarray(jc.projmatrix), 32, 32, jc.tan_fovx,
                       jc.tan_fovy, np.zeros(3), scales=scales, rotations=q)
    assert float(b.alpha.min()) > 0.99      # every pixel saturates
    for plane in ("color", "alpha"):
        np.testing.assert_allclose(getattr(b, plane).numpy(), ref[plane],
                                   rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(getattr(b, plane).numpy(),
                                   np.asarray(getattr(a, plane)),
                                   rtol=1e-4, atol=1e-5)
