"""The port's multi-device layer (`parallel/sharded.py`,
`parallel/distributed.py`) held against the JAX package on the CPU,
mirroring tests/test_sharded.py. The port's ranks are spawned processes in
a gloo group (`tests/torch_dist.py`); the JAX references run here, on the
8 CPU devices of tests/conftest.py, in interpret mode. Strip cameras
against JAX's (K and view matrix equal in float32, projection 1e-6);
`render_strips` on 2 and 4 ranks against JAX's single-device render
(rtol / atol 1e-5, tests/test_sharded.py:40-41) and its gradients on 2
ranks (max-relative 1e-4, :64-67); `render_scene_sharded`'s radii equal to
JAX's `render_scene_sharded` on a mesh of the same size, padding rows
included; `render_sharded_2d` on 2x2 (forward) and 1x2 (gradients); the
overlapped per-sub-strip all-reduces against one all-reduce (loss rtol
1e-6, gradients rtol 1e-5 / atol 1e-6) and against the single-device
gradients (1e-4); `initialize` without a launcher."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from gaussianrpg_tpu.ops.rasterize import \
    rasterize as j_rasterize  # noqa: E402
from gaussianrpg_tpu.parallel import sharded as jsh  # noqa: E402
from gaussianrpg_tpu.render.renderer import RenderOptions  # noqa: E402
from gaussianrpg_tpu.utils import synthetic as jsyn  # noqa: E402

from gaussianrpg_tpu_torch.ops.rasterize import rasterize  # noqa: E402
from gaussianrpg_tpu_torch.parallel import distributed as tdist  # noqa: E402
from gaussianrpg_tpu_torch.parallel import sharded as tsh  # noqa: E402

from . import torch_dist as D  # noqa: E402
from .conftest import make_test_camera, random_gaussians  # noqa: E402
from .torch_parity import (camera_pair, one_cpu_thread,  # noqa: E402,F401
                           tree_of)


def _scene(n=400):
    """tests/test_sharded._scene: (means, opacities, colours, scales,
    rotations) as numpy."""
    means, scales, q, opac, colors = random_gaussians(
        n, np.random.default_rng(1))
    return [means, opac, colors, scales, q]


def _jax_render(cam, args, capacity):
    out = j_rasterize(*map(jnp.asarray, args[:2]), colors=jnp.asarray(
        args[2]), scales=jnp.asarray(args[3]), rotations=jnp.asarray(
        args[4]), camera=cam, bg_color=jnp.asarray(D.BG), capacity=capacity,
        interpret=True)
    return jnp.concatenate([out.color, out.depth, out.alpha], axis=0)


def _jax_grads(size, args, capacity, idx):
    """Gradients of sum(color^2) of JAX's single-device render."""
    cam = make_test_camera(width=size[0], height=size[1])

    def loss(*a):
        return jnp.sum(_jax_render(cam, a, capacity)[:3] ** 2)

    g = jax.grad(loss, argnums=tuple(idx))(*map(jnp.asarray, args))
    return [np.asarray(x) for x in g]


def _max_rel(port, ref):
    return np.abs(port - ref).max() / (np.abs(ref).max() + 1e-8)


# ------------------------------------------------------------ strip cameras

@pytest.mark.parametrize("size", [(64, 96), (1600, 1066)])
@pytest.mark.parametrize("n", [2, 3, 4])
def test_strip_cameras_match_jax(size, n):
    jc, tc = camera_pair(*size)
    ref = jsh.strip_cameras(jc, n)
    strips = tsh.strip_cameras(tc, n)
    assert len(strips) == n
    tan_fovy = jsh._strip_tan_fovy(jc, ref.height)
    for d, s in enumerate(strips):
        assert (s.width, s.height) == (jc.width, ref.height)
        assert ref.height % 16 == 0 and n * ref.height >= jc.height
        np.testing.assert_array_equal(s.K.numpy(), np.asarray(ref.K[d]))
        np.testing.assert_array_equal(s.viewmatrix.numpy(),
                                      np.asarray(ref.viewmatrix[d]))
        p_ref = np.asarray(ref.projmatrix[d])
        np.testing.assert_allclose(s.projmatrix.numpy(), p_ref, rtol=1e-6,
                                   atol=1e-6 * np.abs(p_ref).max())
        local = jsh._strip_camera_local(
            jc, jax.tree.map(lambda x: x[d], ref), ref.height, tan_fovy)
        for f in ("tan_fovx", "tan_fovy", "lim_tan_fovx", "lim_tan_fovy",
                  "full_width", "full_height"):
            assert getattr(s, f) == pytest.approx(getattr(local, f),
                                                  rel=1e-7), f
        for f in ("cam_center", "ego_pose", "extrinsic", "timestamp"):
            np.testing.assert_array_equal(getattr(s, f).numpy(),
                                          np.asarray(getattr(ref, f)[d]))
        assert int(s.frame) == int(ref.frame[d])


# ------------------------------------------------------------ render_strips

@pytest.mark.parametrize("world", [2, 4])
def test_render_strips_matches_jax_single_device(world, tmp_path):
    args = _scene()
    single = np.asarray(_jax_render(make_test_camera(64, 96), args, 8192))
    for planes in D.spawn(D.strips_forward, world, tmp_path, (64, 96), args,
                          8192):
        np.testing.assert_allclose(planes, single, rtol=1e-5, atol=1e-5)


def test_render_strips_gradients_match_jax(tmp_path):
    """2 strips at 32x32 (tests/test_sharded.py:45): the gradients summed
    over the ranks equal JAX's single-device ones to 1e-4 of their max,
    and every rank holds the same."""
    args = _scene(100)
    ref = _jax_grads((32, 32), args, 1024, [0, 1, 2])
    outs = D.spawn(D.strips_grads, 2, tmp_path, (32, 32), args, 1024,
                   [0, 1, 2])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    for g, r in zip(outs[0], ref):
        assert _max_rel(g, r) < 1e-4


# ---------------------------------------------------- render_scene_sharded

@pytest.mark.parametrize("world", [2, 3])
def test_render_scene_sharded_radii_equal_jax_sharded(world, tmp_path):
    """The composite scene on a 48x40 camera: 2 strips of 32 rows (24
    padding rows) or 3 of 16 (8). Radii and visibility equal JAX's
    `render_scene_sharded` on a mesh of as many devices (its pmax, padding
    rows and all), the planes within 1e-5 of it."""
    models, meta, arrays = jsyn.make_scene(
        n_background=300, bkgd_capacity=384, n_actors=1, actor_capacity=128,
        n_frames=4)
    cam = jsyn.make_cameras(n_frames=4, width=48, height=40)[1]
    mesh = jsh.make_mesh(jax.devices()[:world])
    # jitted: eager shard_map in interpret mode compiles op by op (~55 s)
    ref = jax.jit(lambda m, c: jsh.render_scene_sharded(
        m, meta, arrays, c, mesh, active_sh_degree=1,
        options=RenderOptions(capacity=4096, interpret=True)))(models, cam)
    tree = {"models": tree_of(models), "meta": tree_of(meta),
            "arrays": tree_of(arrays)}
    outs = D.spawn(D.scene_sharded_radii, world, tmp_path, tree, (48, 40),
                   4096)
    for out in outs:
        np.testing.assert_array_equal(out["radii"], np.asarray(ref.radii))
        np.testing.assert_array_equal(out["visibility"],
                                      np.asarray(ref.visibility))
        assert out["overflow"] == bool(ref.overflow)
        np.testing.assert_allclose(out["rgb"], np.asarray(ref.rgb),
                                   rtol=1e-5, atol=1e-5)
    assert int(np.sum(outs[0]["radii"] > 0)) > 100


# ------------------------------------------------------ render_sharded_2d

def test_render_sharded_2d_matches_jax_single_device(tmp_path):
    """2x2 ("data", "model") mesh, 200 Gaussians (100 a model shard): the
    tiled gather restores the global order, so the forward equals the
    single-device render (tests/test_sharded.py:138)."""
    args = _scene(200)
    single = np.asarray(_jax_render(make_test_camera(48, 64), args, 2048))
    for planes in D.spawn(D.sharded_2d, 4, tmp_path, (2, 2), (48, 64), args,
                          2048, []):
        np.testing.assert_allclose(planes, single, rtol=1e-5, atol=1e-5)


def test_render_sharded_2d_gradients_match_jax(tmp_path):
    """1x2 mesh (tests/test_sharded.py:157): each model rank's gradients
    come back through the reduce-scatter; summed over the mesh they equal
    JAX's single-device gradients of means and colours to 1e-4."""
    args = _scene(100)
    ref = _jax_grads((32, 16), args, 1024, [0, 2])
    outs = D.spawn(D.sharded_2d, 2, tmp_path, (1, 2), (32, 16), args, 1024,
                   [0, 2])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    for g, r in zip(outs[0], ref):
        assert _max_rel(g, r) < 1e-4


# -------------------------------------------------- overlapped all-reduce

def test_psum_overlap_split_matches_single_psum(tmp_path):
    """tests/test_sharded.py:298: 2 ranks x 2 sub-strips of a 32x64
    camera. One asynchronous all-reduce per sub-strip gives the loss and
    gradients of one all-reduce at the end, and both match JAX's
    single-device gradients."""
    args = _scene(120)
    ov = D.spawn(D.psum_overlap, 2, tmp_path / "ov", (32, 64), args, 1024,
                 2, True)
    one = D.spawn(D.psum_overlap, 2, tmp_path / "one", (32, 64), args, 1024,
                  2, False)
    ref = _jax_grads((32, 64), args, 1024, range(5))
    loss_ref = float(jnp.sum(_jax_render(make_test_camera(32, 64), args,
                                         1024)[:3] ** 2))
    for (l_ov, g_ov), (l_one, g_one) in zip(ov, one):
        assert np.isfinite(l_ov)
        np.testing.assert_allclose(l_ov, l_one, rtol=1e-6)
        np.testing.assert_allclose(l_ov, loss_ref, rtol=1e-5)
        for a, b, r in zip(g_ov, g_one, ref):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
            assert _max_rel(a, r) < 1e-4


def test_psum_overlap_refuses_a_2_axis_mesh():
    """As tests/test_sharded.py's JAX function asserts: a 2-axis mesh
    would drop strips from the loss."""
    axes = {n: tsh.Axis(n, None, 1, 0) for n in ("data", "model")}
    mesh = tsh.Mesh(("data", "model"), np.zeros((1, 1), int), axes, None)
    with pytest.raises(ValueError, match="1-axis"):
        tsh.value_and_grad_psum_overlapped(None, None, mesh, None, 2)


def test_model_shards_must_divide_the_gaussians():
    """`rasterize(model_axis=...)`: N must divide by the number of model
    shards, the axis's size (the JAX package asserts it,
    ops/rasterize.py:784)."""
    means, opac, colors, scales, q = map(torch.as_tensor, _scene(100))
    _, cam = camera_pair(32, 16)
    axis = tsh.Axis("model", None, 3, 0)
    with pytest.raises(ValueError, match="3-rank axis"):
        rasterize(means, opac, camera=cam, bg_color=torch.zeros(3),
                  colors=colors, scales=scales, rotations=q,
                  model_axis=axis, device="cpu")


# ------------------------------------------------------------ distributed

def test_initialize_without_launcher_returns_false(monkeypatch):
    for k in tdist.LAUNCHER_ENV + ("LOCAL_RANK",):
        monkeypatch.delenv(k, raising=False)
    assert tdist.initialize() is False
    assert tdist.initialize("gloo") is False
    assert not torch.distributed.is_initialized()
    rank, world, _ = tdist.host_local_mesh_info()
    assert (rank, world) == (0, 1)
