"""The port's Waymo scene loading, scene builder and Waymo train step held
against the JAX package on the CPU, on a scene directory in the
converter's layout (`torch_parity.write_test_scene`: 6 frames of 128x96
PNGs loaded at resolution 2, a moving vehicle, a parked one that the
loaders drop, a pedestrian, sky masks, LiDAR depth, mono normals,
semantics, and a `pointcloud.npz` from which both packages build their
initial PLYs). Each package reads its own copy of the directory."""
import shutil

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from gaussianrpg_tpu.config.config import \
    load_config as j_load_config  # noqa: E402
from gaussianrpg_tpu.data.waymo import WaymoScene as JScene  # noqa: E402
from gaussianrpg_tpu.models import scene_builder as jsb  # noqa: E402
from gaussianrpg_tpu.models import scene_io as jio  # noqa: E402
from gaussianrpg_tpu.models.scene_graph import \
    total_capacity as j_total_capacity  # noqa: E402
from gaussianrpg_tpu.render import renderer as jren  # noqa: E402
from gaussianrpg_tpu.train import trainer as jtr  # noqa: E402

from gaussianrpg_tpu_torch.apps import train as tapp  # noqa: E402
from gaussianrpg_tpu_torch.config.config import load_config  # noqa: E402
from gaussianrpg_tpu_torch.data.waymo import WaymoScene  # noqa: E402
from gaussianrpg_tpu_torch.models import scene_builder as tsb  # noqa: E402
from gaussianrpg_tpu_torch.models import scene_graph as tsg  # noqa: E402
from gaussianrpg_tpu_torch.models import scene_io as tio  # noqa: E402
from gaussianrpg_tpu_torch.models.scene_graph import compose  # noqa: E402
from gaussianrpg_tpu_torch.ops import blend as tblend  # noqa: E402
from gaussianrpg_tpu_torch.ops import rasterize as TR  # noqa: E402
from gaussianrpg_tpu_torch.ops.rasterize import \
    primitive_fields  # noqa: E402
from gaussianrpg_tpu_torch.render import renderer as tren  # noqa: E402
from gaussianrpg_tpu_torch.train import trainer as ttr  # noqa: E402

from .test_torch_raster_grad import (COND_RTOL,  # noqa: E402
                                     _blend_backward_f64)
from .test_torch_blend_bwd import GRAD_RTOL  # noqa: E402
from .test_torch_train import _feed, _flat  # noqa: E402
from .torch_parity import (MOVING_TRACKS, PARKED_TRACK,  # noqa: E402
                           assert_planes, one_cpu_thread,  # noqa: F401
                           threshold_pixels, tree_of, tt, write_test_scene)

CONFIG = "configs/waymo_149_1cam.yaml"
SCENE_KW = dict(selected_frames=[0, 5], cameras=(0,), test_every=3,
                resolution=2)
CAPACITY = 32768
# colour leaves against the JAX step (test_waymo_train_step_matches_jax)
COLOUR_LEAVES = ("/features_dc", "/features_rest", "/semantic")
COLOUR_RTOL = 3e-4


def _opts(root, extra=()):
    return ["source_path", str(root), "data.selected_frames", "[0, 5]",
            "resolution", "2", "data.split_test", "3",
            "model.actor_capacity", "1024", *extra]


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """Two copies of the test scene, one a package."""
    base = tmp_path_factory.mktemp("waymo")
    write_test_scene(base / "jax")
    shutil.copytree(base / "jax", base / "port")
    return base / "jax", base / "port"


def test_scene_loading_matches_jax(dirs):
    """Cameras, tracklets, objects, val frames, images and every plane;
    the parked vehicle is dropped."""
    j, t = JScene(str(dirs[0]), **SCENE_KW), WaymoScene(str(dirs[1]),
                                                        **SCENE_KW)
    assert sorted(t.objects_info) == sorted(MOVING_TRACKS)
    assert PARKED_TRACK not in t.objects_info
    assert t.objects_info == j.objects_info
    np.testing.assert_array_equal(t.tracklets, j.tracklets)
    assert t.val_frames == j.val_frames == [0, 3]
    np.testing.assert_array_equal(t.frame_timestamps, j.frame_timestamps)
    for split in ("train", "test"):
        jc, tc = j.build_cameras(split), t.build_cameras(split,
                                                         device="cpu")
        assert len(tc) == len(jc) > 0
        for (a, ga), (b, gb) in zip(jc, tc):
            assert gb.shape == (3, 48, 64)
            np.testing.assert_array_equal(gb, ga)
            for f in ("viewmatrix", "projmatrix", "K", "cam_center",
                      "ego_pose", "extrinsic", "timestamp", "frame",
                      "image_id"):
                np.testing.assert_array_equal(getattr(b, f).numpy(),
                                              np.asarray(getattr(a, f)),
                                              err_msg=f)
            assert (b.width, b.height, b.cam_id) == (a.width, a.height,
                                                     a.cam_id)
            pj = j.load_batch_planes(int(a.frame), a.cam_id, ga.shape[1:])
            pt = t.load_batch_planes(int(b.frame), b.cam_id, gb.shape[1:])
            assert set(pt) == set(pj) == {"sky_mask", "lidar_depth",
                                          "obj_bound", "mono_normal",
                                          "semantic"}
            for k in pj:
                assert pt[k].dtype == pj[k].dtype, k
                np.testing.assert_array_equal(pt[k], pj[k], err_msg=k)
    assert t.native_size(0) == j.native_size(0) == (96, 128)


def test_init_pointclouds_auto_build_matches_jax(dirs):
    """Both packages build the same input_ply/ from pointcloud.npz."""
    from gaussianrpg_tpu.data.ply import read_ply as j_read_ply
    from gaussianrpg_tpu_torch.data.ply import read_ply

    j, t = JScene(str(dirs[0]), **SCENE_KW), WaymoScene(str(dirs[1]),
                                                        **SCENE_KW)
    pj, pt = j.load_init_pointclouds(), t.load_init_pointclouds()
    assert set(pt) == set(pj) == {"background", "lidar", *MOVING_TRACKS}
    for k in pj:
        for x, y in zip(pt[k], pj[k]):
            np.testing.assert_array_equal(x, y)
    names = sorted(p.name for p in (dirs[1] / "input_ply").iterdir())
    assert names == sorted(p.name for p in (dirs[0] / "input_ply").iterdir())
    for n in names:
        a = read_ply(str(dirs[1] / "input_ply" / n))
        b = j_read_ply(str(dirs[0] / "input_ply" / n))
        for e in b:
            np.testing.assert_array_equal(a[e], b[e])


def _build(dirs, extra=()):
    jcfg = j_load_config(CONFIG, _opts(dirs[0], extra))
    tcfg = load_config(CONFIG, _opts(dirs[1], extra))
    jscene = JScene(str(dirs[0]), **SCENE_KW)
    tscene = WaymoScene(str(dirs[1]), **SCENE_KW)
    return (jsb.build_scene_from_waymo(jscene, jcfg), jscene, jcfg,
            tsb.build_scene_from_waymo(tscene, tcfg, device="cpu"), tscene,
            tcfg)


def test_build_scene_matches_jax(dirs):
    """Integer and copied arrays exactly, floats at rtol 1e-6, the KNN
    log-scales at atol 1e-5."""
    (jm, jmeta, jarr, jnames), _, _, (tm, tmeta, tarr, tnames), _, _ = \
        _build(dirs)
    assert tnames == jnames == [f"obj_{t:03d}" for t in MOVING_TRACKS]
    assert {f: getattr(tmeta, f) for f in vars(tmeta)} == \
        {f: getattr(jmeta, f) for f in vars(tmeta)}
    assert tm.background.capacity == tsb._round_pow2(
        4 * int(tm.bkgd_aux.n_active)) == jm.background.capacity
    a = _flat({"models": tree_of(tm), "arrays": tree_of(tarr)})
    b = _flat({"models": tree_of(jm), "arrays": tree_of(jarr)})
    assert set(a) == set(b)
    for k in sorted(b):
        x, y = a[k], b[k]
        assert x.shape == y.shape, k
        if k.endswith("/scaling"):
            np.testing.assert_allclose(x, y, rtol=0, atol=1e-5, err_msg=k)
        elif y.dtype.kind == "f":
            np.testing.assert_allclose(x, y, rtol=1e-6, atol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(x, y.astype(x.dtype), err_msg=k)


def test_build_scene_random_draws_match_jax(tmp_path):
    """Without PLYs or a point cloud: the fallback background shell, the
    random actor grids and the sky-sphere Gaussians draw the same
    numbers."""
    write_test_scene(tmp_path / "s")
    (tmp_path / "s" / "pointcloud.npz").unlink()
    extra = ["model.nsg.include_sky_gaussians", "true",
             "model.sky_capacity", "2048", "model.actor_capacity", "16384"]
    cfg_j = j_load_config(CONFIG, _opts(tmp_path / "s", extra))
    cfg_t = load_config(CONFIG, _opts(tmp_path / "s", extra))
    jm, _, _, _ = jsb.build_scene_from_waymo(
        JScene(str(tmp_path / "s"), **SCENE_KW), cfg_j)
    tm, _, _, _ = tsb.build_scene_from_waymo(
        WaymoScene(str(tmp_path / "s"), **SCENE_KW), cfg_t, device="cpu")
    assert int(tm.bkgd_aux.n_active) == 100_000
    for name in ("background", "actors", "sky_gauss"):
        a = _flat(tree_of(getattr(tm, name)))
        b = _flat(tree_of(getattr(jm, name)))
        for k in b:
            tol = dict(atol=1e-5) if k == "/scaling" else dict(rtol=1e-6)
            np.testing.assert_allclose(a[k], b[k], err_msg=name + k, **tol)


# ------------------------------------------------------------ train step

STEP_EXTRA = ["data.use_semantic", "true", "data.num_classes", "3",
              "optim.lambda_semantic", "0.1", "optim.lambda_normal_mono",
              "0.1", "optim.lambda_reg", "0.1", "model.gaussian.sh_degree",
              "1"]


def _batches(scene, cams, cfg, jax_side):
    out = []
    for c, gt in cams:
        p = scene.load_batch_planes(int(c.frame), c.cam_id, gt.shape[1:])
        kw = dict(sky_mask=p["sky_mask"], lidar_depth=p["lidar_depth"],
                  obj_bound=p["obj_bound"], mono_normal=p["mono_normal"],
                  gt_semantic=p["semantic"])
        if jax_side:
            out.append(jtr.Batch(gt_image=jnp.asarray(gt),
                                 **{k: jnp.asarray(v) for k, v in
                                    kw.items()}))
        else:
            out.append(ttr.Batch(gt_image=tt(gt),
                                 **{k: tt(v) for k, v in kw.items()}))
    return out


# the OptimConfig keys that the JAX trainer's `main` reads from cfg.optim
# (gaussianrpg_tpu/apps/train.py:249-286)
OPTIM_KEYS = (
    "position_lr_init", "position_lr_final", "position_lr_max_steps",
    "feature_lr", "opacity_lr", "scaling_lr", "rotation_lr",
    "position_lr_init_obj", "position_lr_final_obj", "feature_lr_obj",
    "feature_rest_lr_obj", "scaling_lr_obj", "rotation_lr_obj",
    "opacity_lr_obj", "semantic_lr_obj", "lambda_l1", "lambda_dssim",
    "lambda_sky", "lambda_semantic", "lambda_depth_lidar", "lambda_reg",
    "lambda_normal_mono", "lambda_scale_flatten", "lambda_opacity_sparse",
    "densify_from_iter", "densify_until_iter", "densification_interval",
    "opacity_reset_interval", "densify_grad_threshold",
    "densify_grad_abs_bkgd", "densify_grad_threshold_obj",
    "densify_grad_abs_obj", "min_opacity", "percent_dense",
    "percent_big_ws")


def test_optim_config_reads_every_key():
    """`apps.train.optim_config` reads the JAX trainer's keys of
    cfg.optim, each overridable from the command line."""
    opts = []
    for i, k in enumerate(OPTIM_KEYS):
        opts += [f"optim.{k}", "yes" if "abs" in k else f"{i + 0.5}"]
    o = tapp.optim_config(load_config(CONFIG, opts))
    for i, k in enumerate(OPTIM_KEYS):
        assert getattr(o, k) == (True if "abs" in k else i + 0.5), k


@pytest.fixture(scope="module")
def waymo_step(dirs):
    """One train step of the built Waymo scene in both packages, every
    plane wired (sky, LiDAR depth, object bound, mono normal, semantic),
    from identical states and random draws (the actor flip's uniforms
    are JAX's); the port sums the pair cotangents in the JAX package's
    order (see tests/test_torch_train.py:_step_both)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TR, "_column_prefix_sums", lambda x: x.t().cumsum(dim=1))
        (jm, jmeta, jarr, _), jscene, jcfg, (tm, tmeta, tarr, _), tscene, \
            tcfg = _build(dirs, STEP_EXTRA)
        jcam, tcam = (jscene.build_cameras("train")[1],
                      tscene.build_cameras("train", device="cpu")[1])
        jb = _batches(jscene, [jcam], jcfg, True)[0]
        tb = _batches(tscene, [tcam], tcfg, False)[0]
        key = jax.random.PRNGKey(3)
        flip_key, _ = jax.random.split(key)
        _feed(mp, tsg, "_uniform", [np.asarray(jax.random.uniform(
            flip_key, (jmeta.num_actors, 1024)))])
        tocfg = tapp.optim_config(tcfg)
        jstep = jtr.make_train_step(
            jmeta, jarr, jtr.OptimConfig(**{k: getattr(tocfg, k)
                                            for k in OPTIM_KEYS}),
            jren.RenderOptions(capacity=CAPACITY, interpret=True,
                               render_normals=True), j_total_capacity(jm))
        jout = jstep(jtr.init_train_state(jm), jcam[0], jb, key, 1)
        tstep = ttr.make_train_step(
            tmeta, tarr, tocfg,
            tren.RenderOptions(capacity=CAPACITY, render_normals=True),
            tsg.total_capacity(tm), device="cpu")
        tout = tstep(ttr.init_train_state(tm), tcam[0], tb,
                     torch.Generator(), 1)
        mp.setattr(tblend, "blend_backward", _blend_backward_f64)
        t64 = tstep(ttr.init_train_state(tm), tcam[0], tb,
                    torch.Generator(), 1)
    return jout, tout, t64


def test_waymo_train_step_matches_jax(waymo_step):
    """Every loss term at 1e-5, the densification statistics at 1e-4, and
    the step's gradients (Adam's first moment, 0.1 x the gradient) against
    the JAX step: at GRAD_RTOL (5e-5) of each leaf's max, scales and
    rotations at COND_RTOL (5e-4) (tests/test_torch_raster_grad.py), and
    the colour leaves (SH coefficients, semantics) at COLOUR_RTOL (3e-4):
    of the leaf's max for the background, of the scene's largest gradient
    for the actors, whose colour gradients are ~1e-5 of it. On this scene
    the JAX step's colour gradients lie 1.5e-4 (background) and 2.1e-4 of
    the scene's largest (actors) from the port's, and as far from the
    port's step with its blend backward in float64: the JAX step's float32
    sums are the ones that are off there, so the port's colour leaves are
    also held within GRAD_RTOL of the float64 step. The JAX step's rotation
    gradients are NaN (the rendered-normals path; the tracked rotation
    residual's, ROADMAP faults): only there is the port held to the
    float64 step alone, finite and within COND_RTOL of it. The initial
    rotation gradients are zero in exact arithmetic (isotropic Gaussians):
    the port's must be below 1e-9."""
    (js, jloss, jsc, _), (ts, tloss, tsc, _), (t64, _, _, _) = waymo_step
    assert not tsc["overflow"] and not bool(jsc["overflow"])
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    terms = set(jsc) - {"overflow", "n_pairs"}
    assert terms == set(tsc) - {"overflow", "n_pairs"}
    assert {"sky", "lidar_depth", "semantic", "normal_cos", "obj_acc",
            "box_reg"} <= terms, terms
    for k in terms:
        np.testing.assert_allclose(float(tsc[k]), float(jsc[k]), rtol=1e-5,
                                   atol=1e-9, err_msg=k)
    assert int(tsc["n_pairs"]) == int(jsc["n_pairs"])
    mu_t, mu_j, mu_f = (_flat(tree_of(s.adam.mu)) for s in (ts, js, t64))
    assert set(mu_t) == set(mu_j) == set(mu_f)
    largest = max(np.abs(v).max() for v in mu_j.values()
                  if np.isfinite(v).all())
    by_jax, by_f64 = [], []
    for k in sorted(mu_j):
        x, y, z = (m[k].astype(np.float64) for m in (mu_t, mu_j, mu_f))
        assert np.isfinite(x).all() and np.isfinite(z).all(), k
        if np.abs(z).max() < 1e-9:
            # zero in exact arithmetic: every Gaussian starts isotropic
            # (one KNN scale on all three axes), so its rotation does not
            # move the image; the float64 step leaves rounding noise
            assert k.endswith("/rotation") and np.abs(x).max() < 1e-9, k
            continue
        if not np.isfinite(y).all():
            assert k.endswith(("/rotation", "/opt_rots")), k
            scale = np.abs(z).max()
            assert np.abs(x - z).max() <= COND_RTOL * scale, (
                k, np.abs(x - z).max() / scale)
            by_f64.append(k)
            continue
        rtol, scale = GRAD_RTOL, np.abs(y).max() + 1e-30
        if k.endswith(("/scaling", "/rotation", "/opt_rots")):
            rtol = COND_RTOL
        elif k.endswith(COLOUR_LEAVES):
            rtol = COLOUR_RTOL
            if k.startswith("/actors/"):
                scale = largest
            f64 = np.abs(z).max()
            assert np.abs(x - z).max() <= GRAD_RTOL * f64, (
                k, np.abs(x - z).max() / f64)
        assert np.abs(x - y).max() <= rtol * scale, (
            k, np.abs(x - y).max() / scale)
        by_jax.append(k)
    assert {"/background/xyz", "/background/opacity", "/background/scaling",
            "/background/features_dc", "/background/features_rest",
            "/actors/xyz", "/actors/opacity", "/actors/scaling",
            "/actors/features_dc", "/actors/features_rest",
            "/actor_pose/opt_trans"} <= set(by_jax), by_f64
    for name in ("bkgd_aux", "actors_aux"):
        a = _flat(tree_of(getattr(ts.models, name)))
        b = _flat(tree_of(getattr(js.models, name)))
        for k in b:
            y = b[k].astype(np.float64)
            assert np.abs(a[k] - y).max() <= 1e-4 * (np.abs(y).max()
                                                     + 1e-30), (name, k)


def test_render_after_jax_checkpoint_matches_jax(dirs, tmp_path):
    """The JAX package trains its scene a step and writes a checkpoint;
    the port builds the same scene, loads that checkpoint
    (`load_latest_checkpoint`) and renders the first train camera at the
    JAX package's render (rtol 1e-4 / atol 1e-5 outside threshold
    pixels)."""
    (jm, jmeta, jarr, _), jscene, jcfg, (tm, tmeta, tarr, _), tscene, \
        _ = _build(dirs)
    rng = np.random.default_rng(9)
    bk = jm.background
    n = int(jm.bkgd_aux.n_active)
    dc = np.asarray(bk.features_dc).copy()
    dc[:n] += 0.3 * rng.standard_normal((n,) + dc.shape[1:])
    jstate = jtr.init_train_state(jm.replace(
        background=bk.replace(features_dc=jnp.asarray(dc.astype(
            np.float32))),
        actor_pose=jm.actor_pose.replace(opt_trans=jnp.asarray(
            0.1 * rng.standard_normal(jm.actor_pose.opt_trans.shape)
            .astype(np.float32)))))
    jio.save_checkpoint(str(tmp_path / "iteration_7.npz"), jstate, 7, 3)
    loaded = tio.load_latest_checkpoint(str(tmp_path), tm)
    np.testing.assert_array_equal(loaded.background.features_dc.numpy(),
                                  dc.astype(np.float32))
    jcam = jscene.build_cameras("train")[0][0]
    tcam = tscene.build_cameras("train", device="cpu")[0][0]
    a = jren.render_scene(jstate.models, jmeta, jarr, jcam,
                          active_sh_degree=3,
                          options=jren.RenderOptions(capacity=CAPACITY,
                                                     interpret=True))
    b = tren.render_scene(loaded, tmeta, tarr, tcam, active_sh_degree=3,
                          options=tren.RenderOptions(capacity=CAPACITY),
                          device="cpu")
    assert not bool(b.overflow) and int(b.n_pairs) == int(a.n_pairs)
    scene = compose(loaded, tmeta, tarr, tcam, 3)
    fs = primitive_fields(scene.means3d, scene.opacity, camera=tcam,
                          colors=scene.colors, scales=scene.scales,
                          rotations=scene.rotations, active_mask=scene.mask)
    near = threshold_pixels(fs.fields, fs.radii, fs.depths, tcam.width,
                            tcam.height)
    assert near.sum() <= near.size // 100
    assert_planes(b.rgb, a.rgb, skip=near)
    assert_planes(b.depth, a.depth, atol=1e-4, skip=near)
    assert float(b.acc.max()) > 0.5
