"""The port's evaluation and export apps (`apps.render`, `apps.metrics`,
`apps.render_lite`, `apps.make_ply`, `apps.view`) held against the JAX
package's apps on the CPU. The port's trainer writes a checkpoint of the
test scene (`torch_parity.write_test_scene`); both packages' apps then
read that same file, each from its own copy of the scene directory (the
loaders write `input_ply/` there)."""
import json
import os
import shutil

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from gaussianrpg_tpu.apps import make_ply as jmake_ply  # noqa: E402
from gaussianrpg_tpu.apps import metrics as jmetrics  # noqa: E402
from gaussianrpg_tpu.apps import render as jrender  # noqa: E402
from gaussianrpg_tpu.apps import render_lite as jrender_lite  # noqa: E402
from gaussianrpg_tpu.config.config import \
    load_config as j_load_config  # noqa: E402
from gaussianrpg_tpu.render import renderer as jren  # noqa: E402

from gaussianrpg_tpu_torch.apps import make_ply as tmake_ply  # noqa: E402
from gaussianrpg_tpu_torch.apps import metrics as tmetrics  # noqa: E402
from gaussianrpg_tpu_torch.apps import render as trender  # noqa: E402
from gaussianrpg_tpu_torch.apps import render_lite as trender_lite  # noqa
from gaussianrpg_tpu_torch.apps import train as tapp  # noqa: E402
from gaussianrpg_tpu_torch.apps import view as tview  # noqa: E402
from gaussianrpg_tpu_torch.config.config import load_config  # noqa: E402
from gaussianrpg_tpu_torch.data.image_io import read_png  # noqa: E402
from gaussianrpg_tpu_torch.data.ply import read_ply  # noqa: E402
from gaussianrpg_tpu_torch.models.scene_graph import compose  # noqa: E402
from gaussianrpg_tpu_torch.models.scene_io import \
    load_gaussians_from_ply  # noqa: E402
from gaussianrpg_tpu_torch.ops.rasterize import \
    primitive_fields  # noqa: E402
from gaussianrpg_tpu_torch.render import renderer as tren  # noqa: E402
from gaussianrpg_tpu_torch.sim.tape import load_tape  # noqa: E402

from .torch_parity import (assert_planes, one_cpu_thread,  # noqa: E402,F401
                           threshold_pixels, write_test_scene)

CONFIG = "configs/waymo_149_1cam.yaml"
METRIC_RTOL = 1e-5    # PSNR and SSIM of one directory, JAX app vs port app
PLY_TOL = 1e-5        # make_ply fields, of each field's largest magnitude


def _opts(root, model_path):
    return ["source_path", str(root), "data.selected_frames", "[0, 5]",
            "resolution", "2", "data.split_test", "3",
            "model.actor_capacity", "1024", "render.save_video", "False",
            "model_path", str(model_path)]


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    """No TensorBoard writer (importing it loads TensorFlow here, ~10 s)."""
    monkeypatch.setattr(tapp, "_make_writer", lambda logdir: None)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """(base dir, the port's scene copy, the JAX package's copy): the port's
    `apps.train` ran 3 steps on the port's copy, writing
    `base/trained/trained_model/iteration_3.npz`."""
    base = tmp_path_factory.mktemp("eval_apps")
    write_test_scene(base / "port_scene")
    shutil.copytree(base / "port_scene", base / "jax_scene")
    old = tapp._make_writer
    tapp._make_writer = lambda logdir: None
    try:
        tapp.main(["--device", "cpu", "--config", CONFIG,
                   *_opts(base / "port_scene", base / "trained"),
                   "train.iterations", "3"])
    finally:
        tapp._make_writer = old
    assert (base / "trained" / "trained_model" / "iteration_3.npz").exists()
    return base


def _model_dir(trained, name):
    """A model directory holding a copy of the trained checkpoint."""
    out = trained / name
    if not out.exists():
        shutil.copytree(trained / "trained" / "trained_model",
                        out / "trained_model")
    return out


def _rendered(trained):
    """Both apps' `evaluate` runs (once a module): (JAX model dir, port
    model dir)."""
    jout, tout = trained / "jax_eval", trained / "port_eval"
    if not (tout / "evaluate_train").exists():
        _model_dir(trained, "jax_eval")
        _model_dir(trained, "port_eval")
        jrender.main(["--config", CONFIG,
                      *_opts(trained / "jax_scene", jout)])
        trender.main(["--device", "cpu", "--config", CONFIG,
                      *_opts(trained / "port_scene", tout)])
    return jout, tout


def test_render_app_matches_jax(trained, capsys):
    """`apps.render.main` (evaluate) writes the JAX app's files: the same
    `_rgb.png` / `_gt.png` names, ground truths equal, renders within
    1/255 (both quantize by truncation); it prints ms/view and FPS."""
    capsys.readouterr()
    jout, tout = _rendered(trained)
    log = capsys.readouterr().out
    assert "loaded checkpoint iteration_3" in log
    assert "ms/view" in log and "FPS" in log
    jfiles = sorted(os.listdir(jout / "evaluate_train"))
    tfiles = sorted(os.listdir(tout / "evaluate_train"))
    assert jfiles == tfiles and len(tfiles) == 12   # 6 views, rgb + gt
    for name in tfiles:
        a = read_png(str(jout / "evaluate_train" / name)).astype(int)
        b = read_png(str(tout / "evaluate_train" / name)).astype(int)
        if name.endswith("_gt.png"):
            np.testing.assert_array_equal(b, a)
        else:
            assert np.abs(b - a).max() <= 1, name
    assert not (tout / "evaluate_test").exists()


def test_eval_scene_renders_match_jax(trained):
    """Both packages' `load_scene_for_eval` + `render_scene` on every view
    of the trained scene: rgb rtol 1e-4 / atol 1e-5, depth atol 1e-4,
    outside threshold pixels; the same pair counts."""
    jcfg = j_load_config(CONFIG, _opts(trained / "jax_scene",
                                       trained / "trained"))
    tcfg = load_config(CONFIG, _opts(trained / "port_scene",
                                     trained / "trained"))
    jm, jmeta, jarr, jcams, jtest, jsh = jrender.load_scene_for_eval(jcfg)
    tm, tmeta, tarr, tcams, ttest, tsh = trender.load_scene_for_eval(
        tcfg, "cpu")
    assert (jsh, len(jcams), jtest) == (tsh, len(tcams), ttest)
    cap = 32768
    jrender_jit = jax.jit(jren.render_scene, static_argnames=(
        "active_sh_degree", "options", "include_background",
        "include_objects", "train_mode"))
    for (jcam, jgt), (tcam, tgt) in zip(jcams, tcams):
        np.testing.assert_array_equal(tgt, jgt)
        a = jrender_jit(jm, jmeta, jarr, jcam, active_sh_degree=jsh,
                        options=jren.RenderOptions(capacity=cap,
                                                   interpret=True))
        b = tren.render_scene(tm, tmeta, tarr, tcam, active_sh_degree=tsh,
                              options=tren.RenderOptions(capacity=cap),
                              device="cpu")
        assert not bool(b.overflow) and int(b.n_pairs) == int(a.n_pairs)
        scene = compose(tm, tmeta, tarr, tcam, tsh)
        fs = primitive_fields(scene.means3d, scene.opacity, camera=tcam,
                              colors=scene.colors, scales=scene.scales,
                              rotations=scene.rotations,
                              active_mask=scene.mask)
        near = threshold_pixels(fs.fields, fs.radii, fs.depths, tcam.width,
                                tcam.height)
        assert near.sum() <= near.size // 100
        assert_planes(b.rgb, a.rgb, skip=near)
        assert_planes(b.depth, a.depth, atol=1e-4, skip=near)
        assert_planes(b.acc, a.acc, skip=near)


def test_metrics_app_matches_jax(trained):
    """`apps.metrics.main` and the JAX app on the same PNGs: PSNR and SSIM
    (mean and per view) within METRIC_RTOL; the same files and keys; no
    LPIPS without weights or the `lpips` package."""
    _, tout = _rendered(trained)
    jdir = trained / "metrics_jax"
    shutil.copytree(tout / "evaluate_train", jdir / "evaluate_train")
    jmetrics.main(["model_path", str(jdir)])
    tmetrics.main(["--device", "cpu", "model_path", str(tout)])
    for split in ("results_train.json", "per_view_train.json"):
        j = json.loads((jdir / split).read_text())
        t = json.loads((tout / split).read_text())
        assert sorted(j) == sorted(t)
        if split.startswith("results"):
            assert "lpips" not in t and t["n_views"] == j["n_views"] == 6
            pairs = [(t[k], j[k]) for k in ("psnr", "ssim")]
        else:
            pairs = [(t[v][k], j[v][k]) for v in j for k in ("psnr", "ssim")]
        for got, want in pairs:
            assert got == pytest.approx(want, rel=METRIC_RTOL)


def test_render_lite_tape_matches_jax(trained):
    """`apps.render_lite.main`: the JAX app's tape (ids, timestamps, poses
    within 1e-6), len(train cameras) x round(50 / 10) upsampled poses,
    read back by the port's `sim/tape`."""
    jt, tt_ = trained / "tape_jax.json", trained / "tape_port.json"
    opts_j = _opts(trained / "jax_scene", _model_dir(trained, "tape_j"))
    opts_t = _opts(trained / "port_scene", _model_dir(trained, "tape_t"))
    jrender_lite.main(["--config", CONFIG, "--out", str(jt), *opts_j])
    trender_lite.main(["--device", "cpu", "--config", CONFIG, "--out",
                       str(tt_), *opts_t])
    j, t = load_tape(str(jt)), load_tape(str(tt_))
    assert (t["image_freq"], t["dynamic_freq"]) == (j["image_freq"],
                                                   j["dynamic_freq"])
    assert len(t["frames"]) == len(j["frames"]) == (6 - 1) * 5 + 1
    for a, b in zip(t["frames"], j["frames"]):
        assert sorted(a) == sorted(b) and a["id"] == b["id"]
        for k in ("timestamp", "rotation_matrix", "position", "ego_pose"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-6, atol=1e-6)


def test_make_ply_matches_jax(trained):
    """`apps.make_ply.main --frame 2`: the JAX app's flat PLY (the same
    vertex count and properties, each within PLY_TOL of its largest
    magnitude); it loads back through `load_gaussians_from_ply`."""
    jp, tp = trained / "flat_jax.ply", trained / "flat_port.ply"
    jmake_ply.main(["--config", CONFIG, "--frame", "2", "--out", str(jp),
                    *_opts(trained / "jax_scene",
                           _model_dir(trained, "ply_j"))])
    tmake_ply.main(["--device", "cpu", "--config", CONFIG, "--frame", "2",
                    "--out", str(tp),
                    *_opts(trained / "port_scene",
                           _model_dir(trained, "ply_t"))])
    j, t = read_ply(str(jp))["vertex"], read_ply(str(tp))["vertex"]
    assert t.dtype.names == j.dtype.names and len(t) == len(j) > 0
    for name in t.dtype.names:
        scale = max(float(np.abs(j[name]).max()), 1e-30)
        np.testing.assert_allclose(t[name], j[name], rtol=0,
                                   atol=PLY_TOL * scale, err_msg=name)
    params, aux = load_gaussians_from_ply(str(tp), device="cpu")
    assert int(aux.n_active) == len(t)


def test_synthetic_branch(tmp_path):
    """Without `source_path`: `apps.train --synthetic` writes its
    checkpoint, and `apps.render` renders the trainer's scene from it at
    the JAX app's cameras (make_cameras(), no ground truth). Held to the
    JAX app's steps with the JAX trainer's scene (`make_scene` at 5000 /
    16384, 2 actors of 1024, SH 3, Fourier 1; the JAX app builds
    `make_scene()` at its defaults here, ROADMAP §3): PNGs within 1/255."""
    from gaussianrpg_tpu.models.scene_io import load_checkpoint
    from gaussianrpg_tpu.train.trainer import init_train_state
    from gaussianrpg_tpu.utils.synthetic import make_cameras, make_scene

    out = tmp_path / "syn"
    tapp.main(["--device", "cpu", "--synthetic", "--iterations", "2",
               "model_path", str(out)])
    trender.main(["--device", "cpu", "model_path", str(out),
                  "render.save_video", "False"])
    files = sorted(os.listdir(out / "evaluate_train"))
    assert len(files) == 10 and all(f.endswith("_rgb.png") for f in files)

    models, meta, arrays = make_scene(
        n_background=5000, bkgd_capacity=16384, n_actors=2,
        actor_capacity=1024, n_frames=10, sh_degree=3, fourier_dim=1)
    state, step, sh = load_checkpoint(
        str(out / "trained_model" / "iteration_2.npz"),
        init_train_state(models))
    assert step == 2
    cams = make_cameras()
    opts = jren.probe_scene_capacity(state.models, meta, arrays, cams,
                                     active_sh_degree=sh,
                                     options=jren.RenderOptions(),
                                     slack=1.15)
    render = jax.jit(jren.render_scene, static_argnames=(
        "active_sh_degree", "options", "include_background",
        "include_objects", "train_mode"))
    for cam in cams:
        res = render(state.models, meta, arrays, cam, active_sh_degree=sh,
                     options=opts)
        want = (np.clip(np.asarray(res.rgb), 0, 1).transpose(1, 2, 0)
                * 255).astype(np.uint8).astype(int)
        got = read_png(str(out / "evaluate_train"
                           / f"{int(cam.frame):06d}_0_rgb.png")).astype(int)
        assert np.abs(got - want).max() <= 1


def test_view_offscreen_writes_frames(tmp_path, capsys, monkeypatch):
    """`apps.view.main --synthetic --offscreen`: one PNG a frame and the
    average render time. The app asks for the JAX app's synthetic street
    (20000 / 32768, 2 actors of 2048, 10 frames at 512x320); here the
    calls are recorded and served at a tenth of the Gaussians and a
    quarter of the width and height (the full size takes ~15 s a frame
    on one CPU thread; `chip_smoke.py` phase `eval` runs it on the
    card)."""
    from gaussianrpg_tpu_torch.utils import synthetic

    asked = {}
    make_scene, make_cameras = synthetic.make_scene, synthetic.make_cameras

    def small_scene(**kw):
        asked["scene"] = dict(kw)
        kw.update(n_background=2000, bkgd_capacity=4096, actor_capacity=512)
        return make_scene(**kw)

    def small_cameras(**kw):
        asked["cameras"] = dict(kw)
        kw.update(width=kw["width"] // 4, height=kw["height"] // 4)
        return make_cameras(**kw)

    monkeypatch.setattr(synthetic, "make_scene", small_scene)
    monkeypatch.setattr(synthetic, "make_cameras", small_cameras)
    out = tmp_path / "view"
    times = tview.main(["--device", "cpu", "--synthetic", "--offscreen",
                        "--out", str(out)])
    assert asked["scene"] == dict(n_background=20000, bkgd_capacity=32768,
                                  n_actors=2, actor_capacity=2048,
                                  n_frames=10, device=torch.device("cpu"))
    assert asked["cameras"] == dict(n_frames=10, width=512, height=320,
                                    device=torch.device("cpu"))
    assert len(times) == 10
    files = sorted(os.listdir(out))
    assert files == [f"{i:06d}.png" for i in range(10)]
    img = read_png(str(out / files[0]))
    assert img.shape == (80, 128, 3) and img.max() > 0
    assert "average render time" in capsys.readouterr().out


def test_apps_refuse_a_missing_card():
    """Without CUDA the eval apps raise unless the CPU is named."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for app in (trender, tmetrics, trender_lite, tmake_ply, tview):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            app.main(["model_path", "unused"])
