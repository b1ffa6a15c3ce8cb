"""The port's training and simulation CLIs on a Waymo scene directory
(`torch_parity.write_test_scene`), held against the JAX package's files
and apps on the CPU: the trainer writes a checkpoint the JAX package
reads and resumes from it, with a config and with `--synthetic`; the
simulator, on a checkpoint the JAX package wrote, prints the JAX app's
verdict line; `--mesh` outside a launch is refused."""
import json
import shutil

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from gaussianrpg_tpu.config.config import \
    load_config as j_load_config  # noqa: E402
from gaussianrpg_tpu.data.waymo import WaymoScene as JScene  # noqa: E402
from gaussianrpg_tpu.models import scene_io as jio  # noqa: E402
from gaussianrpg_tpu.models.scene_builder import \
    build_scene_from_waymo as j_build  # noqa: E402
from gaussianrpg_tpu.train import trainer as jtr  # noqa: E402

from gaussianrpg_tpu_torch.apps import simulate as tsim  # noqa: E402
from gaussianrpg_tpu_torch.apps import train as tapp  # noqa: E402

from .torch_parity import (MOVING_TRACKS, one_cpu_thread,  # noqa: E402,F401
                           write_test_scene)

CONFIG = "configs/waymo_149_1cam.yaml"


def _opts(root, model_path, extra=()):
    return ["source_path", str(root), "data.selected_frames", "[0, 5]",
            "resolution", "2", "data.split_test", "3",
            "model.actor_capacity", "1024", "model_path", str(model_path),
            *extra]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("apps") / "scene"
    write_test_scene(root)
    return root


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    """No TensorBoard writer (importing it loads TensorFlow here, ~10 s)."""
    monkeypatch.setattr(tapp, "_make_writer", lambda logdir: None)


def test_train_cli_writes_jax_checkpoint_and_resumes(scene, tmp_path,
                                                     capsys):
    """`apps.train.main` with `--device cpu --config ... KEY VALUE`: 3
    steps write `iteration_3.npz` (and the composite PLY) that the JAX
    `load_checkpoint` reads into its own scene of the same directory; a
    second call with 5 iterations resumes from it."""
    src = tmp_path / "scene"
    shutil.copytree(scene, src)
    out = tmp_path / "out"
    state, rec = tapp.main(["--device", "cpu", "--config", CONFIG,
                            *_opts(src, out, ["train.iterations", "3"])])
    assert len(rec["loss"]) == 3 and np.isfinite(rec["loss"]).all()
    assert rec["evals"] and rec["evals_test"]
    ckpt = out / "trained_model" / "iteration_3.npz"
    assert ckpt.exists()
    assert (out / "point_cloud" / "iteration_3" / "point_cloud.ply").exists()

    jcfg = j_load_config(CONFIG, _opts(src, out))
    jm, _, _, _ = j_build(JScene(str(src), selected_frames=[0, 5],
                                 resolution=2), jcfg)
    jstate, step, sh = jio.load_checkpoint(str(ckpt),
                                           jtr.init_train_state(jm))
    assert (step, sh) == (3, 0) and int(jstate.step) == 3
    np.testing.assert_array_equal(
        np.asarray(jstate.models.background.xyz),
        state.models.background.xyz.numpy())
    np.testing.assert_array_equal(np.asarray(jstate.adam.mu["actors"].xyz),
                                  state.adam.mu["actors"].xyz.numpy())

    capsys.readouterr()
    state2, rec2 = tapp.main(["--device", "cpu", "--config", CONFIG,
                              *_opts(src, out, ["train.iterations", "5"])])
    log = capsys.readouterr().out
    assert "resumed from iteration 3" in log
    assert len(rec2["loss"]) == 2 and state2.step == 5
    assert (out / "trained_model" / "iteration_5.npz").exists()


def _jax_config_loop(cfg, cipv_id, simulation_time):
    """The JAX app's `main --config` run with the box-projection detector:
    its `config_setup` steps and `run_closed_loop` call, replayed with the
    JAX package's parts. (`gaussianrpg_tpu.apps.simulate.config_setup`
    itself raises UnboundLocalError on this path: the `import numpy as np`
    inside its fused-YOLO branch makes `np` local to the function.)"""
    import os

    from gaussianrpg_tpu.models.scene_io import load_latest_checkpoint
    from gaussianrpg_tpu.render.renderer import (options_from_cfg,
                                                 probe_scene_capacity,
                                                 render_scene,
                                                 render_until_fit)
    from gaussianrpg_tpu.sim.detector import BoxProjectionDetector
    from gaussianrpg_tpu.sim.loop import run_closed_loop
    from gaussianrpg_tpu.sim.tape import load_tape

    scene = JScene(cfg.source_path,
                   selected_frames=cfg.data.selected_frames or None,
                   cameras=tuple(cfg.data.cameras),
                   box_scale=cfg.data.get("box_scale", 1.0))
    models, meta, arrays, _ = j_build(scene, cfg)
    models = load_latest_checkpoint(cfg.trained_model_dir, models)
    tape = load_tape(cfg.sim.traj_file_path)
    cams = scene.build_cameras("train")
    cam0 = cams[0][0]
    options = probe_scene_capacity(
        models, meta, arrays, [c for c, _ in cams],
        active_sh_degree=meta.bkgd_sh_degree,
        options=options_from_cfg(cfg.render), slack=1.3)
    render_jit = jax.jit(render_scene, static_argnames=(
        "active_sh_degree", "options", "train_mode", "include_background",
        "include_objects"))

    def render_fn(cam):
        res, _ = render_until_fit(
            lambda o: render_jit(models, meta, arrays, cam,
                                 active_sh_degree=meta.bkgd_sh_degree,
                                 options=o), options)
        return res.rgb

    detector = BoxProjectionDetector(arrays=arrays,
                                     actor_pose=models.actor_pose)
    tracklets = {}
    with open(os.path.join(cfg.source_path, "track", "track_info.txt")) as f:
        for row in f.read().splitlines()[1:]:
            t = row.split()
            if int(t[1]) == cipv_id:
                tracklets[int(t[0])] = (float(t[7]), float(t[8]),
                                        float(t[9]))
    v2c = np.linalg.inv(np.asarray(cam0.extrinsic))
    result = run_closed_loop(tape, render_fn, detector, cam0, tracklets,
                             start_frame=0, brake_distance=15.0,
                             collision_threshold=5.5,
                             simulation_time=simulation_time,
                             ranger_extrinsic=v2c, cam_height=1.1)
    return dict(verdict=result.verdict, ticks=result.ticks,
                frames=result.frames_rendered,
                min_gt_distance=round(result.min_gt_distance, 2))


def test_simulate_cli_matches_jax_app(scene, tmp_path, capsys):
    """`apps.simulate.main --config ... --cipv <id>` on a checkpoint the JAX
    package wrote: the verdict line's verdict, ticks and frames equal the
    JAX app's run of the same configuration (`_jax_config_loop`),
    min_gt_distance within 1e-2 m."""
    from gaussianrpg_tpu.sim.tape import build_tape_from_cameras, save_tape

    src = tmp_path / "scene"
    shutil.copytree(scene, src)
    out = tmp_path / "out"
    tape = str(tmp_path / "tape.json")
    opts = _opts(src, out, ["sim.traj_file_path", tape,
                            "render.capacity", "65536"])
    jcfg = j_load_config(CONFIG, opts)
    jscene = JScene(str(src), selected_frames=[0, 5], resolution=2)
    jm, _, _, _ = j_build(jscene, jcfg)
    rng = np.random.default_rng(2)
    bk = jm.background
    jm = jm.replace(background=bk.replace(
        features_dc=bk.features_dc + rng.standard_normal(
            bk.features_dc.shape).astype(np.float32) * 0.1))
    jio.save_checkpoint(str(out / "trained_model" / "iteration_9.npz"),
                        jtr.init_train_state(jm), 9, 0)
    save_tape(tape, build_tape_from_cameras(
        [c for c, _ in jscene.build_cameras("train")], upsample_rate=5))
    jline = _jax_config_loop(jcfg, MOVING_TRACKS[0], 0.8)
    tsim.main(["--config", CONFIG, "--cipv", str(MOVING_TRACKS[0]),
               "--simulation-time", "0.8", "--device", "cpu"] + opts)
    tline = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jline["frames"] > 3
    assert (tline["verdict"], tline["ticks"], tline["frames"]) == (
        jline["verdict"], jline["ticks"], jline["frames"])
    assert tline["min_gt_distance"] == pytest.approx(
        jline["min_gt_distance"], abs=1e-2)


def test_synthetic_train_cli_writes_checkpoints_and_resumes(tmp_path,
                                                           capsys):
    """`apps.train.main --synthetic` writes the JAX app's files
    (`train.py:495-504`): `iteration_2.npz`, which the JAX package's
    `load_checkpoint` reads into the JAX trainer's synthetic scene
    (`make_scene` at 5000 / 16384, 2 actors of 1024, SH 3, Fourier 1), and
    the composite PLY with one element per sub-model; a second call to 3
    iterations resumes from it (`train.py:292-305`)."""
    from gaussianrpg_tpu.utils.synthetic import make_scene

    from gaussianrpg_tpu_torch.data.ply import read_ply

    out = tmp_path / "syn"
    state, rec = tapp.main(["--device", "cpu", "--synthetic",
                            "--iterations", "2", "model_path", str(out)])
    assert len(rec["loss"]) == 2
    ckpt = out / "trained_model" / "iteration_2.npz"
    ply = out / "point_cloud" / "iteration_2" / "point_cloud.ply"
    assert ckpt.exists() and ply.exists()
    assert sorted(read_ply(str(ply))) == ["vertex_background",
                                          "vertex_obj_000", "vertex_obj_001"]
    jm, _, _ = make_scene(n_background=5000, bkgd_capacity=16384,
                          n_actors=2, actor_capacity=1024, n_frames=10,
                          sh_degree=3, fourier_dim=1)
    jstate, step, sh = jio.load_checkpoint(str(ckpt),
                                           jtr.init_train_state(jm))
    assert (step, sh) == (2, 0) and int(jstate.step) == 2
    np.testing.assert_array_equal(
        np.asarray(jstate.models.background.features_dc),
        state.models.background.features_dc.numpy())
    np.testing.assert_array_equal(np.asarray(jstate.adam.nu["actors"].xyz),
                                  state.adam.nu["actors"].xyz.numpy())

    capsys.readouterr()
    state2, rec2 = tapp.main(["--device", "cpu", "--synthetic",
                              "--iterations", "3", "model_path", str(out)])
    assert "resumed from iteration 2" in capsys.readouterr().out
    assert len(rec2["loss"]) == 1 and state2.step == 3
    assert (out / "trained_model" / "iteration_3.npz").exists()


def test_train_cli_refuses_mesh(monkeypatch):
    """`--mesh 2` outside a 2-rank launch of `torch.distributed.run`
    raises instead of training on one device (the mesh itself:
    tests/test_torch_mesh_train.py)."""
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
              "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torch.distributed.run"):
        tapp.main(["--device", "cpu", "--mesh", "2", "--synthetic",
                   "--dist-backend", "gloo"])
    assert not torch.distributed.is_initialized()
