"""The port's Street Gaussians composite frame against the plain reference
of the benchmark's street cell (`port_bench/reference/street.py`) on the
CPU, with the cell's own inputs (`port_bench/street_inputs.py`) at a
small size: `compose` + `render_scene` (SH 3, Fourier 5, three tracked
vehicles of which one is not yet tracked at the early frames, the
background's inactive slots, a 16^2 sky cube map, 96 x 64) on each
tiling and seed, held to the cell's image limits; the box-projection
detector against the reference's projection, to the cell's box limit;
and `apps.simulate.loop_setup` on a test-size Waymo scene, returning
the loop that `config_setup` returns."""
import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from port_bench import inputs, street_inputs as si
from port_bench.reference import street

from gaussianrpg_tpu_torch.render.renderer import (RenderOptions,
                                                   render_scene)
from gaussianrpg_tpu_torch.sim.detector import BoxProjectionDetector

from .torch_parity import one_cpu_thread, write_test_scene  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "port_bench"
WL = json.loads((BENCH / "workloads" / "loop_street600k_aeb.json")
                .read_text())
CFG = json.loads((BENCH / "configs" / "street600k_w149.json").read_text())
LIMITS = WL["limits"]
CPU = torch.device("cpu")
# frame 3: the parked car is not tracked yet (its track starts at frame
# 60 of the scene, the episode's 50th); frame 8: the lead fills the view;
# frame 55: the parked car is in view
FRAMES = (3, 8, 55)


def small_cfg() -> dict:
    cfg = copy.deepcopy(CFG)
    sc = cfg["scene"]
    sc.update(gaussians=3000, width=96, height=64)
    sc["ground"]["count"], sc["facades"]["count"] = 1500, 1000
    cfg["config"]["model"]["actor_capacity"] = 256
    cfg["sky_cubemap"] = dict(cfg["sky_cubemap"], resolution=16)
    lead, oncoming = cfg["vehicles"][:2]
    parked = dict(cfg["vehicles"][4], x_m=60.0, y_m=-3.5, frames=[60, 100])
    cfg["vehicles"] = [lead, oncoming, parked]
    return cfg


def built(seed, cfg=None):
    cfg = cfg or small_cfg()
    gen, _ = inputs.generators(seed, CPU)
    s = si.draw(cfg, WL, gen, CPU)
    return cfg, s, si.scene_models(s, cfg, CPU)


def view(cfg, offset, k) -> street.View:
    """The reference's view of a planned frame, as the tape holds it."""
    c2w, ego, t = si.camera_poses(cfg, WL, offset)[k]
    return street.View(
        R=c2w[:3, :3],
        T=np.float32(np.linalg.inv(c2w)[:3, 3]).astype(np.float64),
        ego=ego.astype(np.float32).astype(np.float64),
        t=float(np.float32(t)), frame=si.frames(cfg)[0] + k)


def meta(cfg, tile) -> dict:
    g = cfg["config"]["model"]["gaussian"]
    return dict(width=cfg["scene"]["width"], height=cfg["scene"]["height"],
                K=si.intrinsics(cfg["scene"]), tile_x=tile[0],
                tile_y=tile[1], sh_degree=g["sh_degree"],
                fourier_scale=g["fourier_scale"])


@pytest.mark.parametrize("tile", [(16, 16), (64, 32)])
@pytest.mark.parametrize("seed", [3, 2**31 + 11])
def test_composite_frame_matches_reference(tile, seed):
    cfg, s, (models, meta_, arrays) = built(seed)
    assert meta_.bkgd_sh_degree == 3 and meta_.fourier_dim == 5
    assert meta_.include_sky and models.sky.cube_map.shape[1] == 16
    assert int(s["bkgd"]["n_active"]) < s["bkgd"]["xyz"].shape[0]
    m = meta(cfg, tile)
    cams = si.episode_cameras(cfg, WL, 0.5, CPU)
    opts = RenderOptions(capacity=1 << 16, tile_x=tile[0], tile_y=tile[1])
    for k in FRAMES:
        res = render_scene(models, meta_, arrays, cams[k],
                           active_sh_degree=meta_.bkgd_sh_degree,
                           options=opts, device=CPU)
        assert not bool(res.overflow)
        ref = street.frame(s, view(cfg, 0.5, k), m)
        d = (res.rgb - ref).abs()
        assert float(d.max()) <= LIMITS["image_max_gap"], k
        assert float(d.mean()) <= LIMITS["image_mean_gap"], k


def test_reference_sees_what_the_scene_holds():
    """The reference's frame moves with each part of the composite: the
    actors' Fourier time, SH bands 2-3, the sky, and the vehicle that is
    not tracked yet."""
    cfg, s, _ = built(5)
    m = meta(cfg, (16, 16))
    v = view(cfg, 0.0, 8)
    ref = street.frame(s, v, m)
    for form in (street.Form(freeze_fourier=True), street.Form(sh_degree=1),
                 street.Form(sky=False)):
        assert float((street.frame(s, v, m, form) - ref).abs().mean()) \
            > 100 * LIMITS["image_mean_gap"], form
    alive = [street.actor_poses(s, view(cfg, 0.0, k).t)[2].tolist()
             for k in (3, 55)]
    assert alive == [[True, True, False], [True, True, True]]
    assert street.boxes(s, view(cfg, 0.0, 55), m)


@pytest.mark.parametrize("offset", [-0.5, 0.0, 0.5])
@pytest.mark.parametrize("seed", [7, 3_000_000_007])
def test_box_detector_matches_reference(offset, seed):
    cfg, s, (models, _, arrays) = built(seed)
    det = BoxProjectionDetector(arrays=arrays, actor_pose=models.actor_pose)
    cams = si.episode_cameras(cfg, WL, offset, CPU)
    m = meta(cfg, (16, 16))
    scale = np.array([m["width"], m["height"]] * 2, np.float64)
    seen = 0
    for k in range(0, 61, 4):
        got = det.detect(None, cams[k])
        want = street.boxes(s, view(cfg, offset, k), m)
        assert len(got) == len(want), k
        if want:
            gap = np.abs(np.asarray(got) - np.asarray(want)) * scale
            assert float(gap.max()) <= LIMITS["box_gap_px"], k
        seen += len(want)
    assert seen >= 15


def test_loop_setup_returns_config_setups_loop(tmp_path):
    """On a test-size Waymo scene with a checkpoint and a tape:
    `loop_setup` over the scene and cameras `config_setup` reads returns
    the same tape, template, extrinsic and detector, renders the same
    images, and drives `run_closed_loop` to the same record."""
    from gaussianrpg_tpu_torch.apps import simulate as tsim
    from gaussianrpg_tpu_torch.config.config import load_config
    from gaussianrpg_tpu_torch.data.waymo import WaymoScene
    from gaussianrpg_tpu_torch.models.scene_builder import \
        build_scene_from_waymo
    from gaussianrpg_tpu_torch.models.scene_io import (load_latest_checkpoint,
                                                       save_checkpoint)
    from gaussianrpg_tpu_torch.sim.loop import run_closed_loop
    from gaussianrpg_tpu_torch.sim.tape import (build_tape_from_cameras,
                                                load_tape, save_tape)
    from gaussianrpg_tpu_torch.train.trainer import init_train_state

    src, tape = tmp_path / "scene", str(tmp_path / "tape.json")
    write_test_scene(src)
    cfg = load_config("configs/waymo_149_1cam.yaml", [
        "source_path", str(src), "data.selected_frames", "[0, 5]",
        "model.actor_capacity", "1024", "model_path", str(tmp_path / "out"),
        "render.capacity", "65536", "sim.traj_file_path", tape])
    scene = WaymoScene(cfg.source_path, selected_frames=[0, 5],
                       cameras=tuple(cfg.data.cameras))
    models, meta_, arrays, _ = build_scene_from_waymo(scene, cfg,
                                                      device=CPU)
    bk = models.background
    g = torch.Generator().manual_seed(1)
    models = models.replace(background=bk.replace(
        features_dc=bk.features_dc + 0.1 * torch.randn(
            bk.features_dc.shape, generator=g)))
    save_checkpoint(str(tmp_path / "out" / "trained_model"
                        / "iteration_9.npz"), init_train_state(models), 9, 0)
    cams = [c for c, _ in scene.build_cameras("train", device=CPU)]
    save_tape(tape, build_tape_from_cameras(cams, upsample_rate=5))

    tape_c, render_c, det_c, cam_c, gt, v2c_c, perceive_c = \
        tsim.config_setup(cfg, device=CPU)
    loop = tsim.loop_setup(
        load_latest_checkpoint(cfg.trained_model_dir, models), meta_,
        arrays, cams, load_tape(tape), cfg, device=CPU)
    assert loop["tape"] == tape_c
    assert loop["perceive_fn"] is None and perceive_c is None
    assert type(loop["detector"]) is type(det_c) is BoxProjectionDetector
    assert np.array_equal(loop["ranger_extrinsic"], v2c_c)
    for name in ("viewmatrix", "K", "extrinsic", "frame", "timestamp"):
        assert torch.equal(getattr(loop["camera_template"], name),
                           getattr(cam_c, name)), name
    for cam in cams[::2]:
        img = loop["render_fn"](cam)
        assert np.array_equal(img, render_c(cam))
        assert [b.tolist() for b in loop["detector"].detect(img, cam)] == \
            [b.tolist() for b in det_c.detect(img, cam)]
    kw = dict(simulation_time=0.5, brake_distance=30.0, cam_height=2.115)
    a = run_closed_loop(gt_tracklets=gt, **loop, **kw)
    b = run_closed_loop(tape_c, render_c, det_c, cam_c, gt,
                        ranger_extrinsic=v2c_c, perceive_fn=perceive_c, **kw)
    assert (a.verdict, a.ticks, a.frames_rendered) == \
        (b.verdict, b.ticks, b.frames_rendered)
    assert [(e["tick"], e["n_det"], e["brake"]) for e in a.log] == \
        [(e["tick"], e["n_det"], e["brake"]) for e in b.log]
