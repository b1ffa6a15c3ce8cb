"""Closed-loop AEB simulation CLI, headless and in-process.

Counterpart of `gaussianrpg_tpu/apps/simulate.py`. On a trained scene:

    python -m gaussianrpg_tpu_torch.apps.simulate [--device cuda] \
        --config configs/waymo_149_1cam.yaml --cipv <track id> \
        source_path <scene dir> sim.traj_file_path <tape.json> [KEY VALUE ...]

builds the scene, loads the latest checkpoint of `trained_model/`, replays
the tape through render -> perception -> AEB -> dynamics and ranges the
CIPV's tracklets (`config_setup`); perception is the box-projection
detector, or the fused render -> letterbox -> YOLOv5 -> top-K step when
`sim.yolov5_weights_path` names a YOLOv5 checkpoint. Synthetic demo (a
street scene with a stopped lead vehicle ahead of the ego):

    python -m gaussianrpg_tpu_torch.apps.simulate --synthetic \
        [--brake-distance 15] [--collision-threshold 5.5] [--device cuda]

Both print the same JSON verdict line as the JAX app. The flags go before
the `KEY VALUE` overrides.
"""
from __future__ import annotations

import json
import os

import numpy as np


def _synthetic_setup(width=512, height=320, ego_speed=8.0,
                     lead_world_z=30.0, n_frames=40, n_background=20000,
                     bkgd_capacity=32768, device=None):
    """(tape, render_fn, detector, camera_template, gt_tracklets, v2c) for
    the synthetic scenario, perceived by the box-projection detector."""
    from ..sim.detector import BoxProjectionDetector
    from ..utils.device import resolve_device
    from ..utils.synthetic import fitting_renderer, lead_vehicle_scenario

    dev = resolve_device(device)
    models, meta, arrays, cams, tape, gt_tracklets, v2c = (
        lead_vehicle_scenario(width, height, ego_speed, lead_world_z,
                              n_frames, n_background, bkgd_capacity, 2048,
                              dev))
    render = fitting_renderer(models, meta, arrays, cams, 1, dev)

    def render_fn(cam):
        return render(cam).rgb.cpu().numpy()

    detector = BoxProjectionDetector(arrays=arrays,
                                     actor_pose=models.actor_pose)
    return tape, render_fn, detector, cams[0], gt_tracklets, v2c


def config_setup(cfg, cipv_id: int = -1, start_frame: int = 0,
                 device=None):
    """Trained-scene setup (reference `simulator.py:77-161`): the scene with
    its latest checkpoint, the tape of `cfg.sim.traj_file_path` and the
    training cameras read from disk, the closed loop built on them
    (`loop_setup`), and the CIPV's tracklets. Returns the
    `run_closed_loop` arguments (tape, render_fn, detector,
    camera_template, gt_tracklets, vehicle->camera extrinsic,
    perceive_fn); perceive_fn is None unless the step is fused. Raises
    when the YOLOv5 checkpoint cannot be read as a state dict."""
    from ..data.waymo import WaymoScene
    from ..models.scene_builder import build_scene_from_waymo
    from ..models.scene_io import load_latest_checkpoint
    from ..sim.tape import load_tape
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    scene = WaymoScene(
        cfg.source_path,
        selected_frames=cfg.data.selected_frames or None,
        cameras=tuple(cfg.data.cameras),
        box_scale=cfg.data.get("box_scale", 1.0))
    models, meta, arrays, _ = build_scene_from_waymo(scene, cfg, device=dev)
    models = load_latest_checkpoint(cfg.trained_model_dir, models)
    tape = load_tape(cfg.sim.traj_file_path)
    cams = scene.build_cameras("train", device=dev)
    # the training cameras probe the capacity: the tape replays their poses
    loop = loop_setup(models, meta, arrays, [c for c, _ in cams], tape, cfg,
                      device=dev)

    if cipv_id >= 0:
        tracklets = {}
        with open(os.path.join(cfg.source_path, "track",
                               "track_info.txt")) as f:
            rows = f.read().splitlines()[1:]
        for row in rows:
            t = row.split()
            if int(t[1]) == cipv_id:
                tracklets[int(t[0])] = (float(t[7]), float(t[8]),
                                        float(t[9]))
    else:
        tracklets = {0: (1e9, 0.0, 0.0)}  # no CIPV: distance never trips
    return (tape, loop["render_fn"], loop["detector"],
            loop["camera_template"], tracklets, loop["ranger_extrinsic"],
            loop["perceive_fn"])


def loop_setup(models, meta, arrays, cameras, tape, cfg,
               device=None) -> dict:
    """The closed loop on a built scene (reference `simulator.py:101-161`):
    the pair capacity probed over `cameras` at slack 1.3 (with
    `cfg.render.autosize`, the default), a render function that grows the
    capacity on overflow (`render_until_fit`) and copies the image to the
    host (span `scene.fetch`), the box-projection detector or, when
    `cfg.sim.yolov5_weights_path` exists, YOLOv5 (fused into one step with
    the render unless `sim.separate_perception` or not
    `sim.fused_perception`: `sim.pipeline.FusedPerception`, which renders
    a frame again at a grown capacity when its pairs overflowed), and the
    ranging extrinsic, the inverse of the first camera's camera->vehicle
    extrinsic. Returns `run_closed_loop`'s keyword arguments: tape,
    render_fn, detector, camera_template (the first camera),
    ranger_extrinsic, perceive_fn (None unless the step is fused)."""
    from ..render.renderer import (grown, options_from_cfg,
                                   probe_scene_capacity, render_scene,
                                   render_until_fit)
    from ..sim.detector import (VEHICLE_CLASSES, BoxProjectionDetector,
                                YoloDetector)
    from ..utils.device import resolve_device
    from ..utils.spans import span

    dev = resolve_device(device)
    cam0 = cameras[0]
    options = options_from_cfg(cfg.render)
    if cfg.render.get("autosize", True):
        # extra slack for tape poses pushed past the probed cameras' range
        sized = probe_scene_capacity(
            models, meta, arrays, cameras,
            active_sh_degree=meta.bkgd_sh_degree, options=options,
            slack=1.3)
        print(f"pair capacity right-sized to {sized.capacity} "
              f"(cfg fallback {options.capacity})", flush=True)
        options = sized

    def render_fn(cam):
        nonlocal options
        # grow on pair-capacity overflow rather than feeding perception
        # background-masked tiles (the trainer's policy)
        res, options = render_until_fit(
            lambda o: render_scene(models, meta, arrays, cam,
                                   active_sh_degree=meta.bkgd_sh_degree,
                                   options=o, device=dev), options)
        with span("scene.fetch"):
            return res.rgb.cpu().numpy()

    weights = cfg.sim.get("yolov5_weights_path", "")
    perceive_fn = None
    if weights and os.path.exists(weights):
        if (not cfg.sim.get("separate_perception", False)
                and cfg.sim.get("fused_perception", True)):
            # fused inline perception (sim/pipeline.py): render, letterbox,
            # YOLOv5 and the top-K prefilter on the card; only [K, 6]
            # candidates cross to the host
            from ..sim.pipeline import FusedPerception, make_fused_step
            from ..sim.yolo import load_torch_checkpoint

            spec, params = load_torch_checkpoint(weights, device=dev)
            overflow = []

            def render_rgb(camera):
                res = render_scene(
                    models, meta, arrays, camera,
                    active_sh_degree=meta.bkgd_sh_degree, options=options,
                    device=dev)
                overflow[:] = [res.overflow]
                return res.rgb

            def grow():
                nonlocal options
                options = grown(options)

            hw = (cam0.height, cam0.width)
            fused, gain, pad = make_fused_step(
                render_rgb, spec, params, hw, classes=VEHICLE_CLASSES)
            # the render's policy too: a frame whose pairs overflowed is
            # rendered again at a grown capacity before perception reads it
            perceive_fn = FusedPerception(
                fused, gain, pad, hw, lambda: bool(overflow[0]), grow)
            detector = None
        else:
            detector = YoloDetector(weights_path=weights, device=dev)
            detector._ensure()     # read the checkpoint now: raise here
    else:
        detector = BoxProjectionDetector(arrays=arrays,
                                         actor_pose=models.actor_pose)
    return dict(tape=tape, render_fn=render_fn, detector=detector,
                camera_template=cam0,
                ranger_extrinsic=np.linalg.inv(cam0.extrinsic.cpu().numpy()),
                perceive_fn=perceive_fn)


def main(argv=None):
    import argparse

    from ..sim.loop import run_closed_loop

    p = argparse.ArgumentParser()
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--cipv", type=int, default=-1)
    p.add_argument("--start-frame", type=int, default=0)
    p.add_argument("--brake-distance", type=float, default=15.0)
    p.add_argument("--collision-threshold", type=float, default=5.5)
    p.add_argument("--simulation-time", type=float, default=3.5)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=320)
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("opts", nargs="*", default=[])
    args = p.parse_args(argv)

    perceive_fn = None
    if args.config and not args.synthetic:
        from ..config.config import load_config
        cfg = load_config(args.config, args.opts)
        tape, render_fn, detector, cam0, gt, v2c, perceive_fn = \
            config_setup(cfg, cipv_id=args.cipv,
                         start_frame=args.start_frame, device=args.device)
    else:
        tape, render_fn, detector, cam0, gt, v2c = _synthetic_setup(
            args.width, args.height, device=args.device)
    result = run_closed_loop(
        tape, render_fn, detector, cam0, gt,
        start_frame=args.start_frame,
        brake_distance=args.brake_distance,
        collision_threshold=args.collision_threshold,
        simulation_time=args.simulation_time,
        ranger_extrinsic=v2c, cam_height=1.1,
        perceive_fn=perceive_fn)
    print(json.dumps(dict(
        verdict=result.verdict, ticks=result.ticks,
        frames=result.frames_rendered,
        min_gt_distance=round(result.min_gt_distance, 2),
        render_fps=round(result.fps, 2),
        wall_time=round(result.wall_time, 2))))
    return result


if __name__ == "__main__":
    main()
