"""Closed-loop AEB simulation CLI, headless and in-process (synthetic
scene path).

Counterpart of `gaussianrpg_tpu/apps/simulate.py` (`--synthetic`): builds a
street scene with a stopped lead vehicle ahead of the ego, exports a tape,
runs render -> detect -> AEB -> dynamics, and prints the same JSON verdict
line as the JAX app:

    python -m gaussianrpg_tpu_torch.apps.simulate --synthetic \
        [--brake-distance 15] [--collision-threshold 5.5] [--device cuda]
"""
from __future__ import annotations

import json


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


def main(argv=None):
    import argparse

    from ..sim.loop import run_closed_loop

    p = argparse.ArgumentParser()
    p.add_argument("--synthetic", action="store_true",
                   help="synthetic scene (the only scene source so far)")
    p.add_argument("--start-frame", type=int, default=0)
    p.add_argument("--brake-distance", type=float, default=15.0)
    p.add_argument("--collision-threshold", type=float, default=5.5)
    p.add_argument("--simulation-time", type=float, default=3.5)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=320)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    tape, render_fn, detector, cam0, gt, v2c = _synthetic_setup(
        args.width, args.height, device=args.device)
    result = run_closed_loop(
        tape, render_fn, detector, cam0, gt,
        start_frame=args.start_frame,
        brake_distance=args.brake_distance,
        collision_threshold=args.collision_threshold,
        simulation_time=args.simulation_time,
        ranger_extrinsic=v2c, cam_height=1.1)
    print(json.dumps(dict(
        verdict=result.verdict, ticks=result.ticks,
        frames=result.frames_rendered,
        min_gt_distance=round(result.min_gt_distance, 2),
        render_fps=round(result.fps, 2),
        wall_time=round(result.wall_time, 2))))
    return result


if __name__ == "__main__":
    main()
