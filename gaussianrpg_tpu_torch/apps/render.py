"""Offline rendering / evaluation CLI; counterpart of
`gaussianrpg_tpu/apps/render.py` (reference `render.py:15-96`).

    python -m gaussianrpg_tpu_torch.apps.render [--device cuda] \
        --config configs/waymo_149_1cam.yaml [--mode evaluate] \
        source_path <scene dir> model_path <out> [KEY VALUE ...]

Modes:
  evaluate   — render the train/test views from the latest checkpoint,
               save `{frame:06d}_{cam}_rgb.png` / `_gt.png` pairs under
               `<model_path>/evaluate_{split}` and print ms/view and FPS
  trajectory — render the train views to frames, and to `video.mp4`
               where imageio (with a codec) is installed

The pair capacity is probed over every camera (slack 1.15) and grown on
overflow; a view that overflowed is re-timed on a clean run. A view's
time runs from before the render to the image's copy to the host; the
PNG encode is outside it. Without `source_path` the synthetic scene of
`apps.train --synthetic` is rendered from its checkpoint (see
`load_scene_for_eval`).
"""
from __future__ import annotations

import os
import time

import numpy as np

from ..utils.device import resolve_device


def load_scene_for_eval(cfg, device=None, load_images=True):
    """(models, meta, arrays, train [(camera, image or None)], test [...],
    active SH degree): the latest checkpoint of `cfg.trained_model_dir`
    restored into a freshly built scene on `device` (CUDA unless given);
    the scene as built when there is no checkpoint. `load_images=False`
    gives the same cameras without reading the images (the apps that
    need only the poses).

    The Waymo scene is built as the JAX app builds it (`render.py:28-40`:
    selected frames, cameras and resolution; every frame a train view).
    The synthetic scene is the one `apps.train --synthetic` trains
    (`train.synthetic_scene` at the config's SH degree and Fourier size),
    with the JAX app's cameras (`make_cameras()`, 128x96, no ground
    truth). The JAX app builds `make_scene()` at its defaults there and
    restores the trainer's checkpoint into it unchecked (ROADMAP §3)."""
    from ..models.scene_io import load_checkpoint, search_max_iteration
    from ..train.trainer import init_train_state

    dev = resolve_device(device)
    if cfg.source_path and os.path.isdir(cfg.source_path):
        from ..data.waymo import WaymoScene
        from ..models.scene_builder import build_scene_from_waymo
        scene = WaymoScene(
            cfg.source_path,
            selected_frames=cfg.data.selected_frames or None,
            cameras=tuple(cfg.data.cameras),
            resolution=cfg.resolution, load_images=load_images)
        models, meta, arrays, _ = build_scene_from_waymo(scene, cfg,
                                                         device=dev)
        cams = scene.build_cameras("train", device=dev)
        test_cams = scene.build_cameras("test", device=dev)
    else:
        from ..utils.synthetic import make_cameras
        from .train import FOURIER_DIM, synthetic_scene
        gcfg = cfg.model.gaussian
        models, meta, arrays = synthetic_scene(
            dev, sh_degree=gcfg.sh_degree,
            fourier_dim=gcfg.get("fourier_dim", FOURIER_DIM))
        cams = [(c, None) for c in make_cameras(device=dev)]
        test_cams = []

    state = init_train_state(models)
    it = search_max_iteration(cfg.trained_model_dir)
    sh = meta.bkgd_sh_degree
    if it is not None:
        path = os.path.join(cfg.trained_model_dir, f"iteration_{it}.npz")
        state, _, sh = load_checkpoint(path, state)
        print(f"loaded checkpoint iteration_{it}")
    return state.models, meta, arrays, cams, test_cams, sh


def main(argv=None):
    from ..config.config import load_config, make_argparser
    from ..render.renderer import (options_from_cfg, probe_scene_capacity,
                                   render_scene, render_until_fit)
    from ..utils.visualize import save_image, write_video

    parser = make_argparser("gaussianrpg_tpu_torch rendering")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = load_config(args.config, args.opts, mode=args.mode or "evaluate")

    models, meta, arrays, cams, test_cams, sh = load_scene_for_eval(cfg, dev)
    options = options_from_cfg(cfg.render)
    if cfg.render.get("autosize", True):
        sized = probe_scene_capacity(
            models, meta, arrays,
            [c for c, _ in cams] + [c for c, _ in (test_cams or [])],
            active_sh_degree=sh, options=options, slack=1.15)
        print(f"pair capacity right-sized to {sized.capacity} "
              f"(cfg fallback {options.capacity})", flush=True)
        options = sized

    def render(cam, o):
        return render_scene(models, meta, arrays, cam, active_sh_degree=sh,
                            options=o, device=dev)

    splits = [("train", cams)] + ([("test", test_cams)] if test_cams else [])
    for split, cam_list in splits:
        if cfg.mode == "trajectory" and split != "train":
            continue
        out_dir = os.path.join(cfg.model_path, f"{cfg.mode}_{split}")
        os.makedirs(out_dir, exist_ok=True)
        times = []
        frames = []
        for cam, gt in cam_list:
            t0 = time.perf_counter()
            res = render(cam, options)
            if bool(res.overflow):
                res, options = render_until_fit(lambda o: render(cam, o),
                                                options)
                # re-time a clean run, so that ms/view leaves out the
                # growth
                t0 = time.perf_counter()
                res = render(cam, options)
            rgb = res.rgb.cpu().numpy()
            times.append(time.perf_counter() - t0)
            name = f"{int(cam.frame):06d}_{cam.cam_id}"
            save_image(os.path.join(out_dir, f"{name}_rgb.png"), rgb)
            if gt is not None:
                save_image(os.path.join(out_dir, f"{name}_gt.png"), gt)
            frames.append(rgb)
        if times:
            avg = float(np.mean(times[1:])) if len(times) > 1 else times[0]
            print(f"{split}: {len(times)} views, {avg * 1000:.1f} ms/view "
                  f"({1.0 / avg:.1f} FPS)", flush=True)
        if cfg.render.save_video and len(frames) > 1:
            try:
                write_video(os.path.join(out_dir, "video.mp4"), frames,
                            fps=cfg.render.fps)
            except Exception as e:  # imageio or its codecs may be absent
                print(f"video export skipped: {e}")


if __name__ == "__main__":
    main()
