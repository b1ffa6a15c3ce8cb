"""Live render window (manual smoke tool); counterpart of
`gaussianrpg_tpu/apps/view.py` (the reference's
`test_render_window_cv2.py`).

    python -m gaussianrpg_tpu_torch.apps.view [--device cuda] \
        [--synthetic] [--offscreen] [--out <dir>] [--config <yaml>] \
        [KEY VALUE ...]

steps through the scene's cameras, renders each frame and shows it in a
cv2 window with its time. `--offscreen` writes `{idx:06d}.png` frames to
`--out` instead, as does a run without cv2 or a display. `--synthetic`
(or an empty `source_path`) renders the synthetic street at 20000
background Gaussians (capacity 32768) and 2 actors, 10 frames at 512x320;
otherwise the configured Waymo scene from its latest checkpoint. The JAX
app's `--extra_frames` is not ported: it parses the flag and never reads
it.
"""
from __future__ import annotations

import os
import tempfile
import time

from ..utils.device import resolve_device


def view_setup(cfg, synthetic: bool, dev):
    """The viewer's scene, cameras and starting render options on `dev`:
    the synthetic street when `synthetic` (or `cfg` has no source_path),
    else the configured Waymo scene from its latest checkpoint, every
    camera. Returns (models, meta, arrays, cameras, options)."""
    from ..render.renderer import options_from_cfg

    if synthetic or not cfg.source_path:
        from ..utils.synthetic import make_cameras, make_scene
        models, meta, arrays = make_scene(
            n_background=20000, bkgd_capacity=32768, n_actors=2,
            actor_capacity=2048, n_frames=10, device=dev)
        cameras = make_cameras(n_frames=10, width=512, height=320,
                               device=dev)
    else:
        from ..data.waymo import WaymoScene
        from ..models.scene_builder import build_scene_from_waymo
        from ..models.scene_io import load_latest_checkpoint
        scene = WaymoScene(cfg.source_path,
                           selected_frames=cfg.data.selected_frames or None,
                           cameras=tuple(cfg.data.cameras))
        models, meta, arrays, _ = build_scene_from_waymo(scene, cfg,
                                                         device=dev)
        models = load_latest_checkpoint(cfg.trained_model_dir, models)
        cameras = [c for c, _ in scene.build_cameras("all", device=dev)]
    return models, meta, arrays, cameras, options_from_cfg(cfg.render)


def render_frame(models, meta, arrays, cam, opts, dev):
    """One viewer frame of `cam`, growing `opts` on overflow: (result,
    the options it fit in)."""
    from ..render.renderer import render_scene, render_until_fit

    return render_until_fit(
        lambda o: render_scene(models, meta, arrays, cam,
                               active_sh_degree=meta.bkgd_sh_degree,
                               options=o, device=dev), opts)


def main(argv=None):
    import numpy as np

    from ..config.config import load_config, make_argparser
    from ..data.image_io import write_png

    parser = make_argparser("gaussianrpg_tpu_torch live viewer")
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--offscreen", action="store_true")
    parser.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                      "gaussianrpg_view"))
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = load_config(args.config, args.opts, mode="trajectory")

    models, meta, arrays, cameras, opts = view_setup(cfg, args.synthetic,
                                                     dev)

    window = None
    if not args.offscreen:
        try:
            import cv2
            window = "gaussianrpg_tpu"
            cv2.namedWindow(window, cv2.WINDOW_GUI_NORMAL)
        except Exception as e:  # no cv2, or headless / no display
            print(f"cv2 window unavailable ({e}); falling back to "
                  f"--offscreen {args.out}")
            window = None
    if window is None:
        os.makedirs(args.out, exist_ok=True)

    times = []
    for idx, cam in enumerate(cameras):
        t0 = time.perf_counter()
        res, opts = render_frame(models, meta, arrays, cam, opts, dev)
        rgb = np.clip(res.rgb.cpu().numpy(), 0, 1)
        img = (rgb.transpose(1, 2, 0) * 255).astype(np.uint8)
        dt = time.perf_counter() - t0
        times.append(dt * 1000)
        if window is not None:
            import cv2
            cv2.imshow(window, cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
            if cv2.waitKey(1) & 0xFF == 27:   # ESC quits
                break
        else:
            write_png(os.path.join(args.out, f"{idx:06d}.png"), img)
        print(f"frame {idx}: {dt * 1000:.1f} ms", flush=True)

    if window is not None:
        import cv2
        cv2.destroyAllWindows()
    if len(times) > 1:
        print(f"average render time: "
              f"{sum(times[1:]) / len(times[1:]):.1f} ms")
    return times


if __name__ == "__main__":
    main()
