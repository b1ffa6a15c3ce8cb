"""Trajectory tape export CLI; counterpart of
`gaussianrpg_tpu/apps/render_lite.py` (reference `render_lite.py:89-258`).

    python -m gaussianrpg_tpu_torch.apps.render_lite [--device cuda] \
        --config <yaml> [--out <tape.json>] source_path <scene dir> \
        model_path <out> [KEY VALUE ...]

writes `cams_tape.json` (the train cameras' poses, the 10 Hz images
upsampled to the 50 Hz dynamics by `round(dynamic_freq / image_freq)`)
for the closed-loop simulator, through the port's `sim/tape.py`.
"""
from __future__ import annotations

import os

from ..utils.device import resolve_device


def main(argv=None):
    from ..config.config import load_config, make_argparser
    from ..sim.tape import build_tape_from_cameras, save_tape
    from .render import load_scene_for_eval

    parser = make_argparser("gaussianrpg_tpu_torch render_lite")
    parser.add_argument("--out", type=str, default=None)
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = load_config(args.config, args.opts, mode="trajectory")

    _, _, _, cams, _, _ = load_scene_for_eval(
        cfg, dev, load_images=False)
    frames = build_tape_from_cameras(
        [c for c, _ in cams],
        upsample_rate=int(round(cfg.sim.dynamic_freq / cfg.sim.image_freq)))
    out = args.out or os.path.join(cfg.model_path, "cams_tape.json")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    save_tape(out, frames, image_freq=cfg.sim.image_freq,
              dynamic_freq=cfg.sim.dynamic_freq)
    print(f"wrote {out} ({len(frames)} poses)")


if __name__ == "__main__":
    main()
