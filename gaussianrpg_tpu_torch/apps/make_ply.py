"""Flatten the composite model at a chosen frame into a standard 3DGS PLY
for external viewers; counterpart of `gaussianrpg_tpu/apps/make_ply.py`
(reference `make_ply.py:12-79`).

    python -m gaussianrpg_tpu_torch.apps.make_ply [--device cuda] \
        --config <yaml> [--frame 0] [--out <ply>] source_path <scene dir> \
        model_path <out> [KEY VALUE ...]
"""
from __future__ import annotations

import os

from ..utils.device import resolve_device


def main(argv=None):
    from ..config.config import load_config, make_argparser
    from ..models.scene_io import export_flat_ply
    from .render import load_scene_for_eval

    parser = make_argparser("gaussianrpg_tpu_torch make_ply")
    parser.add_argument("--frame", type=int, default=0)
    parser.add_argument("--out", type=str, default=None)
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = load_config(args.config, args.opts, mode="evaluate")

    models, meta, arrays, _, _, _ = load_scene_for_eval(
        cfg, dev, load_images=False)
    out = args.out or os.path.join(cfg.model_path,
                                   f"flat_frame{args.frame}.ply")
    export_flat_ply(out, models, meta, arrays, frame=args.frame)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
