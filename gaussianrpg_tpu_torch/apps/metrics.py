"""Post-hoc image metrics CLI; counterpart of
`gaussianrpg_tpu/apps/metrics.py` (reference `metrics.py:26-104`).

    python -m gaussianrpg_tpu_torch.apps.metrics [--device cuda] \
        [--config <yaml>] model_path <out> [KEY VALUE ...]

reads the `*_rgb.png` / `*_gt.png` pairs of `<model_path>/evaluate_{split}`
(as `apps.render` writes them), computes PSNR and SSIM on the device, and
LPIPS when `eval.lpips.{backbone_path,lin_path}` name existing torchvision
backbone and richzhang lin state dicts (`utils/lpips.py`), else through
the external `lpips` package where it is installed; writes
`results_{split}.json` and `per_view_{split}.json`.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..data.image_io import read_png
from ..utils.device import resolve_device


def _load(path: str) -> np.ndarray:
    """[3, H, W] float32 in [0, 1]."""
    return read_png(path).astype(np.float32).transpose(2, 0, 1)[:3] / 255.0


def lpips_from_files(preds, gts, backbone_path: str, lin_path: str,
                     net_type: str = "vgg", device=None):
    """Mean LPIPS through the port's module (`utils/lpips.py`) with the
    weights of `backbone_path` and `lin_path`; None when either file is
    absent (`metrics.lpips_jax`)."""
    if not (backbone_path and os.path.exists(backbone_path)
            and lin_path and os.path.exists(lin_path)):
        return None
    from ..utils.lpips import load_torch_lpips

    dev = resolve_device(device)
    net = load_torch_lpips(backbone_path, lin_path, net_type, device=dev)
    vals = []
    with torch.no_grad():
        for p, g in zip(preds, gts):
            x = torch.as_tensor(p, device=dev)
            y = torch.as_tensor(g, device=dev)
            vals.append(float(net(x * 2 - 1, y * 2 - 1)))
    return float(np.mean(vals))


def lpips_alex(preds, gts, device=None):
    """LPIPS(alex) through the external torch `lpips` package where it is
    installed (it fetches its own weights); None otherwise."""
    try:
        import lpips
    except ImportError:
        return None
    dev = resolve_device(device)
    try:
        model = lpips.LPIPS(net="alex").to(dev)
    except Exception:
        return None
    vals = []
    with torch.no_grad():
        for p, g in zip(preds, gts):
            tp = torch.as_tensor(p * 2 - 1, device=dev)[None]
            tg = torch.as_tensor(g * 2 - 1, device=dev)[None]
            vals.append(float(model(tp, tg)))
    return float(np.mean(vals))


def evaluate_dir(render_dir: str, lpips_cfg: dict | None = None,
                 device=None):
    """(results, per-view results) of the pairs in `render_dir`, on
    `device` (CUDA unless given)."""
    from ..train.losses import psnr, ssim

    dev = resolve_device(device)
    names = sorted(f[:-8] for f in os.listdir(render_dir)
                   if f.endswith("_rgb.png")
                   and os.path.exists(os.path.join(render_dir,
                                                   f[:-8] + "_gt.png")))
    psnrs, ssims, per_view = [], [], {}
    preds, gts = [], []
    for name in names:
        p = _load(os.path.join(render_dir, name + "_rgb.png"))
        g = _load(os.path.join(render_dir, name + "_gt.png"))
        preds.append(p)
        gts.append(g)
        tp, tg = torch.as_tensor(p, device=dev), torch.as_tensor(g, device=dev)
        with torch.no_grad():
            pv = float(psnr(tp, tg))
            sv = float(ssim(tp, tg))
        psnrs.append(pv)
        ssims.append(sv)
        per_view[name] = {"psnr": pv, "ssim": sv}
    out = {
        "psnr": float(np.mean(psnrs)) if psnrs else None,
        "ssim": float(np.mean(ssims)) if ssims else None,
        "n_views": len(names),
    }
    lp = None
    if preds and lpips_cfg:
        lp = lpips_from_files(preds, gts, lpips_cfg.get("backbone_path", ""),
                              lpips_cfg.get("lin_path", ""),
                              lpips_cfg.get("net_type", "vgg"), device=dev)
    if preds and lp is None:
        lp = lpips_alex(preds, gts, device=dev)
    if lp is not None:
        out["lpips"] = lp
    return out, per_view


def main(argv=None):
    from ..config.config import load_config, make_argparser

    parser = make_argparser("gaussianrpg_tpu_torch metrics")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = load_config(args.config, args.opts)

    lpips_cfg = dict(cfg.eval.get("lpips", {})) if "eval" in cfg else {}
    for split in ("train", "test"):
        d = os.path.join(cfg.model_path, f"evaluate_{split}")
        if not os.path.isdir(d):
            continue
        results, per_view = evaluate_dir(d, lpips_cfg, dev)
        with open(os.path.join(cfg.model_path,
                               f"results_{split}.json"), "w") as f:
            json.dump(results, f, indent=2)
        with open(os.path.join(cfg.model_path,
                               f"per_view_{split}.json"), "w") as f:
            json.dump(per_view, f, indent=2)
        print(split, results)


if __name__ == "__main__":
    main()
