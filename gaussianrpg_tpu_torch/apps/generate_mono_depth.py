"""Monocular depth generation (gated): reference
`script/waymo/generate_mono_depth.py` runs MiDaS DPT_Hybrid via torch.hub.

The hook is gated: it runs a local TorchScript/torch checkpoint given
with --weights. Outputs match the reference contract:
`{out}/mono_depth/{frame:06d}_{cam}.npy` (relative inverse depth [H, W])
plus a colormapped PNG for inspection.

Usage: python -m gaussianrpg_tpu_torch.apps.generate_mono_depth <datadir>
           --weights midas.pt [--ignore-exists] [--device cpu]

Counterpart of `gaussianrpg_tpu/apps/generate_mono_depth.py`: the model and
its bicubic resizes run on `--device` (CUDA unless told otherwise; the
JAX app runs them on the CPU); images are read and the PNGs written
through `data/image_io` (no Pillow). Unlike the JAX app, it never
falls back to `torch.hub` (a download): `--weights` is required, and a
path that does not exist raises FileNotFoundError.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch
import torch.nn.functional as F

from ..data.image_io import read_image, write_png
from ..utils.device import resolve_device


def load_midas(weights: str, device=None):
    dev = resolve_device(device)
    if not (weights and os.path.exists(weights)):
        raise FileNotFoundError(
            f"MiDaS weights {weights!r} not found: export DPT_Hybrid "
            "(torch.hub intel-isl/MiDaS) elsewhere and pass --weights.")
    model = torch.jit.load(weights, map_location=dev) \
        if weights.endswith((".ts", ".torchscript")) \
        else torch.load(weights, map_location=dev, weights_only=False)
    model = model.to(dev)
    model.eval()
    for p in model.parameters():
        p.requires_grad = False
    return model


def estimate_depth(model, img_chw: np.ndarray, device=None) -> np.ndarray:
    """Relative inverse depth [H, W] (reference
    `generate_mono_depth.py:25-50`: normalize, 384x512 bicubic, DPT,
    resize back), on `device` (CUDA unless given)."""
    dev = resolve_device(device)
    h, w = img_chw.shape[1:]
    x = torch.from_numpy((img_chw[None] - 0.5) / 0.5).float().to(dev)
    x = F.interpolate(x, size=(384, 512), mode="bicubic",
                      align_corners=False)
    with torch.no_grad():
        pred = model(x)
        pred = F.interpolate(pred.unsqueeze(1), size=(h, w),
                             mode="bicubic", align_corners=False)
    return pred.squeeze().cpu().numpy()


def generate_mono_depth(datadir: str, weights: str,
                        ignore_exists: bool = False, log=print,
                        device=None) -> int:
    from ..utils.visualize import visualize_depth

    dev = resolve_device(device)
    model = load_midas(weights, dev)

    img_dir = os.path.join(datadir, "images")
    out_dir = os.path.join(datadir, "mono_depth")
    os.makedirs(out_dir, exist_ok=True)
    count = 0
    for name in sorted(os.listdir(img_dir)):
        stem = name.rsplit(".", 1)[0]
        out_npy = os.path.join(out_dir, stem + ".npy")
        if ignore_exists and os.path.exists(out_npy):
            continue
        img = read_image(os.path.join(img_dir, name)).astype(
            np.float32)[..., :3] / 255.0
        depth = estimate_depth(model, img.transpose(2, 0, 1), dev)
        np.save(out_npy, depth.astype(np.float32))
        vis = (visualize_depth(depth).transpose(1, 2, 0)
               * 255).astype(np.uint8)
        write_png(os.path.join(out_dir, stem + ".png"), vis)
        count += 1
        log(f"mono_depth: {stem}")
    return count


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("datadir")
    p.add_argument("--weights", required=True)
    p.add_argument("--ignore-exists", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device (default: CUDA)")
    args = p.parse_args(argv)
    n = generate_mono_depth(args.datadir, args.weights, args.ignore_exists,
                            device=args.device)
    print(f"wrote {n} depth maps")


if __name__ == "__main__":
    main()
