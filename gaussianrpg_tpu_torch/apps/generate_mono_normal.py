"""Monocular surface-normal generation (gated): the reference
`script/waymo/generate_mono_normal.py` shells out to a DSINE checkout;
this hook accepts any normal-estimation model exported as TorchScript
(input [1,3,H,W] RGB in [0,1], output [1,3,H,W] unit normals in OpenCV
camera convention) and writes the contract the mono-normal loss consumes
(`WaymoScene.load_batch_planes`): `{datadir}/mono_normal/{stem}.npy`
as [H, W, 3] float32 in [-1, 1], plus a visualization PNG.

Usage: python -m gaussianrpg_tpu_torch.apps.generate_mono_normal <datadir>
           --weights dsine.torchscript [--ignore-exists] [--device cpu]

Counterpart of `gaussianrpg_tpu/apps/generate_mono_normal.py`: the model
runs on `--device` (CUDA unless told otherwise; the JAX app runs it on
the CPU); images are read and the PNGs written through `data/image_io`.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..data.image_io import read_image, write_png
from ..utils.device import resolve_device


def generate_mono_normal(datadir: str, weights: str,
                         ignore_exists: bool = False, log=print,
                         device=None) -> int:
    dev = resolve_device(device)
    if not (weights and os.path.exists(weights)):
        raise RuntimeError(
            "normal-estimator weights unavailable (no model egress in this "
            "environment). Export DSINE/omnidata as TorchScript elsewhere "
            "and pass --weights.")
    model = torch.jit.load(weights, map_location=dev)
    model.eval()

    img_dir = os.path.join(datadir, "images")
    out_dir = os.path.join(datadir, "mono_normal")
    os.makedirs(out_dir, exist_ok=True)
    count = 0
    for name in sorted(os.listdir(img_dir)):
        stem = name.rsplit(".", 1)[0]
        out_npy = os.path.join(out_dir, stem + ".npy")
        if ignore_exists and os.path.exists(out_npy):
            continue
        img = read_image(os.path.join(img_dir, name)).astype(
            np.float32)[..., :3] / 255.0
        x = torch.from_numpy(img.transpose(2, 0, 1)[None]).float().to(dev)
        with torch.no_grad():
            n = model(x)[0].cpu().numpy()            # [3, H, W]
        n = n / np.maximum(np.linalg.norm(n, axis=0, keepdims=True), 1e-6)
        np.save(out_npy, n.transpose(1, 2, 0).astype(np.float32))
        vis = ((n.transpose(1, 2, 0) * 0.5 + 0.5) * 255).astype(np.uint8)
        write_png(os.path.join(out_dir, stem + ".png"), vis)
        count += 1
        log(f"mono_normal: {stem}")
    return count


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("datadir")
    p.add_argument("--weights", required=True)
    p.add_argument("--ignore-exists", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device (default: CUDA)")
    args = p.parse_args(argv)
    n = generate_mono_normal(args.datadir, args.weights, args.ignore_exists,
                             device=args.device)
    print(f"wrote {n} normal maps")


if __name__ == "__main__":
    main()
