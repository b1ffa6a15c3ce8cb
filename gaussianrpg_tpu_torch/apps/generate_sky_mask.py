"""Sky masks for the sky-opacity loss.

The reference generates these with GroundingDINO + SAM
(`script/waymo/generate_sky_mask.py`, external checkpoints). This app
provides a dependency-free geometric fallback — LiDAR returns never come
from sky, so everything clearly above the per-column LiDAR horizon is
sky — plus a hook for an external segmenter when one is available.
The output layout matches the reference (`sky_mask/{frame:06d}_{cam}.png`,
255 = sky), which feeds train/trainer.py's `lambda_sky` loss.

Counterpart of `gaussianrpg_tpu/apps/generate_sky_mask.py`; image sizes
come from the files' headers (`data/image_io.image_hw`), not Pillow.
"""
from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from ..data.image_io import image_hw
from .waymo_converter import write_gray_png


def geometric_sky_mask(proj_uv: np.ndarray, h: int, w: int,
                       col_bin: int = 32, margin_px: int = 12
                       ) -> np.ndarray:
    """Mask of pixels above the per-column LiDAR horizon.

    proj_uv [M, 2] pixel coords of this camera's LiDAR returns. Columns
    are binned (col_bin px), the horizon is the minimum v per bin
    (median-smoothed), and pixels margin_px above it are sky.
    """
    nbin = (w + col_bin - 1) // col_bin
    horizon = np.full(nbin, h, np.float64)
    if len(proj_uv):
        u = np.clip(proj_uv[:, 0].astype(np.int64) // col_bin, 0, nbin - 1)
        np.minimum.at(horizon, u, proj_uv[:, 1].astype(np.float64))
    # fill bins with no returns from neighbours, then 3-tap median smooth
    filled = horizon.copy()
    for i in range(nbin):
        if horizon[i] >= h:
            left = horizon[:i][horizon[:i] < h]
            right = horizon[i + 1:][horizon[i + 1:] < h]
            cand = ([left[-1]] if len(left) else []) \
                + ([right[0]] if len(right) else [])
            filled[i] = np.mean(cand) if cand else h
    sm = filled.copy()
    for i in range(1, nbin - 1):
        sm[i] = np.median(filled[i - 1:i + 2])
    per_col = np.repeat(sm, col_bin)[:w]
    vs = np.arange(h)[:, None]
    return vs < (per_col[None, :] - margin_px)


def generate_sky_mask(datadir: str, method: str = "geometric",
                      log=print) -> int:
    save_dir = os.path.join(datadir, "sky_mask")
    os.makedirs(save_dir, exist_ok=True)
    npz = np.load(os.path.join(datadir, "pointcloud.npz"),
                  allow_pickle=True)
    pts2d = npz["camera_projection"].item()

    images = sorted(glob.glob(os.path.join(datadir, "images", "*.jpg"))
                    + glob.glob(os.path.join(datadir, "images", "*.png")))
    n_done = 0
    for path in images:
        base = os.path.splitext(os.path.basename(path))[0]
        frame, cam = int(base[:6]), int(base[-1])
        if frame not in pts2d:
            continue
        h, w = image_hw(path)
        if method != "geometric":
            raise ValueError(f"unknown method {method}; plug an external "
                             "segmenter by writing sky_mask/ directly")
        flat = pts2d[frame].reshape(-1, 3)
        uv = flat[flat[:, 0] == cam][:, 1:3]
        mask = geometric_sky_mask(uv, h, w)
        write_gray_png(os.path.join(save_dir, f"{base}.png"),
                       mask.astype(np.uint8) * 255)
        n_done += 1
        if n_done % 20 == 0:
            log(f"  {n_done}/{len(images)} sky masks")
    return n_done


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--datadir", required=True)
    ap.add_argument("--method", default="geometric")
    args = ap.parse_args(argv)
    n = generate_sky_mask(args.datadir, args.method)
    print(f"wrote {n} sky masks")


if __name__ == "__main__":
    main()
