"""Sparse LiDAR depth maps from the converted pointcloud.

Equivalent of `script/waymo/generate_lidar_depth.py:33-105`: for every
image, scatter the frame's LiDAR returns (already paired with per-point
camera projections by the converter) into a min-depth map and save
`{frame:06d}_{cam}.npy` dicts {mask [H,W] bool, value [M] float} — the
format the depth-supervision loss consumes (train/trainer.py
lidar_depth).

Counterpart of `gaussianrpg_tpu/apps/generate_lidar_depth.py`; image sizes
come from the files' headers (`data/image_io.image_hw`), not Pillow.
"""
from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from ..data.image_io import image_hw


def load_calibration(datadir: str, n_cams: int = 5):
    intrinsics, extrinsics = [], []
    for i in range(n_cams):
        vals = np.loadtxt(os.path.join(datadir, "intrinsics", f"{i}.txt"))
        intrinsics.append(np.array([[vals[0], 0, vals[2]],
                                    [0, vals[1], vals[3]], [0, 0, 1]]))
        extrinsics.append(
            np.loadtxt(os.path.join(datadir, "extrinsics", f"{i}.txt")))
    return extrinsics, intrinsics


def depth_map_for(points_vehicle: np.ndarray, proj_2d: np.ndarray,
                  cam: int, cam_to_ego: np.ndarray, h: int, w: int
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Min-scatter the points projecting into camera `cam` -> (mask [h,w],
    values [mask.sum()]). proj_2d is the converter's [N, 6] layout (two
    (cam, x, y) projections per point, cam 0-based, -1 = none)."""
    n = points_vehicle.shape[0]
    pts_idx = np.repeat(np.arange(n), 2)
    flat = proj_2d.reshape(-1, 3)
    sel = flat[:, 0] == cam
    xyz = points_vehicle[pts_idx[sel]]
    uv = flat[sel][:, 1:3].astype(np.int64)

    w2c = np.linalg.inv(cam_to_ego)
    cam_pts = np.concatenate([xyz, np.ones_like(xyz[:, :1])], 1) @ w2c.T
    z = cam_pts[:, 2]
    ok = z > 0
    uv = np.clip(uv[ok], [0, 0], [w - 1, h - 1])
    depth = np.full(h * w, np.finfo(np.float32).max, np.float32)
    np.minimum.at(depth, uv[:, 1] * w + uv[:, 0], z[ok].astype(np.float32))
    depth[depth >= np.finfo(np.float32).max - 1e30] = 0
    mask = (depth != 0).reshape(h, w)
    return mask, depth.reshape(h, w)[mask]


def generate_lidar_depth(datadir: str, log=print):
    save_dir = os.path.join(datadir, "lidar_depth")
    os.makedirs(save_dir, exist_ok=True)
    npz = np.load(os.path.join(datadir, "pointcloud.npz"),
                  allow_pickle=True)
    pts3d = npz["pointcloud"].item()
    pts2d = npz["camera_projection"].item()
    extrinsics, _ = load_calibration(datadir)

    images = sorted(glob.glob(os.path.join(datadir, "images", "*.jpg"))
                    + glob.glob(os.path.join(datadir, "images", "*.png")))
    n_done = 0
    for path in images:
        base = os.path.splitext(os.path.basename(path))[0]
        frame, cam = int(base[:6]), int(base[-1])
        if frame not in pts3d:
            continue
        h, w = image_hw(path)
        mask, values = depth_map_for(pts3d[frame], pts2d[frame], cam,
                                     extrinsics[cam], h, w)
        np.save(os.path.join(save_dir, f"{base}.npy"),
                {"mask": mask, "value": values})
        n_done += 1
        if n_done % 20 == 0:
            log(f"  {n_done}/{len(images)} depth maps")
    return n_done


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--datadir", required=True)
    args = ap.parse_args(argv)
    n = generate_lidar_depth(args.datadir)
    print(f"wrote {n} depth maps")


if __name__ == "__main__":
    main()
