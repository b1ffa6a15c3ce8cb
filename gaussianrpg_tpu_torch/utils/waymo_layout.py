"""Write a scene directory in the Waymo converter's layout (the one
`data/waymo.WaymoScene` reads, `gaussianrpg_tpu/data/waymo.py:6-16`), from
arrays: for scenes made without the TFRecord converter, as the tests and
`chip_smoke.py` make theirs.

    images/{frame:06d}_{cam}.png         uint8 RGB
    ego_pose/{frame:06d}.txt             vehicle->world, and one copy per
    ego_pose/{frame:06d}_{cam}.txt       camera of `cameras`
    intrinsics/{cam}.txt                 fx fy cx cy k1 k2 p1 p2 k3
    extrinsics/{cam}.txt                 camera->vehicle (OpenCV axes)
    timestamps.json                      FRAME and per-camera seconds
    track/track_info.txt                 a header, then one row per box
    track/track_camera_vis.json
    sky_mask/, semantic/ (PNG), lidar_depth/, mono_normal/ (npy)
    input_ply/points3D_{name}.ply        when given
    pointcloud.npz                       vehicle-frame LiDAR returns and
                                         their camera projections
"""
from __future__ import annotations

import json
import os

import numpy as np

from ..data.image_io import write_png
from ..data.ply import store_pointcloud

CAM_NAMES = ("FRONT", "FRONT_LEFT", "FRONT_RIGHT", "SIDE_LEFT",
             "SIDE_RIGHT")
TRACK_HEADER = ("frame_id track_id object_class alpha box_height box_width "
                "box_length box_center_x box_center_y box_center_z "
                "box_heading speed")


def _key(frame: int, cam: int) -> str:
    return f"{frame:06d}_{cam}"


def write_waymo_scene(root: str, *, ego_poses, intrinsics, extrinsics,
                      timestamps, tracks=(), camera_vis=None, cameras=(0,),
                      images=None, sky_masks=None, lidar_depth=None,
                      mono_normal=None, semantic=None, point_clouds=None,
                      pointcloud=None, png_level: int = 6) -> None:
    """Write the scene under `root`.

    ego_poses [F, 4, 4] vehicle->world; intrinsics [5, 9]; extrinsics
    [5, 4, 4] camera->vehicle; timestamps [F] seconds (every camera shares
    the frame's). tracks: rows (frame, track_id, class, height, width,
    length, x, y, z, heading, speed) in the vehicle frame; camera_vis
    {track_id: {frame: [cams]}}. images, sky_masks (uint8/bool [H, W]),
    lidar_depth ([H, W], 0 where no return), mono_normal ([H, W, 3]) and
    semantic (uint8 [H, W], 255 ignored) are dicts keyed by (frame, cam).
    point_clouds {name: (xyz, rgb in [0, 1])}; pointcloud (points {frame:
    [N, 3]}, projections {frame: [N, 6] int16 (cam, w, h, ...)})."""
    def sub(*parts):
        path = os.path.join(root, *parts)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        return path

    ego_poses = np.asarray(ego_poses, np.float64)
    for f, pose in enumerate(ego_poses):
        np.savetxt(sub("ego_pose", f"{f:06d}.txt"), pose)
        for cam in cameras:
            np.savetxt(sub("ego_pose", f"{_key(f, cam)}.txt"), pose)
    for cam in range(len(CAM_NAMES)):
        np.savetxt(sub("intrinsics", f"{cam}.txt"),
                   np.asarray(intrinsics[cam], np.float64))
        np.savetxt(sub("extrinsics", f"{cam}.txt"),
                   np.asarray(extrinsics[cam], np.float64))
    stamps = {f"{f:06d}": float(t) for f, t in enumerate(timestamps)}
    with open(sub("timestamps.json"), "w") as fh:
        json.dump({"FRAME": stamps, **{n: stamps for n in CAM_NAMES}}, fh)

    rows = [TRACK_HEADER] + [
        f"{fr} {tid} {cls} -10 {h} {w} {ln} {x} {y} {z} {hd} {sp}"
        for fr, tid, cls, h, w, ln, x, y, z, hd, sp in tracks]
    with open(sub("track", "track_info.txt"), "w") as fh:
        fh.write("\n".join(rows) + "\n")
    with open(sub("track", "track_camera_vis.json"), "w") as fh:
        json.dump({str(t): {str(fr): list(c) for fr, c in v.items()}
                   for t, v in (camera_vis or {}).items()}, fh)

    for (f, cam), img in (images or {}).items():
        write_png(sub("images", f"{_key(f, cam)}.png"),
                  np.asarray(img, np.uint8), png_level)
    for (f, cam), m in (sky_masks or {}).items():
        write_png(sub("sky_mask", f"{_key(f, cam)}.png"),
                  (np.asarray(m) > 0).astype(np.uint8) * 255, png_level)
    for (f, cam), d in (lidar_depth or {}).items():
        d = np.asarray(d, np.float32)
        np.save(sub("lidar_depth", f"{_key(f, cam)}.npy"),
                {"mask": d > 0, "value": d[d > 0]})
    for (f, cam), n in (mono_normal or {}).items():
        np.save(sub("mono_normal", f"{_key(f, cam)}.npy"),
                np.asarray(n, np.float32))
    for (f, cam), s in (semantic or {}).items():
        write_png(sub("semantic", f"{_key(f, cam)}.png"),
                  np.asarray(s, np.uint8), png_level)
    for name, (xyz, rgb) in (point_clouds or {}).items():
        store_pointcloud(sub("input_ply", f"points3D_{name}.ply"), xyz, rgb)
    if pointcloud is not None:
        pts, proj = pointcloud
        np.savez_compressed(sub("pointcloud.npz"), pointcloud=pts,
                            camera_projection=proj)
