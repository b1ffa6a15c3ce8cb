"""LiDAR -> initial point-cloud build (scene initialization).

TPU-framework equivalent of the reference pointcloud-building stage of
`generate_dataparser_outputs` (`lib/utils/waymo_utils.py:
452-712`): lift each frame's vehicle-frame LiDAR returns to world space,
color them by projecting into the camera images, route points inside
tracked bounding boxes into per-object local clouds (capped at 20k,
`:573-575`), voxel-downsample (0.15 m) + radius-outlier-filter
(10 pts / 0.5 m, `:556-561`) the background, merge COLMAP triangulated
points filtered to 2x the LiDAR sphere radius (`:589-608`), and save
`input_ply/points3D_{bkgd,obj_XXX,lidar,colmap}.ply` (`:703-711`).

All numpy/scipy (offline CPU tooling; the o3d voxel/outlier calls are
re-implemented below — open3d is not a dependency here).

A copy of `gaussianrpg_tpu/data/lidar_init.py`, but for the camera
images, which are read by `data/image_io.read_image` (PNG, or baseline
JPEG by the port's own decoder).
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from ..utils.boxes import bbox_to_corner3d, inbbox_points
from .image_io import read_image
from .ply import store_pointcloud


def _quat_to_matrix(q: np.ndarray) -> np.ndarray:
    """wxyz quaternion -> rotation matrix (numpy;
    `general_utils.quaternion_to_matrix_numpy` semantics)."""
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def voxel_downsample(xyz: np.ndarray, rgb: np.ndarray, voxel_size: float):
    """Average points/colors per occupied voxel (o3d
    `voxel_down_sample` semantics, `waymo_utils.py:559`)."""
    keys = np.floor(xyz / voxel_size).astype(np.int64)
    # unique voxel ids via lexicographic sort of the 3 int columns
    _, inv = np.unique(keys, axis=0, return_inverse=True)
    n = inv.max() + 1 if inv.size else 0
    cnt = np.bincount(inv, minlength=n).astype(np.float64)
    out_xyz = np.stack(
        [np.bincount(inv, weights=xyz[:, i], minlength=n) for i in range(3)],
        axis=1) / cnt[:, None]
    out_rgb = np.stack(
        [np.bincount(inv, weights=rgb[:, i], minlength=n) for i in range(3)],
        axis=1) / cnt[:, None]
    return out_xyz.astype(np.float32), out_rgb.astype(np.float32)


def radius_outlier_removal(xyz: np.ndarray, rgb: np.ndarray,
                           nb_points: int = 10, radius: float = 0.5):
    """Keep points with >= nb_points neighbors within `radius` (o3d
    `remove_radius_outlier` semantics, `waymo_utils.py:561`)."""
    from scipy.spatial import cKDTree
    tree = cKDTree(xyz)
    counts = tree.query_ball_point(xyz, radius, return_length=True,
                                   workers=-1)
    keep = counts >= nb_points  # count includes the query point itself
    return xyz[keep], rgb[keep]


def sphere_norm(xyz: np.ndarray, scale: float = 1.0):
    """Bounding-sphere center/radius (`base_readers.get_Sphere_Norm:73-85`)."""
    xyz_max = xyz.max(axis=0)
    xyz_min = xyz.min(axis=0)
    center = (xyz_max + xyz_min) / 2.0
    radius = float(np.linalg.norm(xyz_max - xyz_min) / 2.0) * scale
    return center.astype(np.float32), radius


def build_init_pointclouds(
    scene,                       # data.waymo.WaymoScene
    out_dir: Optional[str] = None,
    colmap_xyz: Optional[np.ndarray] = None,
    colmap_rgb: Optional[np.ndarray] = None,
    max_obj_points: int = 20000,
    voxel_size: float = 0.15,
    outlier_nb_points: int = 10,
    outlier_radius: float = 0.5,
    sphere_scale: float = 1.0,
    filter_colmap: bool = False,
    colmap_extent: float = 10.0,
    seed: int = 0,
) -> Dict[str, tuple]:
    """Build + (optionally) save the initialization point clouds.

    Returns {name: (xyz [N,3] f32, rgb [N,3] f32 in [0,1])} with keys
    'bkgd', 'lidar', 'colmap' (if provided), and 'obj_XXX' per dynamic
    track. Coordinates: background in recentered world frame, objects in
    object-local frame — exactly what `scene_builder.build_scene_from_waymo`
    consumes (reference peer `waymo_utils.py:452-712`).
    """
    rng = np.random.default_rng(seed)
    datadir = scene.datadir
    pc_path = os.path.join(datadir, "pointcloud.npz")
    data = np.load(pc_path, allow_pickle=True)
    pts3d_dict = data["pointcloud"].item()
    pts2d_dict = data["camera_projection"].item()

    obj_xyz: Dict[int, list] = {tid: [] for tid in scene.objects_info}
    obj_rgb: Dict[int, list] = {tid: [] for tid in scene.objects_info}
    bkgd_xyz, bkgd_rgb = [], []

    tracklets = scene.tracklets       # [F, max_obj, 8] (id, xyz, quat) veh
    cam_set = set(scene.cameras)

    for fi in range(scene.num_frames):
        frame = scene.start_frame + fi
        if frame not in pts3d_dict:
            continue
        raw_3d = np.asarray(pts3d_dict[frame], np.float64)
        raw_2d = np.asarray(pts2d_dict[frame])

        # keep points observed by at least one selected camera (the first
        # projection slot, `waymo_utils.py:484-489`)
        cam_of = raw_2d[:, 0].astype(np.int64)
        mask = np.isin(cam_of, list(cam_set))
        pts_vehicle = raw_3d[mask]
        pv_h = np.concatenate(
            [pts_vehicle, np.ones_like(pts_vehicle[:, :1])], axis=-1)

        ego = scene.ego_frame_poses[frame]       # recentered world
        pts_world = pv_h @ ego.T

        # color from the projecting camera's image (`waymo_utils.py:502-515`)
        rgb = np.ones((pts_vehicle.shape[0], 3), np.float64)
        cam_sel = cam_of[mask]
        projw = raw_2d[mask, 1].astype(np.int64)
        projh = raw_2d[mask, 2].astype(np.int64)
        for cam in scene.cameras:
            mc = cam_sel == cam
            if not mc.any():
                continue
            img_path = scene.image_path(frame, cam)
            if not os.path.exists(img_path):
                continue
            img = read_image(img_path).astype(np.float64)[..., :3] / 255.0
            h_i = np.clip(projh[mc], 0, img.shape[0] - 1)
            w_i = np.clip(projw[mc], 0, img.shape[1] - 1)
            rgb[mc] = img[h_i, w_i]

        # route points inside tracked boxes to per-object local clouds
        # (`waymo_utils.py:518-547`)
        in_any_obj = np.zeros(pts_vehicle.shape[0], bool)
        for tracklet in tracklets[fi]:
            track_id = int(tracklet[0])
            if track_id < 0 or track_id not in scene.objects_info:
                continue
            obj_pose = np.eye(4)
            obj_pose[:3, :3] = _quat_to_matrix(np.asarray(tracklet[4:8],
                                                          np.float64))
            obj_pose[:3, 3] = tracklet[1:4]
            veh2local = np.linalg.inv(obj_pose)
            pts_local = (pv_h @ veh2local.T)[:, :3]
            info = scene.objects_info[track_id]
            half = np.array([info["length"], info["width"],
                             info["height"]]) / 2.0
            corners = bbox_to_corner3d(np.stack([-half, half]))
            inside = inbbox_points(pts_local, corners)
            in_any_obj |= inside
            if inside.any():
                obj_xyz[track_id].append(pts_local[inside])
                obj_rgb[track_id].append(rgb[inside])

        bkgd_xyz.append(pts_world[~in_any_obj][:, :3])
        bkgd_rgb.append(rgb[~in_any_obj])

    result: Dict[str, tuple] = {}
    if bkgd_xyz:
        xyz = np.concatenate(bkgd_xyz, axis=0)
        col = np.concatenate(bkgd_rgb, axis=0)
        xyz, col = voxel_downsample(xyz, col, voxel_size)
        xyz, col = radius_outlier_removal(xyz, col, outlier_nb_points,
                                          outlier_radius)
        result["lidar"] = (xyz, col)

    for tid in scene.objects_info:
        if not obj_xyz[tid]:
            continue
        xyz = np.concatenate(obj_xyz[tid], axis=0).astype(np.float32)
        col = np.concatenate(obj_rgb[tid], axis=0).astype(np.float32)
        if xyz.shape[0] > max_obj_points:       # `waymo_utils.py:573-575`
            sel = rng.choice(xyz.shape[0], max_obj_points, replace=False)
            xyz, col = xyz[sel], col[sel]
        result[f"obj_{tid:03d}"] = (xyz, col)

    # COLMAP merge (`waymo_utils.py:589-608`)
    if "lidar" in result:
        center, radius = sphere_norm(result["lidar"][0], sphere_scale)
        result["sphere"] = (center, radius)
        bx, bc = result["lidar"]
        if colmap_xyz is not None and colmap_xyz.size:
            cx = np.asarray(colmap_xyz, np.float32)
            cc = np.asarray(colmap_rgb, np.float32)
            if cc.max() > 1.5:
                cc = cc / 255.0
            if filter_colmap:
                keep = np.ones(cx.shape[0], bool)
                for cam in scene.cameras:
                    for fi in range(scene.num_frames):
                        c2w = scene.camera_to_world(scene.start_frame + fi,
                                                    cam)
                        cam_pos = c2w[:3, 3]
                        r = np.linalg.norm(cx - cam_pos, axis=-1)
                        near = (r < colmap_extent) | (cx[:, 2] < cam_pos[2])
                        keep &= ~near
                cx, cc = cx[keep], cc[keep]
            dist = np.linalg.norm(cx - center, axis=-1)
            m = dist < 2.0 * radius
            cx, cc = cx[m], cc[m]
            result["colmap"] = (cx, cc)
            bx = np.concatenate([bx, cx], axis=0)
            bc = np.concatenate([bc, cc], axis=0)
        result["bkgd"] = (bx, bc)

    if out_dir is None:
        out_dir = os.path.join(datadir, "input_ply")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        for name, val in result.items():
            if name == "sphere":
                continue
            xyz, col = val
            store_pointcloud(
                os.path.join(out_dir, f"points3D_{name}.ply"), xyz,
                np.clip(col, 0.0, 1.0))
    return result
