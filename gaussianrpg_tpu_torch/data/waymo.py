"""Waymo preprocessed-scene reader.

Numpy port of the reference's Waymo ingestion
(`lib/utils/waymo_utils.py:41-712`,
`lib/datasets/waymo_full_readers.py:16-256`): consumes the directory layout
written by the offline converter (`script/waymo/waymo_converter.py`):

    {datadir}/images/{frame:06d}_{cam}.png
    {datadir}/ego_pose/{frame:06d}.txt, {frame:06d}_{cam}.txt
    {datadir}/intrinsics/{cam}.txt  (fx fy cx cy k1 k2 p1 p2 k3)
    {datadir}/extrinsics/{cam}.txt  (4x4 cam->ego)
    {datadir}/track/track_info.txt, track/track_camera_vis.json
    {datadir}/timestamps.json
    {datadir}/input_ply/points3D_{bkgd,obj_XXX}.ply   (if prepared)
    {datadir}/sky_mask/, lidar_depth/                  (optional)

Builds camera lists + scene metadata shaped for the scene graph. The
offline toolchain itself (TFRecord conversion, COLMAP, sky masks, depth)
stays a CPU-side preprocessing step, as in the reference.

Counterpart of `gaussianrpg_tpu/data/waymo.py`, the same code but for two
things: images go through `data/image_io` instead of Pillow (PNG read,
`resize_bilinear` / `resize_nearest` equal to Pillow's resizes; baseline
JPEG by `read_jpeg`, equal to Pillow's decode), and `build_cameras` makes
the port's cameras on the caller's device. Images and planes stay numpy
arrays on the host.
"""
from __future__ import annotations

import json
import math
import os
from typing import Dict, List

import numpy as np

from .image_io import image_hw, read_image, resize_bilinear, resize_nearest

WAYMO_TRACK2LABEL = {"vehicle": 0, "pedestrian": 1, "cyclist": 2,
                     "sign": 3, "misc": -1}
NUM_CAMS = 5


def image_filename_to_frame(name: str) -> int:
    return int(os.path.basename(name).split(".")[0].split("_")[0])


def image_filename_to_cam(name: str) -> int:
    return int(os.path.basename(name).split(".")[0].split("_")[1])


def load_camera_info(datadir: str):
    """`waymo_utils.load_camera_info:41-80`: intrinsics, cam->ego
    extrinsics, recentered ego poses (per frame and per camera)."""
    intrinsics = []
    extrinsics = []
    for i in range(NUM_CAMS):
        vals = np.loadtxt(os.path.join(datadir, "intrinsics", f"{i}.txt"))
        fx, fy, cx, cy = vals[0], vals[1], vals[2], vals[3]
        intrinsics.append(
            np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64))
        extrinsics.append(
            np.loadtxt(os.path.join(datadir, "extrinsics", f"{i}.txt")))

    ego_pose_dir = os.path.join(datadir, "ego_pose")
    frame_poses = []
    cam_poses: List[List[np.ndarray]] = [[] for _ in range(NUM_CAMS)]
    for name in sorted(os.listdir(ego_pose_dir)):
        pose = np.loadtxt(os.path.join(ego_pose_dir, name))
        if "_" not in name:
            frame_poses.append(pose)
        else:
            cam_poses[image_filename_to_cam(name)].append(pose)

    frame_poses = np.array(frame_poses)
    center = frame_poses[:, :3, 3].mean(axis=0)
    frame_poses[:, :3, 3] -= center
    # cameras without saved per-cam poses (single-camera converts) fall
    # back to the per-frame ego pose
    per_cam = []
    for c in cam_poses:
        arr = np.array(c) if c else frame_poses.copy()
        if c:
            arr[:, :3, 3] -= center
        per_cam.append(arr)
    cam_poses_arr = np.array(per_cam)
    return intrinsics, extrinsics, frame_poses, cam_poses_arr, center


def _heading_to_quat(heading: float) -> np.ndarray:
    return np.array([math.cos(heading / 2), 0.0, 0.0,
                     math.sin(heading / 2)])


def load_tracking(datadir: str, start_frame: int, end_frame: int,
                  cameras=(0,), box_scale: float = 1.0,
                  use_tracker: bool = False):
    """`waymo_utils.get_obj_pose_tracking:112-272`: parse track_info.txt,
    drop untracked classes / camera-invisible / static objects, build
    [num_frames, max_obj, 8] vehicle-frame tracklets + per-object info."""
    suffix = "_castrack" if use_tracker else ""
    with open(os.path.join(datadir, "track",
                           f"track_info{suffix}.txt")) as f:
        rows = f.read().splitlines()[1:]
    with open(os.path.join(datadir, "track",
                           f"track_camera_vis{suffix}.json")) as f:
        camera_vis = json.load(f)

    objects_info: Dict[int, dict] = {}
    records = []
    for row in rows:
        t = row.split()
        frame_id, track_id, obj_class = int(t[0]), int(t[1]), t[2]
        if obj_class in ("sign", "misc"):
            continue
        vis = camera_vis.get(str(track_id), {}).get(str(frame_id), [])
        if not set(cameras) & set(vis):
            continue
        h, w, l = float(t[4]), float(t[5]), float(t[6])
        info = objects_info.setdefault(track_id, dict(
            track_id=track_id, class_name=obj_class,
            class_label=WAYMO_TRACK2LABEL[obj_class],
            height=h, width=w, length=l))
        info["height"] = max(info["height"], h)
        info["width"] = max(info["width"], w)
        info["length"] = max(info["length"], l)
        cx, cy, cz, heading = (float(t[7]), float(t[8]), float(t[9]),
                               float(t[10]))
        records.append((frame_id, track_id, cx, cy, cz, heading))

    num_frames = end_frame - start_frame + 1
    per_frame: List[List[tuple]] = [[] for _ in range(num_frames)]
    for frame_id, track_id, cx, cy, cz, heading in records:
        if start_frame <= frame_id <= end_frame:
            per_frame[frame_id - start_frame].append(
                (track_id, cx, cy, cz, heading))
    max_obj = max((len(p) for p in per_frame), default=0)
    max_obj = max(max_obj, 1)

    ids = np.full((num_frames, max_obj), -1.0)
    poses_vehicle = np.full((num_frames, max_obj, 7), -1.0)
    for fi, objs in enumerate(per_frame):
        for col, (track_id, cx, cy, cz, heading) in enumerate(objs):
            ids[fi, col] = track_id
            poses_vehicle[fi, col, :3] = (cx, cy, cz)
            poses_vehicle[fi, col, 3:] = _heading_to_quat(heading)

    # remove static objects (std < 0.5 everywhere and displacement <= 2m,
    # measured in WORLD frame -> needs ego poses; the caller passes poses
    # through `mark_static`)
    return ids, poses_vehicle, objects_info, max_obj


def remove_static_objects(ids, poses_vehicle, objects_info, ego_poses,
                          start_frame):
    """`waymo_utils.get_obj_pose_tracking:194-208` (world-frame motion
    test)."""
    for track_id in list(objects_info.keys()):
        where = np.argwhere(ids == track_id)
        if len(where) == 0:
            objects_info.pop(track_id)
            continue
        world = []
        for fi, col in where:
            ego = ego_poses[start_frame + fi]
            p = ego[:3, :3] @ poses_vehicle[fi, col, :3] + ego[:3, 3]
            world.append(p)
        world = np.array(world)
        dist = np.linalg.norm(world[0] - world[-1])
        dynamic = np.any(world.std(axis=0) > 0.5) or dist > 2
        if not dynamic:
            for fi, col in where:
                ids[fi, col] = -1
                poses_vehicle[fi, col] = -1
            objects_info.pop(track_id)
    return ids, poses_vehicle, objects_info


def get_val_frames(num_frames: int, test_every: int | None,
                   train_every: int | None):
    """`lib/utils/data_utils.get_val_frames:36`."""
    assert train_every is None or test_every is None
    if train_every is None and test_every is None:
        return []
    if train_every is None:
        return [i for i in range(num_frames)
                if test_every > 0 and i % test_every == 0]
    return [i for i in range(num_frames)
            if train_every <= 0 or i % train_every != 0]


class WaymoScene:
    """Loaded scene: cameras, tracklets, metadata, init point clouds."""

    def __init__(self, datadir: str, selected_frames=None, cameras=(0,),
                 box_scale: float = 1.0, test_every: int | None = None,
                 train_every: int | None = None, load_images: bool = True,
                 resolution: int = -1):
        self.datadir = datadir
        (self.intrinsics, self.extrinsics, self.ego_frame_poses,
         self.ego_cam_poses, self.center) = load_camera_info(datadir)
        n_total = len(self.ego_frame_poses)
        if selected_frames is None:
            selected_frames = [0, n_total - 1]
        self.start_frame, self.end_frame = selected_frames
        self.num_frames = self.end_frame - self.start_frame + 1
        self.cameras = list(cameras)

        with open(os.path.join(datadir, "timestamps.json")) as f:
            ts = json.load(f)
        # normalized timestamps (waymo_full_readers.py:72-102 semantics)
        frame_ts = np.array(
            [ts["FRAME"][f"{f:06d}"]
             for f in range(self.start_frame, self.end_frame + 1)])
        t0, t1 = frame_ts.min(), frame_ts.max()
        self.timestamp_range = (t0, t1)
        norm = lambda t: (t - t0) / max(t1 - t0, 1e-9)
        self.frame_timestamps = np.array([norm(t) for t in frame_ts])
        self.cam_timestamps = {}
        for cam in self.cameras:
            key = {0: "FRONT", 1: "FRONT_LEFT", 2: "FRONT_RIGHT",
                   3: "SIDE_LEFT", 4: "SIDE_RIGHT"}[cam]
            self.cam_timestamps[cam] = np.array(
                [norm(ts[key][f"{f:06d}"])
                 for f in range(self.start_frame, self.end_frame + 1)])

        ids, poses_v, objects_info, max_obj = load_tracking(
            datadir, self.start_frame, self.end_frame, cameras, box_scale)
        ids, poses_v, objects_info = remove_static_objects(
            ids, poses_v, objects_info, self.ego_frame_poses,
            self.start_frame)
        for info in objects_info.values():
            info["deformable"] = info["class_name"] == "pedestrian"
            info["width"] *= box_scale
            info["length"] *= box_scale
            where = np.argwhere(ids == info["track_id"])[:, 0]
            info["start_frame"] = int(where.min())
            info["end_frame"] = int(where.max())
            info["start_timestamp"] = float(
                self.frame_timestamps[where.min()])
            info["end_timestamp"] = float(self.frame_timestamps[where.max()])
        self.objects_info = dict(sorted(objects_info.items()))
        self.tracklets = np.concatenate(
            [ids[..., None], poses_v], axis=-1).astype(np.float32)

        self.val_frames = get_val_frames(self.num_frames, test_every,
                                         train_every)
        self.load_images = load_images
        self.resolution = resolution
        self._native_hw: dict[int, tuple[int, int]] = {}

    # ------------------------------------------------------------------
    def image_path(self, frame: int, cam: int) -> str:
        # .png from the reference converter; .jpg (raw sensor bytes) from
        # apps/waymo_converter.py
        for ext in ("png", "jpg"):
            p = os.path.join(self.datadir, "images",
                             f"{frame:06d}_{cam}.{ext}")
            if os.path.exists(p):
                return p
        return os.path.join(self.datadir, "images",
                            f"{frame:06d}_{cam}.png")

    def camera_to_world(self, frame: int, cam: int) -> np.ndarray:
        """c2w (recentered world) = per-camera ego pose @ cam->ego
        extrinsic (the converter bakes the OpenCV axis swap in)."""
        return self.ego_cam_poses[cam, frame] @ self.extrinsics[cam]

    def native_size(self, cam: int) -> tuple[int, int]:
        """(H, W) of the raw sensor images — the resolution the stored
        intrinsics describe. Derived from the first image on disk (only its
        header is read); Waymo's (1280, 1920) when no images exist."""
        if cam not in self._native_hw:
            hw = (1280, 1920)
            for fi in range(self.num_frames):
                p = self.image_path(self.start_frame + fi, cam)
                if os.path.exists(p):
                    hw = image_hw(p)
                    break
            self._native_hw[cam] = hw
        return self._native_hw[cam]

    def load_image(self, frame: int, cam: int):
        img = read_image(self.image_path(frame, cam))
        h, w = img.shape[:2]
        if self.resolution == -1 and w > 1600:
            # auto-downscale beyond 1.6k (`camera_utils.py:169-187`)
            scale = w / 1600
            img = resize_bilinear(img, (int(w / scale), int(h / scale)))
        elif self.resolution and self.resolution > 1:
            # explicit integer downscale factor (reference `loadCam`
            # resolution semantics)
            r = int(self.resolution)
            img = resize_bilinear(img, (w // r, h // r))
        arr = np.asarray(img, np.float32) / 255.0
        return arr.transpose(2, 0, 1)[:3]

    def build_cameras(self, split: str = "train", device=None):
        """Camera list for training/eval; `waymo_full_readers.py:104-195`:
        [(camera on `device` (CUDA unless given), ground truth [3, H, W]
        float32 numpy or None)]."""
        from ..render.camera import make_camera

        cams = []
        for fi in range(self.num_frames):
            frame = self.start_frame + fi
            is_val = fi in self.val_frames
            if split == "train" and is_val:
                continue
            if split == "test" and not is_val:
                continue
            for cam in self.cameras:
                ego_pose = self.ego_cam_poses[cam, frame]
                ext = self.extrinsics[cam]
                # the converter bakes the waymo->OpenCV axis change into the
                # saved extrinsics (waymo_converter.py:49,164), so c2w is a
                # straight compose (waymo_utils.py:353)
                c2w = ego_pose @ ext
                w2c = np.linalg.inv(c2w)
                K = self.intrinsics[cam].copy()
                gt = None
                h, w = 1280, 1920
                if self.load_images and os.path.exists(
                        self.image_path(frame, cam)):
                    gt = self.load_image(frame, cam)
                    h, w = gt.shape[1:]
                    # intrinsics are calibrated at the NATIVE sensor size;
                    # rescale to whatever load_image returned
                    scale = self.native_size(cam)[1] / w
                    K = K.copy()
                    K[:2] /= scale
                else:
                    nh, nw = self.native_size(cam)
                    scale = 1.0
                    if self.resolution == -1 and nw > 1600:
                        scale = nw / 1600
                    elif self.resolution and self.resolution > 1:
                        scale = float(int(self.resolution))
                    K = K.copy()
                    K[:2] /= scale
                    w, h = int(nw / scale), int(nh / scale)
                cams.append((make_camera(
                    R=w2c[:3, :3].T, T=w2c[:3, 3], K=K.astype(np.float32),
                    width=w, height=h,
                    ego_pose=ego_pose.astype(np.float32),
                    extrinsic=ext.astype(np.float32),
                    timestamp=float(self.cam_timestamps[cam][fi]),
                    frame=frame, cam_id=cam, image_id=len(cams),
                    device=device,
                ), gt))
        return cams

    def load_batch_planes(self, frame: int, cam: int, hw: tuple,
                          native_hw: tuple | None = None):
        """Per-image training planes for the loss terms
        (`camera_utils.loadmask:113-141` + `loadmetadata:143-164`):
        sky_mask [1,H,W] bool, lidar_depth [1,H,W] (0 where no return),
        obj_bound [1,H,W] bool, mono_normal [3,H,W] — each None when the
        corresponding data-prep output is absent. `hw` is the training
        resolution; `native_hw` the sensor resolution the intrinsics
        describe. When None, derived from the images on disk."""
        h, w = hw
        if native_hw is None:
            native_hw = self.native_size(cam)
        out = {}

        p = os.path.join(self.datadir, "sky_mask", f"{frame:06d}_{cam}.png")
        if os.path.exists(p):
            m = resize_nearest(read_image(p), (w, h))
            out["sky_mask"] = (np.asarray(m) > 0).reshape(1, h, w)

        p = os.path.join(self.datadir, "lidar_depth",
                         f"{frame:06d}_{cam}.npy")
        if os.path.exists(p):
            d = np.load(p, allow_pickle=True).item()
            full_h, full_w = d["mask"].shape
            depth = np.zeros((full_h, full_w), np.float32)
            depth[d["mask"]] = d["value"]
            if (full_h, full_w) != (h, w):
                ys, xs = np.nonzero(d["mask"])
                depth_s = np.zeros((h, w), np.float32)
                depth_s[(ys * h // full_h), (xs * w // full_w)] = d["value"]
                depth = depth_s
            out["lidar_depth"] = depth.reshape(1, h, w)

        # object 2D bound from the tracked boxes (`waymo_utils.py:409-439`)
        fi = frame - self.start_frame
        if 0 <= fi < self.num_frames:
            from ..utils.boxes import bbox_to_corner3d, get_bound_2d_mask
            bound = np.zeros((h, w), bool)
            K = self.intrinsics[cam].copy()
            K[:2] *= w / float(native_hw[1])
            w2c = np.linalg.inv(self.extrinsics[cam])
            any_obj = False
            for t in self.tracklets[fi]:
                tid = int(t[0])
                if tid < 0 or tid not in self.objects_info:
                    continue
                info = self.objects_info[tid]
                half = np.array([info["length"], info["width"],
                                 info["height"]]) / 2.0
                corners = bbox_to_corner3d(np.stack([-half, half]))
                corners = np.concatenate(
                    [corners, np.ones_like(corners[:, :1])], -1)
                pose = np.eye(4)
                from ..data.lidar_init import _quat_to_matrix
                pose[:3, :3] = _quat_to_matrix(np.asarray(t[4:8],
                                                          np.float64))
                pose[:3, 3] = t[1:4]
                cv = (corners @ pose.T)[:, :3]
                bound |= get_bound_2d_mask(cv, K, w2c, h, w)
                any_obj = True
            if any_obj:
                out["obj_bound"] = bound.reshape(1, h, w)

        p = os.path.join(self.datadir, "mono_normal",
                         f"{frame:06d}_{cam}.npy")
        if os.path.exists(p):
            nrm = np.load(p).astype(np.float32)        # [H, W, 3] in [-1,1]
            if nrm.shape[:2] != (h, w):
                idx_y = (np.arange(h) * nrm.shape[0] // h)
                idx_x = (np.arange(w) * nrm.shape[1] // w)
                nrm = nrm[idx_y][:, idx_x]
            out["mono_normal"] = nrm.transpose(2, 0, 1)

        # semantic label plane (reference `camera_utils.loadmetadata:148-150`
        # resizes metadata['semantic'] with NEAREST; consumed by the CE loss
        # in `train.py:129-140` as [1, H, W] long with ignore_index=-1).
        # Accepts an int label image (.png, values = class ids, 255 = ignore)
        # or a raw int array (.npy, -1 = ignore).
        for ext in ("npy", "png"):
            p = os.path.join(self.datadir, "semantic",
                             f"{frame:06d}_{cam}.{ext}")
            if not os.path.exists(p):
                continue
            if ext == "npy":
                sem = np.load(p)
                sem = sem.reshape(sem.shape[-2], sem.shape[-1])
                sem = sem.astype(np.int32)
            else:
                sem = read_image(p)
                if sem.ndim == 3:          # palettized/rgb export: use ch 0
                    sem = sem[..., 0]
                sem = sem.astype(np.int32)
                sem[sem == 255] = -1       # uint8 ignore convention
            if sem.shape != (h, w):        # NEAREST resample
                idx_y = (np.arange(h) * sem.shape[0] // h)
                idx_x = (np.arange(w) * sem.shape[1] // w)
                sem = sem[idx_y][:, idx_x]
            out["semantic"] = sem.reshape(1, h, w)
            break
        return out

    def load_init_pointclouds(self, auto_build: bool = True):
        """Background + per-object init PLYs written by the data-prep
        toolchain (`waymo_utils.py:703-711`). When absent but the
        converter's `pointcloud.npz` exists, the LiDAR init pipeline
        (`data/lidar_init.py`, reference `waymo_utils.py:452-712`) builds
        them on demand — the reference's `build_pointcloud` trigger in
        `generate_dataparser_outputs`."""
        from .ply import fetch_pointcloud
        out = {}
        ply_dir = os.path.join(self.datadir, "input_ply")
        bkgd = os.path.join(ply_dir, "points3D_bkgd.ply")
        if not os.path.exists(bkgd) and auto_build and os.path.exists(
                os.path.join(self.datadir, "pointcloud.npz")):
            from .lidar_init import build_init_pointclouds
            colmap_xyz = colmap_rgb = None
            cpath = os.path.join(self.datadir, "colmap",
                                 "triangulated/sparse/model/points3D.bin")
            if os.path.exists(cpath):
                from .colmap import read_points3D_binary
                pts3d = read_points3D_binary(cpath)
                if pts3d:
                    colmap_xyz = np.stack(
                        [p.xyz for p in pts3d.values()]).astype(np.float32)
                    colmap_rgb = np.stack(
                        [p.rgb for p in pts3d.values()]).astype(np.float32)
            build_init_pointclouds(self, colmap_xyz=colmap_xyz,
                                   colmap_rgb=colmap_rgb)
        if os.path.exists(bkgd):
            out["background"] = fetch_pointcloud(bkgd)
        lidar = os.path.join(ply_dir, "points3D_lidar.ply")
        if os.path.exists(lidar):
            out["lidar"] = fetch_pointcloud(lidar)
        for tid in self.objects_info:
            p = os.path.join(ply_dir, f"points3D_obj_{tid:03d}.ply")
            if os.path.exists(p):
                out[tid] = fetch_pointcloud(p)
        return out


