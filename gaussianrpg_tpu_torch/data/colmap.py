"""Minimal COLMAP binary model readers (numpy-only).

Port of the subset of `lib/utils/colmap_utils.py` the data
path actually uses: `read_points3D_binary`, `read_extrinsics_binary`,
`read_intrinsics_binary` (SfM points seed background Gaussians and the
Colmap dataset reader builds cameras from them).

A copy of `gaussianrpg_tpu/data/colmap.py`.
"""
from __future__ import annotations

import collections
import struct
from typing import Dict

import numpy as np

CameraModel = collections.namedtuple("CameraModel",
                                     ["model_id", "model_name", "num_params"])
Camera = collections.namedtuple("Camera",
                                ["id", "model", "width", "height", "params"])
Image = collections.namedtuple(
    "Image", ["id", "qvec", "tvec", "camera_id", "name", "xys",
              "point3D_ids"])
Point3D = collections.namedtuple(
    "Point3D", ["id", "xyz", "rgb", "error", "image_ids", "point2D_idxs"])

CAMERA_MODELS = {m.model_id: m for m in [
    CameraModel(0, "SIMPLE_PINHOLE", 3), CameraModel(1, "PINHOLE", 4),
    CameraModel(2, "SIMPLE_RADIAL", 4), CameraModel(3, "RADIAL", 5),
    CameraModel(4, "OPENCV", 8), CameraModel(5, "OPENCV_FISHEYE", 8),
    CameraModel(6, "FULL_OPENCV", 12), CameraModel(7, "FOV", 5),
    CameraModel(8, "SIMPLE_RADIAL_FISHEYE", 4),
    CameraModel(9, "RADIAL_FISHEYE", 5), CameraModel(10, "THIN_PRISM_FISHEYE",
                                                     12)]}


def _read(f, n, fmt):
    return struct.unpack("<" + fmt, f.read(n))


def read_points3D_binary(path: str) -> Dict[int, Point3D]:
    """`colmap_utils.read_points3D_binary` analog."""
    out = {}
    with open(path, "rb") as f:
        (num,) = _read(f, 8, "Q")
        for _ in range(num):
            props = _read(f, 43, "QdddBBBd")
            pid = props[0]
            xyz = np.array(props[1:4])
            rgb = np.array(props[4:7])
            error = props[7]
            (track_len,) = _read(f, 8, "Q")
            track = _read(f, 8 * track_len, "ii" * track_len)
            out[pid] = Point3D(
                id=pid, xyz=xyz, rgb=rgb, error=error,
                image_ids=np.array(track[0::2]),
                point2D_idxs=np.array(track[1::2]))
    return out


def read_intrinsics_binary(path: str) -> Dict[int, Camera]:
    out = {}
    with open(path, "rb") as f:
        (num,) = _read(f, 8, "Q")
        for _ in range(num):
            cam_id, model_id, width, height = _read(f, 24, "iiQQ")
            model = CAMERA_MODELS[model_id]
            params = _read(f, 8 * model.num_params,
                           "d" * model.num_params)
            out[cam_id] = Camera(id=cam_id, model=model.model_name,
                                 width=width, height=height,
                                 params=np.array(params))
    return out


def read_extrinsics_binary(path: str) -> Dict[int, Image]:
    out = {}
    with open(path, "rb") as f:
        (num,) = _read(f, 8, "Q")
        for _ in range(num):
            props = _read(f, 64, "idddddddi")
            img_id = props[0]
            qvec = np.array(props[1:5])
            tvec = np.array(props[5:8])
            cam_id = props[8]
            name = b""
            c = f.read(1)
            while c != b"\x00":
                name += c
                c = f.read(1)
            (n2d,) = _read(f, 8, "Q")
            data = _read(f, 24 * n2d, "ddq" * n2d)
            xys = np.column_stack([data[0::3], data[1::3]])
            ids = np.array(data[2::3])
            out[img_id] = Image(id=img_id, qvec=qvec, tvec=tvec,
                                camera_id=cam_id, name=name.decode(),
                                xys=xys, point3D_ids=ids)
    return out


def qvec2rotmat(qvec):
    """`colmap_utils.qvec2rotmat` (w, x, y, z)."""
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w,
         2 * x * z + 2 * y * w],
        [2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z,
         2 * y * z - 2 * x * w],
        [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w,
         1 - 2 * x * x - 2 * y * y]])


def points3D_to_arrays(points: Dict[int, Point3D]):
    xyz = np.stack([p.xyz for p in points.values()]).astype(np.float32)
    rgb = (np.stack([p.rgb for p in points.values()]) / 255.0).astype(
        np.float32)
    return xyz, rgb
