"""Render camera as a dataclass of tensors.

Counterpart of `gaussianrpg_tpu/render/camera.py`, with its conventions:
`viewmatrix` is world->camera [4, 4] in column-vector form
(x_cam = V @ [x, 1]), `projmatrix` is P @ V, and `lim_tan_fov*` /
`full_width`/`full_height` describe the physical camera when they differ
from the rendered one. `frame`, `timestamp` and `image_id` are tensors.
The matrices are built in float64 numpy and stored as float32, exactly as
the JAX package builds them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from ..utils.device import resolve_device

Z_NEAR = 0.001
Z_FAR = 1000.0


def get_world2view(R: np.ndarray, T: np.ndarray) -> np.ndarray:
    """World->camera 4x4 from 3DGS-style (R = C2W rotation, T = W2C
    translation)."""
    Rt = np.zeros((4, 4), dtype=np.float64)
    Rt[:3, :3] = np.asarray(R).T
    Rt[:3, 3] = np.asarray(T)
    Rt[3, 3] = 1.0
    return Rt.astype(np.float32)


def projection_matrix_from_K(K: np.ndarray, H: int, W: int,
                             znear=Z_NEAR, zfar=Z_FAR) -> np.ndarray:
    """OpenGL-style projection from a pinhole K (with skew)."""
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    s = K[0, 1]
    P = np.zeros((4, 4), dtype=np.float64)
    P[0, 0] = 2 * fx / W
    P[0, 1] = 2 * s / W
    P[0, 2] = -1 + 2 * (cx / W)
    P[1, 1] = 2 * fy / H
    P[1, 2] = -1 + 2 * (cy / H)
    P[2, 2] = (zfar + znear) / (zfar - znear)
    P[2, 3] = -2 * zfar * znear / (zfar - znear)
    P[3, 2] = 1.0
    return P.astype(np.float32)


def projection_matrix_from_fov(fovx: float, fovy: float,
                               znear=Z_NEAR, zfar=Z_FAR) -> np.ndarray:
    tan_x = math.tan(fovx / 2)
    tan_y = math.tan(fovy / 2)
    P = np.zeros((4, 4), dtype=np.float64)
    P[0, 0] = 1.0 / tan_x
    P[1, 1] = 1.0 / tan_y
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    P[3, 2] = 1.0
    return P.astype(np.float32)


def focal2fov(focal: float, pixels: float) -> float:
    return 2 * math.atan(pixels / (2 * focal))


def fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2 * math.tan(fov / 2))


@dataclasses.dataclass
class Camera:
    viewmatrix: torch.Tensor      # [4, 4] world->camera
    projmatrix: torch.Tensor      # [4, 4] P @ V
    cam_center: torch.Tensor      # [3]
    K: torch.Tensor               # [3, 3]
    width: int
    height: int
    tan_fovx: float
    tan_fovy: float
    ego_pose: torch.Tensor = None   # [4, 4] vehicle->world
    extrinsic: torch.Tensor = None  # [4, 4] camera->vehicle
    timestamp: torch.Tensor = None  # [] f32
    frame: torch.Tensor = None      # [] i32
    image_id: torch.Tensor = None   # [] i32
    cam_id: int = 0
    meta: Any = None
    lim_tan_fovx: float | None = None
    lim_tan_fovy: float | None = None
    full_width: int | None = None
    full_height: int | None = None

    @property
    def device(self) -> torch.device:
        return self.viewmatrix.device

    def replace(self, **kw) -> "Camera":
        return dataclasses.replace(self, **kw)


def make_camera(
    R: np.ndarray,
    T: np.ndarray,
    K: np.ndarray | None,
    width: int,
    height: int,
    fovx: float | None = None,
    fovy: float | None = None,
    ego_pose: np.ndarray | None = None,
    extrinsic: np.ndarray | None = None,
    timestamp: float = 0.0,
    frame: int = 0,
    image_id: int = 0,
    cam_id: int = 0,
    meta: Any = None,
    device=None,
) -> Camera:
    """Camera from 3DGS-style (R, T, K) on `device` (CUDA unless given)."""
    dev = resolve_device(device)
    V = get_world2view(R, T)
    if K is not None:
        P = projection_matrix_from_K(np.asarray(K), height, width)
        if fovx is None:
            fovx = focal2fov(K[0, 0], width)
        if fovy is None:
            fovy = focal2fov(K[1, 1], height)
    else:
        assert fovx is not None and fovy is not None
        P = projection_matrix_from_fov(fovx, fovy)
        K = np.array(
            [
                [fov2focal(fovx, width), 0, width / 2],
                [0, fov2focal(fovy, height), height / 2],
                [0, 0, 1],
            ],
            dtype=np.float32,
        )
    full_proj = (P.astype(np.float64) @ V.astype(np.float64)).astype(np.float32)
    cam_center = np.linalg.inv(V)[:3, 3].astype(np.float32)
    ident = np.eye(4, dtype=np.float32)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    return Camera(
        viewmatrix=f32(V),
        projmatrix=f32(full_proj),
        cam_center=f32(cam_center),
        K=f32(K),
        width=int(width),
        height=int(height),
        tan_fovx=float(math.tan(fovx / 2)),
        tan_fovy=float(math.tan(fovy / 2)),
        ego_pose=f32(ident if ego_pose is None else ego_pose),
        extrinsic=f32(ident if extrinsic is None else extrinsic),
        timestamp=f32(timestamp),
        frame=torch.tensor(int(frame), dtype=torch.int32, device=dev),
        image_id=torch.tensor(int(image_id), dtype=torch.int32, device=dev),
        cam_id=int(cam_id),
        meta=meta,
    )


def camera_from_c2w(c2w: np.ndarray, K: np.ndarray, width: int, height: int,
                    **kw) -> Camera:
    """Camera from a camera->world pose (the inverse taken in float64);
    keyword arguments go to `make_camera` (`device` among them)."""
    w2c = np.linalg.inv(np.asarray(c2w, dtype=np.float64))
    return make_camera(w2c[:3, :3].T, w2c[:3, 3], K, width, height, **kw)
