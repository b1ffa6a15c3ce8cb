"""Blender / NeRF-synthetic dataset reader.

Counterpart of `gaussianrpg_tpu/data/blender.py` (reference
`lib/datasets/blender_readers.py:12-83`): loads `transforms_{split}.json`
(OpenGL camera-to-world matrices + `camera_angle_x`), alpha-composites the
frames over the configured background, and seeds a random in-bounds
pointcloud when the scene ships no `points3d.ply`. PNG frames are read
without Pillow (`image_io.read_png_rgba`, Pillow's `convert("RGBA")` for
grey, grey+alpha, RGB, RGBA and palette images), JPEG frames by
`image_io.read_jpeg` (grey or RGB, made opaque).
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..render.camera import Camera, focal2fov, fov2focal, make_camera
from .image_io import _is_png, image_hw, read_image, read_png_rgba


@dataclass
class BlenderFrame:
    camera: Camera
    image: Optional[np.ndarray]   # [3, H, W] float32, or None if unloaded
    image_path: str
    name: str


def _camera_from_transform(c2w_gl, fovx: float, width: int, height: int,
                           frame: int, device=None) -> Camera:
    # OpenGL c2w (camera looks down -z, y up) -> OpenCV by negating the
    # y/z basis vectors, then 3DGS-style (R = w2c rot transposed, T = w2c
    # translation)
    c2w = np.array(c2w_gl, np.float64)
    c2w[:3, 1:3] *= -1.0
    w2c = np.linalg.inv(c2w)
    R = w2c[:3, :3].T
    T = w2c[:3, 3]
    fovy = focal2fov(fov2focal(fovx, width), height)
    return make_camera(R=R, T=T, K=None, width=width, height=height,
                       fovx=fovx, fovy=fovy, frame=frame, timestamp=frame,
                       device=device)


def _read_rgba(path: str) -> np.ndarray:
    """[H, W, 4] uint8, as `Image.open(path).convert("RGBA")`."""
    if _is_png(path):
        return read_png_rgba(path)
    img = read_image(path)
    out = np.full(img.shape[:2] + (4,), 255, np.uint8)
    out[..., :3] = img[..., None] if img.ndim == 2 else img
    return out


def load_blender_split(path: str, split: str = "train",
                       white_background: bool = False,
                       extension: str = ".png",
                       load_images: bool = True,
                       device=None) -> List[BlenderFrame]:
    """The frames of one split: cameras on `device` (CUDA unless given),
    images [3, H, W] float32 on the host."""
    with open(os.path.join(path, f"transforms_{split}.json")) as f:
        meta = json.load(f)
    fovx = float(meta["camera_angle_x"])
    out = []
    for idx, fr in enumerate(meta["frames"]):
        img_path = os.path.join(path, fr["file_path"] + extension)
        image = None
        if load_images:
            rgba = _read_rgba(img_path).astype(np.float32) / 255.0
            bg = 1.0 if white_background else 0.0
            rgb = rgba[..., :3] * rgba[..., 3:4] + bg * (1 - rgba[..., 3:4])
            image = rgb.transpose(2, 0, 1)
            height, width = rgb.shape[:2]
        else:
            height, width = image_hw(img_path)   # the header only
        cam = _camera_from_transform(fr["transform_matrix"], fovx, width,
                                     height, idx, device)
        out.append(BlenderFrame(
            camera=cam, image=image, image_path=img_path,
            name=os.path.splitext(os.path.basename(img_path))[0]))
    return out


@dataclass
class BlenderScene:
    """train/test frames + seed points (random in the +-1.3 synthetic
    bounds when no points3d.ply exists, like the reference)."""

    train: List[BlenderFrame]
    test: List[BlenderFrame]
    points: np.ndarray
    colors: np.ndarray


def load_blender_scene(path: str, white_background: bool = False,
                       eval_split: bool = True, num_random_pts: int =
                       100_000, seed: int = 0,
                       load_images: bool = True, device=None) -> BlenderScene:
    train = load_blender_split(path, "train", white_background,
                               load_images=load_images, device=device)
    try:
        test = load_blender_split(path, "test", white_background,
                                  load_images=load_images, device=device)
    except FileNotFoundError:
        test = []
    if not eval_split:
        train = train + test
        test = []

    ply_path = os.path.join(path, "points3d.ply")
    if os.path.exists(ply_path):
        from .ply import read_ply
        vert = read_ply(ply_path)["vertex"]
        points = np.stack([vert["x"], vert["y"], vert["z"]], -1)
        if "red" in vert.dtype.names:
            colors = np.stack([vert["red"], vert["green"],
                               vert["blue"]], -1) / 255.0
        else:
            colors = np.full((len(points), 3), 0.5)
    else:
        rng = np.random.default_rng(seed)
        points = rng.random((num_random_pts, 3)) * 2.6 - 1.3
        colors = rng.random((num_random_pts, 3))
    return BlenderScene(train=train, test=test,
                        points=points.astype(np.float32),
                        colors=colors.astype(np.float32))
