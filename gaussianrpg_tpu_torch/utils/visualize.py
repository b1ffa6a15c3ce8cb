"""Render-output visualization helpers.

Counterpart of `gaussianrpg_tpu/utils/visualize.py`: depth colormaps,
per-frame PNG dumps (rgb/gt/depth/diff/acc), the training debug contact
sheet, horizontal multi-camera concat and mp4 assembly. PNGs go through
`data/image_io.write_png` (no Pillow); the depth colormap is OpenCV's JET
and the video writer imageio's, each where it is installed (an error
naming the package otherwise). Inputs are numpy arrays or tensors on any
device.
"""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from ..data.image_io import write_png


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def to_hwc8(chw) -> np.ndarray:
    """[3, H, W] floats in [0, 1] -> [H, W, 3] uint8 (truncated, as the
    JAX package's `to_hwc8`)."""
    return (np.clip(_np(chw), 0, 1).transpose(1, 2, 0)
            * 255).astype(np.uint8)


def _cv2():
    try:
        import cv2
    except ImportError:
        raise ImportError("visualize_depth needs OpenCV (cv2) for its JET "
                          "colormap, and cv2 is not installed") from None
    return cv2


def visualize_depth(depth, near: float = 0.1,
                    far: Optional[float] = None) -> np.ndarray:
    """[1, H, W] or [H, W] depth -> colour [3, H, W] in [0, 1] with cv2's
    JET (`img_utils.visualize_depth_numpy:242`)."""
    cv2 = _cv2()
    d = _np(depth)
    if d.ndim == 3:
        d = d[0]
    finite = d[np.isfinite(d) & (d > 0)]
    far = far or (np.percentile(finite, 99) if finite.size else 1.0)
    x = np.clip((d - near) / max(far - near, 1e-6), 0, 1)
    cm = cv2.applyColorMap((x * 255).astype(np.uint8), cv2.COLORMAP_JET)
    return cm[..., ::-1].transpose(2, 0, 1).astype(np.float32) / 255.0


def save_image(path: str, chw) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    write_png(path, to_hwc8(chw))


def save_visualization(out_dir: str, name: str, result, gt=None):
    """Dump {name}_rgb/_gt/_depth/_acc/_diff.png (`base_visualizer.py`
    naming)."""
    rgb = _np(result.rgb)
    save_image(os.path.join(out_dir, f"{name}_rgb.png"), rgb)
    if gt is not None:
        gt = _np(gt)
        save_image(os.path.join(out_dir, f"{name}_gt.png"), gt)
        save_image(os.path.join(out_dir, f"{name}_diff.png"),
                   np.abs(rgb - gt))
    save_image(os.path.join(out_dir, f"{name}_depth.png"),
               visualize_depth(result.depth))
    save_image(os.path.join(out_dir, f"{name}_acc.png"),
               np.repeat(_np(result.acc), 3, axis=0))


def training_contact_sheet(gt, rgb, depth, acc, rgb_obj=None, acc_obj=None):
    """2x3 debug sheet: gt | render | depth / acc | obj | obj-acc
    (`train.py:233-250`)."""
    gt = _np(gt)
    depth_c = visualize_depth(depth)
    acc3 = np.repeat(_np(acc), 3, axis=0)
    blank = np.zeros_like(gt)
    row0 = np.concatenate([gt, _np(rgb), depth_c], axis=2)
    row1 = np.concatenate(
        [acc3,
         _np(rgb_obj) if rgb_obj is not None else blank,
         np.repeat(_np(acc_obj), 3, axis=0)
         if acc_obj is not None else blank], axis=2)
    return np.clip(np.concatenate([row0, row1], axis=1), 0, 1)


def hcat_cameras(images: List) -> np.ndarray:
    """Horizontal multi-camera concat
    (`street_gaussian_visualizer.py:233-276`)."""
    images = [_np(im) for im in images]
    h = min(im.shape[1] for im in images)
    return np.concatenate([im[:, :h, :] for im in images], axis=2)


def write_video(path: str, frames_chw: List, fps: int = 10):
    try:
        import imageio
    except ImportError:
        raise ImportError("write_video needs imageio, and imageio is not "
                          "installed") from None
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    imageio.mimwrite(path, [to_hwc8(f) for f in frames_chw], fps=fps)
