"""Appearance (colour) and camera-pose correction models.

Counterpart of `gaussianrpg_tpu/models/corrections.py`: per-image (or
per-sensor) 3x4 affine colour transforms, either a table or an MLP on the
camera pose (last layer zero so it starts at identity), and per-image (or
per-frame) SE(3) corrections of the background Gaussians. Both are
dataclasses of plain tensors (the trainer replaces them out of place); the
MLP is the JAX layer dict {"w0": [in, out], "b0": [out], ...}.
"""
from __future__ import annotations

import dataclasses

import torch

from ..ops.math3d import (l1_abs, matrix_to_quaternion,
                          quaternion_multiply, quaternion_to_matrix)
from ..utils.device import resolve_device

MLP_DIMS = (6, 64, 64, 64, 12)


def _mlp(generator: torch.Generator | None, device) -> dict:
    """ReLU MLP layers with torch Linear's uniform init, last layer zero so
    the correction starts at identity."""
    layers = {}
    for i in range(len(MLP_DIMS) - 1):
        shape = (MLP_DIMS[i], MLP_DIMS[i + 1])
        bound = 1.0 / MLP_DIMS[i] ** 0.5
        if i == len(MLP_DIMS) - 2:
            layers[f"w{i}"] = torch.zeros(shape, device=device)
            layers[f"b{i}"] = torch.zeros(shape[1], device=device)
        else:
            layers[f"w{i}"] = torch.empty(shape, device=device).uniform_(
                -bound, bound, generator=generator)
            layers[f"b{i}"] = torch.empty(shape[1], device=device).uniform_(
                -bound, bound, generator=generator)
    return layers


def _mlp_apply(layers: dict, x: torch.Tensor) -> torch.Tensor:
    n = len(layers) // 2
    for i in range(n):
        x = x @ layers[f"w{i}"] + layers[f"b{i}"]
        if i < n - 1:
            x = torch.relu(x)
    return x


@dataclasses.dataclass
class ColorCorrection:
    """`affine`/`affine_sky`: [num, 3, 4] tables, or MLP layer dicts
    (use_mlp)."""

    affine: object
    affine_sky: object
    mode: str = "image"
    use_mlp: bool = False

    def correction_id(self, camera):
        return camera.image_id if self.mode == "image" else camera.cam_id

    def replace(self, **kw) -> "ColorCorrection":
        return dataclasses.replace(self, **kw)


def init_color_correction(num: int, mode: str = "image",
                          use_mlp: bool = False,
                          generator: torch.Generator | None = None,
                          device=None) -> ColorCorrection:
    dev = resolve_device(device)
    if use_mlp:
        return ColorCorrection(_mlp(generator, dev), _mlp(generator, dev),
                               mode=mode, use_mlp=True)
    eye = torch.eye(4, dtype=torch.float32, device=dev)[:3][None].repeat(
        num, 1, 1)
    return ColorCorrection(eye, eye.clone(), mode=mode)


def quaternion_to_axis_angle(q: torch.Tensor) -> torch.Tensor:
    norm = torch.linalg.norm(q[..., 1:], dim=-1)
    half = torch.atan2(norm, q[..., 0])
    angle = 2.0 * half
    small = torch.abs(angle) < 1e-6
    sin_half = torch.where(
        small, 0.5 + angle * angle / 48.0,
        torch.sin(half) / torch.where(small, torch.ones_like(angle), angle))
    return q[..., 1:] / sin_half


def _camera_pose_input(camera) -> torch.Tensor:
    c2w = camera.ego_pose @ camera.extrinsic
    aa = quaternion_to_axis_angle(matrix_to_quaternion(c2w[:3, :3]))
    return torch.cat([aa, c2w[:3, 3]])


def get_affine(cc: ColorCorrection, camera, use_sky: bool = False):
    """The 3x4 affine for this camera."""
    params = cc.affine_sky if use_sky else cc.affine
    if cc.use_mlp:
        out = _mlp_apply(params, _camera_pose_input(camera))
        return out.reshape(3, 4) + torch.eye(4, dtype=out.dtype,
                                             device=out.device)[:3]
    return params[cc.correction_id(camera)]


def apply_color_correction(cc: ColorCorrection, camera, image: torch.Tensor,
                           use_sky: bool = False) -> torch.Tensor:
    """image [3, H, W] -> corrected."""
    m = get_affine(cc, camera, use_sky)
    return torch.einsum("ij,jhw->ihw", m[:, :3], image) \
        + m[:, 3][:, None, None]


def color_correction_reg_loss(cc: ColorCorrection, camera) -> torch.Tensor:
    """Sum of the mean |affine - identity| of the main and the sky
    transform."""
    eye = torch.eye(4, dtype=torch.float32,
                    device=camera.viewmatrix.device)[:3]
    return (l1_abs(get_affine(cc, camera) - eye).mean()
            + l1_abs(get_affine(cc, camera, use_sky=True) - eye).mean())


@dataclasses.dataclass
class PoseCorrection:
    trans: torch.Tensor   # [num, 3]
    rots: torch.Tensor    # [num, 4] unnormalized, identity at init
    mode: str = "image"

    def correction_id(self, camera):
        return camera.image_id if self.mode == "image" else camera.frame

    def replace(self, **kw) -> "PoseCorrection":
        return dataclasses.replace(self, **kw)


def init_pose_correction(num: int, mode: str = "image",
                         device=None) -> PoseCorrection:
    dev = resolve_device(device)
    rots = torch.tensor([1.0, 0, 0, 0], device=dev)[None].repeat(num, 1)
    return PoseCorrection(trans=torch.zeros((num, 3), device=dev), rots=rots,
                          mode=mode)


def correct_gaussian_xyz(pc: PoseCorrection, idx, xyz: torch.Tensor):
    """xyz' = R(q) xyz + t."""
    q = pc.rots[idx]
    q = q / torch.linalg.norm(q)
    return xyz @ quaternion_to_matrix(q).T + pc.trans[idx]


def correct_gaussian_rotation(pc: PoseCorrection, idx, rotation):
    q = pc.rots[idx]
    q = q / torch.linalg.norm(q)
    return quaternion_multiply(q[None, :], rotation)


def pose_correction_reg_loss(pc: PoseCorrection) -> torch.Tensor:
    """Mean |t| plus mean |normalized q - identity|."""
    loss_t = l1_abs(pc.trans).mean()
    rn = pc.rots / torch.linalg.norm(pc.rots, dim=-1, keepdim=True)
    ident = torch.tensor([1.0, 0, 0, 0], dtype=rn.dtype, device=rn.device)
    return loss_t + l1_abs(rn - ident).mean()
