"""The blend inputs the tools run on, built as `tools/blend_floor.py:45-62`
builds them: the frozen bench scene's fields in depth order, pair lists
over the sorted table, and the pair rows gathered from it."""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..ops import binning
from ..ops.rasterize import primitive_fields, suggest_binning_sizes
from ..render.camera import make_camera
from ..utils.synthetic import build_frozen_scene

SMALL_W, SMALL_H, SMALL_N = 320, 192, 1500


class PairInputs(NamedTuple):
    fields_s: torch.Tensor      # [N, NF] field table in depth order
    lists: binning.PairLists    # pair lists into fields_s
    gdata: torch.Tensor         # [capacity, NF] pair rows
    width: int
    height: int


def small_scene(device: torch.device):
    """Seeded random Gaussians in front of a 320x192 camera, in
    `build_frozen_scene`'s return layout."""
    rng = np.random.default_rng(11)
    n = SMALL_N
    means = np.stack([rng.uniform(-4, 4, n), rng.uniform(-2.5, 2.5, n),
                      rng.uniform(2, 10, n)], -1).astype(np.float32)
    q = rng.standard_normal((n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    host = [means, rng.uniform(0.3, 0.99, n).astype(np.float32),
            rng.uniform(0, 1, (n, 3)).astype(np.float32),
            np.exp(rng.uniform(-3.5, -1.5, (n, 3))).astype(np.float32), q]
    fovx = math.radians(60.0)
    fovy = 2 * math.atan(math.tan(fovx / 2) * SMALL_H / SMALL_W)
    cam = make_camera(R=np.eye(3), T=np.zeros(3), K=None, width=SMALL_W,
                      height=SMALL_H, fovx=fovx, fovy=fovy, device=device)
    return cam, tuple(torch.as_tensor(a, device=device) for a in host), \
        SMALL_H, SMALL_W


def scene(device: torch.device, small: bool):
    return small_scene(device) if small else build_frozen_scene(device)


def sorted_pair_inputs(scene_args, tx: int, ty: int,
                       capacity: int | None = None) -> PairInputs:
    """Depth-sorted fields, pair lists and pair rows at tx x ty tiles; the
    capacity defaults to `suggest_binning_sizes`'s."""
    cam, (means, opac, colors, scales, quats), H, W = scene_args
    fs = primitive_fields(means, opac, camera=cam, colors=colors,
                          scales=scales, rotations=quats, tile_x=tx,
                          tile_y=ty)
    if capacity is None:
        capacity = suggest_binning_sizes(fs, width=W, height=H).capacity
    visible = fs.radii > 0
    order = torch.argsort(torch.where(
        visible, fs.depths, torch.full_like(fs.depths, float("inf"))),
        stable=True)
    lists = binning.build_pair_lists(
        fs.rect_min[order], fs.rect_max[order], visible[order], W, H,
        capacity, tile_x=tx, tile_y=ty)
    if bool(lists.overflowed):
        raise RuntimeError(f"pair capacity {capacity} overflowed at "
                           f"{tx}x{ty}")
    fields_s = fs.fields[order].contiguous()
    src = torch.clamp(lists.pair_src, min=0).long()
    gdata = (fields_s[src] * lists.pair_valid[:, None].to(fields_s.dtype)
             ).contiguous()
    return PairInputs(fields_s, lists, gdata, W, H)
