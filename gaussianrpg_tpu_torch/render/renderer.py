"""Composite scene renderer: scene graph -> rasterizer -> sky -> colour
correction.

Counterpart of `gaussianrpg_tpu/render/renderer.py`: `RenderOptions`,
`RenderResult`, `render_scene` (eval under `torch.no_grad`; train mode
differentiable, with the gradient hooks, the actor flip and the sky ray
jitter drawn from a `torch.Generator`), `render_until_fit`,
`probe_scene_capacity` and `options_from_cfg`.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..models.corrections import apply_color_correction
from ..models.scene_graph import (SceneArrays, SceneMeta, SceneModels,
                                  compose, scene_normals)
from ..models.sky import render_sky
from ..ops.rasterize import (primitive_fields, rasterize,
                             suggest_binning_sizes)
from ..parallel.collectives import Axis
from ..utils.device import resolve_device
from ..utils.spans import span


class RenderResult(NamedTuple):
    rgb: torch.Tensor                  # [3, H, W]
    acc: torch.Tensor                  # [1, H, W]
    depth: torch.Tensor                # [1, H, W]
    semantic: Optional[torch.Tensor]   # [S, H, W] or None
    radii: torch.Tensor                # [N_total]
    visibility: torch.Tensor           # [N_total] bool
    overflow: torch.Tensor             # [] bool: pair capacity exceeded
    n_pairs: torch.Tensor              # [] i32
    normals: Optional[torch.Tensor] = None  # [3, H, W]


@dataclasses.dataclass(frozen=True)
class RenderOptions:
    scaling_modifier: float = 1.0
    white_background: bool = False
    capacity: int = 1 << 19
    clamp_output: bool = True
    render_normals: bool = False
    tile_x: int = 16
    tile_y: int = 16
    sub_chunks: int = 1
    tail_cap: int | None = None
    big_cap: int | None = None
    emit_k: int | None = None
    # primitive (`model`) sharding: the O(N) primitive stage runs on this
    # rank's slice of the axis and the field rows are all-gathered over it
    # before the tile stage (`ops/rasterize.rasterize`; set by
    # `parallel/sharded.render_scene_sharded` on a 2-axis mesh)
    model_axis: Optional[Axis] = None

    def replace(self, **kw) -> "RenderOptions":
        return dataclasses.replace(self, **kw)


def grown(options: RenderOptions) -> RenderOptions:
    """The options with the pair capacity (and explicit tail sizes)
    doubled, after a render flagged overflow."""
    options = options.replace(
        capacity=options.capacity * 2,
        tail_cap=(options.tail_cap * 2
                  if options.tail_cap is not None else None),
        big_cap=(options.big_cap * 2
                 if options.big_cap is not None else None))
    print(f"  pair overflow: growing capacity to {options.capacity}")
    return options


def render_until_fit(render_once, options: RenderOptions):
    """Render, doubling the pair capacity (and explicit tail sizes) while
    the result flags overflow. Returns (result, options) so callers keep
    the grown sizes."""
    res = render_once(options)
    while bool(res.overflow):
        options = grown(options)
        res = render_once(options)
    return res, options


@torch.no_grad()
def probe_scene_capacity(models: SceneModels, meta: SceneMeta,
                         arrays: SceneArrays, cameras, *,
                         active_sh_degree: int, options: RenderOptions,
                         slack: float = 1.2, quantum: int = 65536,
                         max_probes: int = 4) -> RenderOptions:
    """Right-size the binning sizes from the primitive stage and exact
    aligned pair counts on up to `max_probes` cameras."""
    if not cameras:
        return options
    step = max(1, len(cameras) // max_probes)
    cap, tail, big, ek = 0, None, None, None
    for cam in list(cameras)[::step][:max_probes]:
        scene = compose(models, meta, arrays, cam, active_sh_degree)
        fs = primitive_fields(
            scene.means3d, scene.opacity, camera=cam, colors=scene.colors,
            scales=scene.scales, rotations=scene.rotations,
            scale_modifier=options.scaling_modifier, active_mask=scene.mask,
            tile_x=options.tile_x, tile_y=options.tile_y)
        c, t, b, k = suggest_binning_sizes(
            fs, width=cam.width, height=cam.height, slack=slack,
            sub_chunks=options.sub_chunks, quantum=quantum)
        cap = max(cap, c)
        if t is not None:
            tail = max(tail or 0, t)
            big = max(big or 0, b)
            ek = k if ek is None else max(ek, k)
    return options.replace(capacity=cap, tail_cap=tail, big_cap=big,
                           emit_k=ek)


def options_from_cfg(render_cfg, **overrides) -> RenderOptions:
    """RenderOptions from a config's `render` block (capacity and tiling)."""
    kw = dict(
        capacity=render_cfg.capacity,
        tile_x=int(render_cfg.get("tile_x", 16)),
        tile_y=int(render_cfg.get("tile_y", 16)),
        sub_chunks=int(render_cfg.get("sub_chunks", 1)),
    )
    kw.update(overrides)
    return RenderOptions(**kw)


def render_scene(models: SceneModels, meta: SceneMeta, arrays: SceneArrays,
                 camera, *, active_sh_degree: int,
                 options: RenderOptions = RenderOptions(),
                 include_background: bool = True,
                 include_objects: bool = True, train_mode: bool = False,
                 generator: torch.Generator | None = None,
                 means2d_offset: torch.Tensor | None = None,
                 absgrad_sink: torch.Tensor | None = None,
                 device=None) -> RenderResult:
    """Render one camera. The scene and camera must lie on `device` (CUDA
    unless given). Eval runs without autograd; for training pass
    `train_mode=True`, a `generator` (actor flip, then sky ray jitter) and
    zeros `means2d_offset` [N_total, 2] / `absgrad_sink` [N_total], whose
    gradients are the densification statistics."""
    if train_mode:
        return _render(models, meta, arrays, camera, active_sh_degree,
                       options, include_background, include_objects, True,
                       generator, means2d_offset, absgrad_sink, device)
    with torch.no_grad():
        return _render(models, meta, arrays, camera, active_sh_degree,
                       options, include_background, include_objects, False,
                       None, None, None, device)


def _render(models, meta, arrays, camera, active_sh_degree, options,
            include_background, include_objects, train_mode, generator,
            means2d_offset, absgrad_sink, device) -> RenderResult:
    dev = resolve_device(device)
    scene = compose(models, meta, arrays, camera, active_sh_degree,
                    flip=generator, include_background=include_background,
                    include_objects=include_objects, train_mode=train_mode)
    bg = (torch.ones(3, device=dev) if options.white_background
          else torch.zeros(3, device=dev))
    features = scene.semantics
    n_normal_ch = 0
    if options.render_normals:
        normals = scene_normals(scene, camera.cam_center)
        n_normal_ch = 3
        features = (normals if features is None
                    else torch.cat([normals, features], dim=-1))

    with span("scene.rasterize"):
        out = rasterize(
            scene.means3d, scene.opacity, camera=camera, bg_color=bg,
            colors=scene.colors, scales=scene.scales,
            rotations=scene.rotations,
            semantics=features, scale_modifier=options.scaling_modifier,
            means2d_offset=means2d_offset, absgrad_sink=absgrad_sink,
            active_mask=scene.mask, capacity=options.capacity,
            tile_x=options.tile_x, tile_y=options.tile_y,
            sub_chunks=options.sub_chunks, tail_cap=options.tail_cap,
            big_cap=options.big_cap, emit_k=options.emit_k,
            model_axis=options.model_axis, device=dev)

    rgb = out.color
    acc = out.alpha
    if meta.include_sky and models.sky is not None:
        with span("scene.sky"):
            sky = render_sky(models.sky, camera,
                             generator if train_mode else None)
            rgb = rgb + sky * (1.0 - acc.detach())
    if meta.use_color_correction and models.color_correction is not None:
        rgb = apply_color_correction(models.color_correction, camera, rgb)
    if options.clamp_output and not train_mode:
        rgb = torch.clamp(rgb, 0.0, 1.0)

    rendered_normals = None
    sem_planes = out.semantic
    if n_normal_ch:
        raw_n = sem_planes[:3]
        rendered_normals = raw_n / torch.clamp(
            torch.linalg.norm(raw_n, dim=0, keepdim=True), min=1e-12)
        sem_planes = sem_planes[3:]
    return RenderResult(
        rgb=rgb, acc=acc, depth=out.depth,
        semantic=sem_planes if scene.semantics is not None else None,
        radii=out.radii, visibility=out.radii > 0, overflow=out.overflow,
        n_pairs=out.n_pairs, normals=rendered_normals)
