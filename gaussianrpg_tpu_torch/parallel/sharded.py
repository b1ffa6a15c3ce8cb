"""Multi-device rendering and training: tile strips over a mesh's `data`
axis, primitive shards over its `model` axis.

Counterpart of `gaussianrpg_tpu/parallel/sharded.py`. The JAX layer is
single-controller: one process drives every device through `shard_map`,
and autodiff transposes its specs into collectives. The port is SPMD: every
rank runs this code on its own device (`parallel/distributed.initialize`),
and each of those transposes is an explicit collective
(`parallel/collectives.py`):

| JAX (implicit)                      | here                               |
|-------------------------------------|------------------------------------|
| `in_specs=P("data")` strip cameras  | each rank builds its own strip     |
|                                     | camera (`strip_cameras`)           |
| `out_specs=P("data")` planes        | `GatherStrips`: all-gather over    |
|                                     | `data`; backward keeps this rank's |
|                                     | rows of the cotangent (each rank   |
|                                     | computes the same loss on the same |
|                                     | global planes, so its cotangent is |
|                                     | complete), times 1 / n_model       |
| psum of replicated inputs'          | `_SumGrads`: identity forward, one |
| cotangents                          | all-reduce (SUM, whole mesh) of    |
|                                     | all their cotangents in backward   |
| tiled `all_gather` over `model`     | `_GatherShards`: all-gather;       |
|                                     | backward reduce-scatter (SUM)      |
| `pmax` of radii, overflow, pairs    | all-reduce (MAX) over `data`       |

The 1 / n_model is what JAX's transpose does to an output replicated over
`model`: the `model` ranks of one strip hold the same planes, and the
whole-mesh sum would otherwise count that strip's parameters used after
the `model` gather (sky, colour correction) n_model times; the
reduce-scatter sums the n_model equal copies of the Gaussians' field
cotangents back to one.

The meshes (`make_mesh`, `make_mesh_2d`: a thin class over per-axis
process groups) come from there too, as does the gloo groups' staging of
CUDA tensors through host memory.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist

from ..render.camera import Camera, projection_matrix_from_K
from .collectives import (Axis, GatherStrips, Mesh, all_reduce_,
                          gather_field_rows, make_mesh, make_mesh_2d,
                          replicated)

__all__ = ["Axis", "Mesh", "make_mesh", "make_mesh_2d", "strip_cameras",
           "render_strips", "render_scene_sharded",
           "value_and_grad_psum_overlapped", "render_sharded_2d"]


def _strip_axes(mesh: Mesh):
    """(data axis, n_model) of a 1-axis or ("data", "model") mesh."""
    if len(mesh.axis_names) == 1:
        return mesh.axis(mesh.axis_names[0]), 1
    if mesh.axis_names != ("data", "model"):
        raise ValueError(f"mesh axes {mesh.axis_names}")
    return mesh.axis("data"), mesh.axis("model").size


# ------------------------------------------------------------ strips

def strip_cameras(camera: Camera, n_strips: int) -> list:
    """The n_strips strip cameras of `camera`: strip d renders rows
    [d * h, (d + 1) * h) with h = ceil(H / n / 16) * 16 (whole tiles; the
    last strip extends past H). Each keeps the view matrix, pose, ids and
    timestamp, shifts the principal point (cy - d * h) and rebuilds the
    projection from K at height h (float64 host math, then float32). The
    physical camera's FOV tangents (`lim_tan_fov*`, the EWA clamp) and
    size (`full_width`/`full_height`, the gradient statistics' NDC scale)
    stay the full camera's."""
    H, W = camera.height, camera.width
    strip_h = int(math.ceil(H / n_strips / 16.0) * 16)
    K = camera.K.detach().cpu().numpy().astype(np.float32)
    V = camera.viewmatrix.detach().cpu().numpy()
    dev = camera.viewmatrix.device
    # focal_y is kept: the strip's tan_fovy follows from its height
    tan_fovy = float(strip_h / (2.0 * K[1, 1]))
    out = []
    for d in range(n_strips):
        Kd = K.copy()
        Kd[1, 2] = K[1, 2] - d * strip_h
        P = projection_matrix_from_K(Kd, strip_h, W).astype(np.float64)
        proj = (P @ V.astype(np.float64)).astype(np.float32)
        out.append(camera.replace(
            projmatrix=torch.as_tensor(proj, device=dev),
            K=torch.as_tensor(Kd, device=dev), height=strip_h,
            tan_fovy=tan_fovy,
            lim_tan_fovx=camera.lim_tan_fovx or camera.tan_fovx,
            lim_tan_fovy=camera.lim_tan_fovy or camera.tan_fovy,
            full_width=camera.full_width or W,
            full_height=camera.full_height or H))
    return out


def _gather_planes(planes, camera, data: Axis, n_model: int):
    """Global [C, H, W] planes from this rank's strip."""
    full = GatherStrips.apply(planes, data, 1.0 / n_model)
    return full[:, :camera.height]


def render_strips(render_fn, camera: Camera, mesh: Mesh, *replicated_args):
    """`render_fn(strip_camera, *args) -> [C, strip_h, W]` on this rank's
    strip of a 1-axis mesh; returns the assembled [C, H, W] image on every
    rank. Gradients of `replicated_args` are summed over the mesh."""
    if len(mesh.axis_names) != 1:
        raise ValueError("render_strips takes a 1-axis mesh")
    data = mesh.axis(mesh.axis_names[0])
    cam = strip_cameras(camera, data.size)[data.index]
    args = replicated(mesh.group, list(replicated_args))
    return _gather_planes(render_fn(cam, *args), camera, data, 1)


def render_scene_sharded(models, meta, arrays, camera: Camera, mesh: Mesh,
                         *, active_sh_degree: int, options,
                         include_background: bool = True,
                         include_objects: bool = True,
                         train_mode: bool = False,
                         generator: torch.Generator | None = None,
                         means2d_offset: torch.Tensor | None = None,
                         absgrad_sink: torch.Tensor | None = None,
                         device=None):
    """The production composite render (`render.renderer.render_scene`:
    scene graph, sky, corrections, gradient hooks) under a 1-axis or
    ("data", "model") mesh. Parameters are replicated: each rank renders
    its strip (on a 2-axis mesh, with its Gaussian shard's primitive
    stage, `RenderOptions.model_axis`), and under autograd the gradients
    of every model tensor and hook that requires grad are summed over the
    mesh. Returns a RenderResult with global [C, H, W] planes; radii,
    overflow and pair count are the maxima over the strips, so radii equal
    the single-device ones except for Gaussians that touch only the last
    strip's padding rows. `generator` must be in the same state on every
    rank (the same actor flips; the sky jitter repeats per strip)."""
    from ..render.renderer import RenderResult, render_scene

    data, n_model = _strip_axes(mesh)
    if n_model > 1:
        options = options.replace(model_axis=mesh.axis("model"))
    cam = strip_cameras(camera, data.size)[data.index]
    models, means2d_offset, absgrad_sink = replicated(
        mesh.group, [models, means2d_offset, absgrad_sink])
    res = render_scene(models, meta, arrays, cam,
                       active_sh_degree=active_sh_degree, options=options,
                       include_background=include_background,
                       include_objects=include_objects,
                       train_mode=train_mode, generator=generator,
                       means2d_offset=means2d_offset,
                       absgrad_sink=absgrad_sink, device=device)
    parts = [res.rgb, res.acc, res.depth]
    if res.normals is not None:
        parts.append(res.normals)
    if res.semantic is not None:
        parts.append(res.semantic)
    planes = _gather_planes(torch.cat(parts, dim=0), camera, data, n_model)
    # one MAX over the strips for radii, overflow and pair count
    stats = torch.cat([res.radii.to(torch.int32),
                       res.overflow.to(torch.int32).reshape(1),
                       res.n_pairs.to(torch.int32).reshape(1)])
    all_reduce_(stats, data.group, op=dist.ReduceOp.MAX)
    radii = stats[:-2]
    off = 5
    normals = semantic = None
    if res.normals is not None:
        normals = planes[off:off + 3]
        off += 3
    if res.semantic is not None:
        semantic = planes[off:]
    return RenderResult(
        rgb=planes[0:3], acc=planes[3:4], depth=planes[4:5],
        semantic=semantic, radii=radii, visibility=radii > 0,
        overflow=stats[-2] > 0, n_pairs=stats[-1], normals=normals)


def value_and_grad_psum_overlapped(render_fn, camera: Camera, mesh: Mesh,
                                   loss_fn, n_sub: int, *replicated_args,
                                   explicit_psum: bool = True):
    """Strip-parallel loss and gradients with one all-reduce per
    sub-strip. Each rank's strip is split into `n_sub` sub-strips; after
    sub-strip k's backward, its gradients enter an asynchronous all-reduce
    before sub-strip k+1 is rendered, and every handle is waited on at the
    end, so the collectives of early sub-strips can run while later ones
    compute (on NCCL, which runs them on its own stream; on gloo the
    staging copies are synchronous). `loss_fn(planes) -> scalar` must be a
    sum over pixels (it is applied per sub-strip). Returns (total loss,
    gradients w.r.t. `replicated_args`), both the same on every rank.
    `explicit_psum=False` runs one all-reduce at the end instead (the
    reference for the equivalence test). A 2-axis mesh is refused: it
    would shard the sub-strip stack over both axes and drop strips."""
    if len(mesh.axis_names) != 1:
        raise ValueError("value_and_grad_psum_overlapped expects a 1-axis "
                         "mesh; a 2-axis mesh would drop strips from the "
                         "loss")
    data = mesh.axis(mesh.axis_names[0])
    strips = strip_cameras(camera, data.size * n_sub)
    args = [a.detach().requires_grad_(True) for a in replicated_args]
    total = None
    partials = []
    for k in range(n_sub):
        lk = loss_fn(render_fn(strips[data.index * n_sub + k], *args))
        gk = torch.autograd.grad(lk, args, allow_unused=True)
        flat = torch.cat([(torch.zeros_like(a) if g is None else g)
                          .reshape(-1) for a, g in zip(args, gk)])
        # explicit: this sub-strip's collective, issued before the next
        # sub-strip is rendered
        partials.append(all_reduce_(flat, mesh.group, async_op=True)
                        if explicit_psum else flat)
        total = lk.detach() if total is None else total + lk.detach()
    if explicit_psum:
        flat = sum(p.wait() for p in partials)
    else:
        flat = all_reduce_(sum(partials), mesh.group)
    all_reduce_(total, mesh.group)
    parts = flat.split([a.numel() for a in args])
    return total, tuple(p.view(a.shape) for p, a in zip(parts, args))


def render_sharded_2d(fields_fn, camera: Camera, mesh: Mesh, *sharded_args,
                      capacity: int = 1 << 16, bg_color=None,
                      train_mode: bool = False):
    """Two-axis render on a ("data", "model") mesh: `data` shards the
    image into tile strips, `model` the primitives. Each rank runs
    `fields_fn(strip_camera, *local_args) -> FieldSet` on its `model`
    slice of `sharded_args` (each with a leading axis divisible by the
    `model` size), the field rows are all-gathered in rank order before
    the tile stage (`blend_fields`) runs on the full set for the strip.
    Under autograd the gather's backward is a reduce-scatter, and the
    args' gradients are summed over the mesh. Returns [C, H, W]
    (colour, depth, alpha) on every rank."""
    from ..ops.rasterize import blend_fields

    data, model = mesh.axis("data"), mesh.axis("model")
    cam = strip_cameras(camera, data.size)[data.index]
    local = []
    for a in replicated(mesh.group, list(sharded_args)):
        n = a.shape[0] // model.size
        local.append(a[model.index * n:(model.index + 1) * n])
    fs = gather_field_rows(fields_fn(cam, *local), model)
    bg = (torch.zeros(3, device=cam.device) if bg_color is None
          else bg_color)
    out = blend_fields(fs, width=camera.width, height=cam.height,
                       bg_color=bg, capacity=capacity,
                       train_mode=train_mode)
    planes = torch.cat([out.color, out.depth, out.alpha], dim=0)
    return _gather_planes(planes, camera, data, model.size)
