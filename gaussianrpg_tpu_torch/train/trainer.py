"""Training step of the composite scene: render forward + backward, every
loss term, Adam, densification statistics.

Counterpart of `gaussianrpg_tpu/train/trainer.py`. The JAX step is one
jitted function; here it is eager PyTorch: the learnables become leaf
tensors, one `torch.autograd.grad` gives their gradients and those of the
two hooks (the densification statistics), and the new state is built out
of place, so a step that overflowed the pair capacity is simply not
applied: the step reads the overflow flag (one host sync) before the
backward and returns the state unchanged when it is set.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..models import gaussians as G
from ..models.corrections import (color_correction_reg_loss,
                                  pose_correction_reg_loss)
from ..models.scene_graph import (SceneArrays, SceneMeta, SceneModels,
                                  actor_extents)
from ..ops.math3d import exp_lr_schedule, l1_abs
from ..parallel.sharded import render_scene_sharded
from ..render.renderer import RenderOptions, render_scene
from ..utils.tree import tree_leaves, tree_map, tree_unflatten
from . import losses as L


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    """Learning rates, loss weights and the densification schedule
    (defaults of the JAX package's `OptimConfig`)."""

    position_lr_init: float = 1.6e-4
    position_lr_final: float = 1.6e-6
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30000
    feature_lr: float = 2.5e-3
    opacity_lr: float = 0.05
    scaling_lr: float = 5e-3
    rotation_lr: float = 1e-3
    semantic_lr: float = 1e-3
    track_position_lr: float = 5e-4
    track_rotation_lr: float = 1e-4
    sky_lr: float = 1e-2
    color_correction_lr: float = 5e-4
    pose_correction_lr: float = 5e-6
    spatial_lr_scale: float = 1.0
    # per-object overrides (None: the global value)
    position_lr_init_obj: Optional[float] = None
    position_lr_final_obj: Optional[float] = None
    feature_lr_obj: Optional[float] = None
    feature_rest_lr_obj: Optional[float] = None
    scaling_lr_obj: Optional[float] = None
    rotation_lr_obj: Optional[float] = None
    opacity_lr_obj: Optional[float] = None
    semantic_lr_obj: Optional[float] = None

    lambda_l1: float = 1.0
    lambda_dssim: float = 0.2
    lambda_sky: float = 0.0
    lambda_sky_scale: tuple = ()
    lambda_semantic: float = 0.0
    lambda_depth_lidar: float = 0.0
    lambda_color_correction: float = 0.0
    lambda_pose_correction: float = 0.0
    lambda_scale_flatten: float = 0.0
    lambda_opacity_sparse: float = 0.0
    lambda_reg: float = 0.0
    lambda_normal_mono: float = 0.0

    densify_from_iter: int = 500
    densify_until_iter: int = 15000
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_grad_threshold: float = 2e-4
    densify_grad_abs_bkgd: bool = False
    densify_grad_threshold_obj: Optional[float] = None
    densify_grad_abs_obj: bool = False
    min_opacity: float = 0.005
    percent_dense: float = 0.01
    percent_big_ws: float = 0.1


class Batch(NamedTuple):
    """One training view (tensors on the training device)."""

    gt_image: torch.Tensor                 # [3, H, W]
    mask: Optional[torch.Tensor] = None    # [1, H, W] bool
    sky_mask: Optional[torch.Tensor] = None
    lidar_depth: Optional[torch.Tensor] = None
    gt_semantic: Optional[torch.Tensor] = None  # [1, H, W] int, -1 ignore
    obj_bound: Optional[torch.Tensor] = None    # [1, H, W] bool
    mono_normal: Optional[torch.Tensor] = None  # [3, H, W] camera space
    sky_scale: Optional[torch.Tensor] = None    # [] per-camera sky weight


@dataclasses.dataclass
class TrainState:
    models: SceneModels
    adam: G.AdamState      # over the whole learnable tree
    step: int

    def replace(self, **kw) -> "TrainState":
        return dataclasses.replace(self, **kw)


def _learnables(models: SceneModels) -> dict:
    """The trainable sub-tree of SceneModels (statistics excluded)."""
    out = dict(background=models.background)
    if models.actors is not None:
        out["actors"] = models.actors
    if models.sky_gauss is not None:
        out["sky_gauss"] = models.sky_gauss
    if models.actor_pose is not None and models.actor_pose.opt_track:
        out["actor_pose"] = dict(opt_trans=models.actor_pose.opt_trans,
                                 opt_rots=models.actor_pose.opt_rots)
    if models.sky is not None:
        out["sky"] = models.sky.cube_map
    if models.color_correction is not None:
        out["color_correction"] = dict(
            affine=models.color_correction.affine,
            affine_sky=models.color_correction.affine_sky)
    if models.pose_correction is not None:
        out["pose_correction"] = dict(trans=models.pose_correction.trans,
                                      rots=models.pose_correction.rots)
    return out


def _with_learnables(models: SceneModels, lrn: dict) -> SceneModels:
    models = models.replace(background=lrn["background"])
    if "actors" in lrn:
        models = models.replace(actors=lrn["actors"])
    if "sky_gauss" in lrn:
        models = models.replace(sky_gauss=lrn["sky_gauss"])
    if "actor_pose" in lrn:
        models = models.replace(actor_pose=models.actor_pose.replace(
            opt_trans=lrn["actor_pose"]["opt_trans"],
            opt_rots=lrn["actor_pose"]["opt_rots"]))
    if "sky" in lrn:
        models = models.replace(sky=models.sky.replace(cube_map=lrn["sky"]))
    if "color_correction" in lrn:
        models = models.replace(
            color_correction=models.color_correction.replace(
                affine=lrn["color_correction"]["affine"],
                affine_sky=lrn["color_correction"]["affine_sky"]))
    if "pose_correction" in lrn:
        models = models.replace(
            pose_correction=models.pose_correction.replace(
                trans=lrn["pose_correction"]["trans"],
                rots=lrn["pose_correction"]["rots"]))
    return models


def _lr_tree(lrn: dict, cfg: OptimConfig, step: int, actor_extent=None,
             sky_spatial=None) -> dict:
    """Per-leaf learning rates: the per-group Adam rates with the log-lerp
    xyz schedule; actors use the `_obj` overrides and their bbox extent."""
    def schedule(lr_init, lr_final):
        return exp_lr_schedule(lr_init, lr_final, cfg.position_lr_max_steps,
                               lr_delay_mult=cfg.position_lr_delay_mult,
                               lr_delay_steps=0)(step)

    xyz_lr = schedule(cfg.position_lr_init * cfg.spatial_lr_scale,
                      cfg.position_lr_final * cfg.spatial_lr_scale)

    def gauss_lrs(xyz):
        return G.GaussianParams(
            xyz=xyz, features_dc=cfg.feature_lr,
            features_rest=cfg.feature_lr / 20.0, scaling=cfg.scaling_lr,
            rotation=cfg.rotation_lr, opacity=cfg.opacity_lr,
            semantic=cfg.semantic_lr)

    def ov(o, d):
        return d if o is None else o

    spatial = (actor_extent[:, None, None] if actor_extent is not None
               else cfg.spatial_lr_scale)
    f_lr = ov(cfg.feature_lr_obj, cfg.feature_lr)
    actor_xyz = schedule(ov(cfg.position_lr_init_obj, cfg.position_lr_init),
                         ov(cfg.position_lr_final_obj,
                            cfg.position_lr_final)) * spatial
    out = dict(background=gauss_lrs(xyz_lr))
    if "actors" in lrn:
        out["actors"] = G.GaussianParams(
            xyz=actor_xyz, features_dc=f_lr,
            features_rest=ov(cfg.feature_rest_lr_obj, f_lr / 20.0),
            scaling=ov(cfg.scaling_lr_obj, cfg.scaling_lr),
            rotation=ov(cfg.rotation_lr_obj, cfg.rotation_lr),
            opacity=ov(cfg.opacity_lr_obj, cfg.opacity_lr),
            semantic=ov(cfg.semantic_lr_obj, cfg.semantic_lr))
    if "sky_gauss" in lrn:
        out["sky_gauss"] = gauss_lrs(schedule(
            cfg.position_lr_init, cfg.position_lr_final) * (
                sky_spatial if sky_spatial is not None
                else cfg.spatial_lr_scale))
    if "actor_pose" in lrn:
        out["actor_pose"] = dict(opt_trans=cfg.track_position_lr,
                                 opt_rots=cfg.track_rotation_lr)
    if "sky" in lrn:
        out["sky"] = cfg.sky_lr
    if "color_correction" in lrn:
        out["color_correction"] = tree_map(lambda _: cfg.color_correction_lr,
                                           lrn["color_correction"])
    if "pose_correction" in lrn:
        out["pose_correction"] = dict(trans=cfg.pose_correction_lr,
                                      rots=cfg.pose_correction_lr)
    return out


def compute_losses(result, batch: Batch, models: SceneModels,
                   meta: SceneMeta, cfg: OptimConfig, visibility,
                   scene_opacity, camera=None):
    """The training loss and its named terms (every term of the JAX
    package's `compute_losses`)."""
    scalars = {}
    mask = batch.mask
    l1 = L.l1_loss(result.rgb, batch.gt_image, mask)
    dssim = 1.0 - L.ssim(result.rgb, batch.gt_image)
    loss = (1.0 - cfg.lambda_dssim) * cfg.lambda_l1 * l1 \
        + cfg.lambda_dssim * dssim
    scalars["l1"] = l1
    scalars["dssim"] = dssim

    if cfg.lambda_sky > 0 and batch.sky_mask is not None:
        acc = torch.clamp(result.acc, 1e-6, 1 - 1e-6)
        sky_loss = torch.where(batch.sky_mask, -torch.log(1 - acc),
                               -torch.log(acc)).mean()
        if batch.sky_scale is not None:
            sky_loss = sky_loss * batch.sky_scale
        loss = loss + cfg.lambda_sky * sky_loss
        scalars["sky"] = sky_loss

    if (cfg.lambda_semantic > 0 and batch.gt_semantic is not None
            and result.semantic is not None):
        logits = result.semantic.permute(1, 2, 0)           # [H, W, S]
        tgt = batch.gt_semantic[0]
        valid = tgt >= 0
        logp = torch.log_softmax(logits, dim=-1)
        ce = -torch.gather(logp, -1, torch.clamp(tgt, min=0).long()[..., None]
                           )[..., 0]
        sem_loss = torch.sum(ce * valid) / torch.clamp(valid.sum(), min=1)
        loss = loss + cfg.lambda_semantic * sem_loss
        scalars["semantic"] = sem_loss

    if cfg.lambda_depth_lidar > 0 and batch.lidar_depth is not None:
        dmask = batch.lidar_depth > 0
        if mask is not None:
            dmask = dmask & mask
        expected = result.depth / (result.acc + 1e-10)
        err = l1_abs(expected - batch.lidar_depth)
        # 95%-trimmed mean: any masked pixel makes the quantile NaN and
        # the trim a no-op, as jnp.percentile does in the JAX package
        q95 = torch.quantile(torch.where(
            dmask, err, torch.full_like(err, float("nan"))).detach()
            .flatten(), 0.95)
        q95 = torch.nan_to_num(q95, nan=float("inf"))
        keep = dmask & (err <= q95)
        trimmed = torch.where(keep, err, torch.zeros_like(err))
        d_loss = torch.sum(trimmed) / torch.clamp(torch.sum(keep), min=1)
        loss = loss + cfg.lambda_depth_lidar * d_loss
        scalars["lidar_depth"] = d_loss

    if (cfg.lambda_color_correction > 0
            and models.color_correction is not None and camera is not None):
        cc = color_correction_reg_loss(models.color_correction, camera)
        loss = loss + cfg.lambda_color_correction * cc
        scalars["cc_reg"] = cc

    if cfg.lambda_pose_correction > 0 and models.pose_correction is not None:
        pc = pose_correction_reg_loss(models.pose_correction)
        loss = loss + cfg.lambda_pose_correction * pc
        scalars["pc_reg"] = pc

    if cfg.lambda_scale_flatten > 0:
        s = torch.sort(torch.exp(models.background.scaling), dim=1).values
        s1 = torch.clamp(s[:, 0], 0, 30)
        s2 = torch.clamp(s[:, 1], 1e-5, 30)
        s3 = torch.clamp(s[:, 2], 1e-5, 30)
        flat = l1_abs(s1).mean() + l1_abs(s2 / s3 + s3 / s2 - 2.0).mean()
        loss = loss + cfg.lambda_scale_flatten * flat
        scalars["scale_flatten"] = flat

    if cfg.lambda_opacity_sparse > 0:
        op = torch.clamp(scene_opacity, 1e-6, 1 - 1e-6)
        ent = -(op * torch.log(op) + (1 - op) * torch.log(1 - op))
        vis = visibility.to(torch.float32)
        sparse = torch.sum(ent * vis) / torch.clamp(vis.sum(), min=1)
        loss = loss + cfg.lambda_opacity_sparse * sparse
        scalars["opacity_sparse"] = sparse

    if (cfg.lambda_normal_mono > 0 and batch.mono_normal is not None
            and result.normals is not None and camera is not None):
        nmask = (torch.ones(result.normals.shape[1:], dtype=torch.bool,
                            device=result.normals.device)
                 if mask is None else mask[0])
        if batch.sky_mask is not None:
            nmask = nmask & (~batch.sky_mask[0])
        rows = torch.arange(nmask.shape[0], device=nmask.device)[:, None]
        nmask = nmask & (rows >= 50)
        r_c2w = camera.viewmatrix[:3, :3].T
        n_gt = torch.einsum("ij,jhw->ihw", r_c2w, batch.mono_normal)
        diff = l1_abs(result.normals - n_gt)
        cosd = 1.0 - torch.sum(result.normals * n_gt, dim=0)
        cnt = torch.clamp(torch.sum(nmask), min=1)
        n_l1 = torch.sum(torch.where(nmask[None], diff,
                                     torch.zeros_like(diff))) / (3 * cnt)
        n_cos = torch.sum(torch.where(nmask, cosd,
                                      torch.zeros_like(cosd))) / cnt
        loss = loss + cfg.lambda_normal_mono * (n_l1 + n_cos)
        scalars["normal_l1"] = n_l1
        scalars["normal_cos"] = n_cos

    scalars["total"] = loss
    return loss, scalars


def _clone_generator(gen: torch.Generator | None):
    """A generator in `gen`'s current state (the objects-only pass draws
    the same flip and jitter as the main pass, as the JAX step reuses its
    key)."""
    if gen is None:
        return None
    twin = torch.Generator(device=gen.device)
    twin.set_state(gen.get_state())
    return twin


def make_train_step(meta: SceneMeta, arrays: SceneArrays, cfg: OptimConfig,
                    options: RenderOptions, n_total: int, device=None,
                    mesh=None):
    """The train step for one scene configuration:
    train_step(state, camera, batch, generator, active_sh_degree) ->
    (new_state, loss, scalars, result). `generator` draws the actor flip
    and the sky ray jitter. A step whose render overflowed the pair
    capacity returns `state` itself (scalars["overflow"] is True).

    `mesh` (a 1-axis or ("data", "model") `parallel.sharded.Mesh`; every
    rank of it calls the step with the same state, camera, batch and
    generator state) runs the same step with the render tile-strip-sharded
    over the mesh (`parallel.sharded.render_scene_sharded`). Every rank
    computes the loss on the global planes; the gradients of every
    learnable leaf and of the two hooks that flow through the render are
    summed over the whole mesh in one all-reduce, where they leave it (the
    JAX package's psum of replicated inputs), and the loss's direct terms
    (the regularizers) add theirs once on every rank. Adam, the statistics
    and the caller's densify and prune then see the same numbers on every
    rank, so the parameters stay replicated."""

    def render(models, camera, generator, off, sink, active_sh_degree,
               include_background=True):
        kw = dict(active_sh_degree=active_sh_degree, options=options,
                  include_background=include_background, train_mode=True,
                  generator=generator, means2d_offset=off,
                  absgrad_sink=sink, device=device)
        if mesh is None:
            return render_scene(models, meta, arrays, camera, **kw)
        return render_scene_sharded(models, meta, arrays, camera, mesh, **kw)

    def train_step(state: TrainState, camera, batch: Batch,
                   generator: torch.Generator | None, active_sh_degree: int):
        dev = state.models.background.xyz.device
        lrn = _learnables(state.models)
        leaves = [x.detach().requires_grad_(True) for x in tree_leaves(lrn)]
        lrn_g = tree_unflatten(lrn, leaves)
        a_ext = actor_extents(arrays, meta.box_scale)
        off = torch.zeros((n_total, 2), device=dev, requires_grad=True)
        sink = torch.zeros((n_total,), device=dev, requires_grad=True)
        models = _with_learnables(state.models, lrn_g)
        obj_gen = _clone_generator(generator)
        res = render(models, camera, generator, off, sink, active_sh_degree)
        op_parts = [models.background.opacity[:, 0]]
        if models.actors is not None:
            op_parts.append(models.actors.opacity[..., 0].reshape(-1))
        if models.sky_gauss is not None:
            op_parts.append(models.sky_gauss.opacity[:, 0])
        scene_op = torch.sigmoid(torch.cat(op_parts)).detach()
        loss, scalars = compute_losses(res, batch, models, meta, cfg,
                                       res.visibility, scene_op,
                                       camera=camera)

        if cfg.lambda_reg > 0 and meta.num_actors > 0:
            # the objects-only pass, through the training rasterizer (zero
            # hooks, one row per actor slot, whose gradients are not used)
            n_obj = models.actors.xyz.shape[0] * models.actors.xyz.shape[1]
            res_obj = render(models, camera, obj_gen,
                             torch.zeros((n_obj, 2), device=dev),
                             torch.zeros((n_obj,), device=dev),
                             active_sh_degree, include_background=False)
            acc_obj = torch.clamp(res_obj.acc, 1e-6, 1 - 1e-6)
            ent = -(acc_obj * torch.log(acc_obj)
                    + (1 - acc_obj) * torch.log(1 - acc_obj))
            outside = -torch.log(1 - acc_obj)
            ob = (batch.obj_bound if batch.obj_bound is not None
                  else torch.zeros_like(acc_obj, dtype=torch.bool))
            obj_acc = torch.where(ob, ent, outside).mean()
            gate = float(state.step + 1 >= cfg.densify_until_iter)
            loss = loss + cfg.lambda_reg * gate * obj_acc
            scalars["obj_acc"] = obj_acc
            o_cnt = models.actors.xyz.shape[0]
            box_reg = torch.stack([G.box_reg_loss(
                _index(models.actors, o), _index(state.models.actors_aux, o),
                a_ext[o], cfg.percent_dense) for o in range(o_cnt)]).mean()
            loss = loss + cfg.lambda_reg * box_reg
            scalars["box_reg"] = box_reg

        scalars["overflow"] = bool(res.overflow)
        scalars["n_pairs"] = res.n_pairs
        if scalars["overflow"]:
            return state, loss.detach(), _detached(scalars), _detached(res)

        grads = torch.autograd.grad(loss, leaves + [off, sink],
                                    allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(leaves + [off, sink], grads)]
        g_lrn = tree_unflatten(lrn, grads[:len(leaves)])
        g_off, g_sink = grads[len(leaves):]
        with torch.no_grad():
            lrs = _lr_tree(lrn, cfg, state.step, actor_extent=a_ext,
                           sky_spatial=arrays.sphere_radius)
            new_lrn, new_adam = G.adam_update(
                tree_map(torch.Tensor.detach, lrn), g_lrn, state.adam, lrs)
            new_models = _with_learnables(state.models, new_lrn)
            bcap = state.models.background.capacity
            vis = res.visibility
            new_models = new_models.replace(
                bkgd_aux=G.add_densification_stats(
                    state.models.bkgd_aux, g_off[:bcap], g_sink[:bcap],
                    res.radii[:bcap], vis[:bcap]))
            if meta.num_actors > 0:
                o_cnt, a_cap = state.models.actors.xyz.shape[:2]

                def sl(x):
                    return x[bcap:bcap + o_cnt * a_cap].reshape(
                        (o_cnt, a_cap) + tuple(x.shape[1:]))

                new_models = new_models.replace(
                    actors_aux=G.add_densification_stats(
                        state.models.actors_aux, sl(g_off), sl(g_sink),
                        sl(res.radii), sl(vis)))
        return (TrainState(models=new_models, adam=new_adam,
                           step=state.step + 1),
                loss.detach(), _detached(scalars), _detached(res))

    return train_step


def _detached(x):
    """A RenderResult or scalar dict with its tensors out of the graph."""
    if isinstance(x, dict):
        return {k: (v.detach() if torch.is_tensor(v) else v)
                for k, v in x.items()}
    return x._replace(**{k: v.detach() for k, v in x._asdict().items()
                         if torch.is_tensor(v)})


def _index(tree, o: int):
    """Sub-model `o` of a stacked actor container."""
    return type(tree)(**{f.name: getattr(tree, f.name)[o]
                         for f in dataclasses.fields(tree)})


def init_train_state(models: SceneModels) -> TrainState:
    return TrainState(models=models, adam=G.adam_init(_learnables(models)),
                      step=0)
