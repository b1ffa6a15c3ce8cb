"""Assemble a composite SceneModels from a loaded Waymo scene — the
`Scene` wrapper role (`lib/models/scene.py:10-64` +
`street_gaussian_model.setup_functions:161-216`).

Counterpart of `gaussianrpg_tpu/models/scene_builder.py`: the same numpy
draws (generators and seeds) for the random actor grid, the fallback
background shell and the sky shell, and the initial scales from the port's
Morton-order KNN (`ops/knn.py`, which follows the JAX package's ties and
float32 rounding). The scene is built on the caller's device. A colour
correction MLP is initialized from a torch generator (the JAX package
draws it from a JAX key), so only its tables match the JAX package's.
"""
from __future__ import annotations

import math
import os

import numpy as np
import torch

from ..data.waymo import WaymoScene
from ..utils.device import resolve_device
from . import gaussians as G
from .actor_pose import build_actor_pose
from .corrections import init_color_correction, init_pose_correction
from .scene_graph import SceneArrays, SceneMeta, SceneModels
from .sky import init_sky_cubemap


def _round_pow2(n, lo=256):
    return max(lo, 1 << math.ceil(math.log2(max(n, 1))))


def random_actor_points(bbox, points_dim: int = 20, seed: int = 0):
    """Random 20^3 grid in the actor bbox
    (`gaussian_model_actor.create_from_pcd:96-111`)."""
    rng = np.random.default_rng(seed)
    lin = np.linspace(-1, 1, points_dim)
    gx, gy, gz = np.meshgrid(lin, lin, lin)
    pts = np.stack([gx.ravel(), gy.ravel(), gz.ravel()], -1)
    pts = pts * (np.asarray(bbox) / 2.0)
    cols = rng.random((pts.shape[0], 3)).astype(np.float32)
    return pts.astype(np.float32), cols


def init_sky_gaussians(datadir: str, sphere_center, sphere_radius,
                       capacity: int, sh_degree: int, seed: int = 7,
                       device=None):
    """Trainable sky-sphere Gaussians (reference `gaussian_model_sky.py:10`):
    from `input_ply/points3D_sky.ply` when the data-prep produced one, else
    uniformly drawn directions at 2.5x the scene sphere radius."""
    from ..data.ply import fetch_pointcloud

    sky_ply = os.path.join(datadir, "input_ply", "points3D_sky.ply")
    if os.path.exists(sky_ply):
        pts, cols, _ = fetch_pointcloud(sky_ply)
    else:
        rng = np.random.default_rng(seed)
        n = capacity // 2
        dirs = rng.standard_normal((n, 3))
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
        dirs[:, 2] = np.abs(dirs[:, 2])  # upper hemisphere (z-up world)
        pts = (np.asarray(sphere_center)[None]
               + 2.5 * float(sphere_radius) * dirs).astype(np.float32)
        cols = np.full((n, 3), 0.6, np.float32)
        cols[:, 2] = 0.8
    pts = pts[:capacity]
    cols = cols[:capacity]
    return G.init_from_points(pts, cols, capacity, sh_degree, device=device)


def build_scene_from_waymo(scene: WaymoScene, cfg, device=None) -> tuple:
    """(models, meta, arrays, actor_names): the composite scene of a loaded
    Waymo scene and a config, on `device` (CUDA unless given)."""
    dev = resolve_device(device)
    gcfg = cfg.model.gaussian
    nsg = cfg.model.nsg
    sh_degree = gcfg.sh_degree
    fourier_dim = gcfg.get("fourier_dim", 1)
    num_classes = cfg.data.num_classes if cfg.data.get("use_semantic",
                                                       False) else 0

    pcds = scene.load_init_pointclouds()
    if "background" in pcds:
        pts, cols, _ = pcds["background"]
    else:
        # fallback: random shell around the trajectory (no prepared PLYs)
        rng = np.random.default_rng(0)
        pts = rng.uniform(-50, 50, (100_000, 3)).astype(np.float32)
        cols = rng.random((100_000, 3)).astype(np.float32)

    # scene extent: nerf++ camera norm, floored at 10, overridable by
    # cfg.data.extent (`waymo_full_readers.py:206-225`)
    cam_centers = np.stack(
        [scene.camera_to_world(scene.start_frame + fi, cam)[:3, 3]
         for fi in range(scene.num_frames) for cam in scene.cameras])
    scene_c = cam_centers.mean(axis=0).astype(np.float32)
    scene_r = max(
        float(np.linalg.norm(cam_centers - scene_c, axis=-1).max()) * 1.1,
        10.0)
    if cfg.data.get("extent", False):
        scene_r = float(cfg.data.extent)

    # sphere normalization from the LiDAR cloud
    # (`waymo_full_readers.py:228-237`)
    sphere_c, sphere_r = scene_c, scene_r
    sphere_src = pcds.get("lidar", pcds.get("background"))
    if sphere_src is not None:
        from ..data.lidar_init import sphere_norm
        sphere_c, sphere_r = sphere_norm(
            sphere_src[0], cfg.data.get("sphere_scale", 1.0))
    bkgd, bkgd_aux = G.init_from_points(
        pts, cols, _round_pow2(pts.shape[0] * 4), sh_degree,
        num_classes=num_classes, device=dev)

    track_ids = sorted(scene.objects_info.keys())
    actor_names = [f"obj_{tid:03d}" for tid in track_ids]
    actor_list, aux_list, bboxes, deform, classes = [], [], [], [], []
    starts_ts, ends_ts, starts_f, ends_f = [], [], [], []
    a_cap = int(cfg.model.get("actor_capacity", 16384))
    for tid in track_ids:
        info = scene.objects_info[tid]
        bbox = np.array([info["length"], info["width"], info["height"]],
                        np.float32)
        if tid in pcds:
            pts, cols, _ = pcds[tid]
        else:
            pts, cols = random_actor_points(bbox, seed=tid)
        pts = pts[:a_cap // 2]
        cols = cols[:a_cap // 2]
        p, aux = G.init_from_points(pts, cols, a_cap,
                                    gcfg.get("sh_degree_obj", sh_degree),
                                    fourier_dim=fourier_dim, num_classes=1,
                                    device=dev)
        actor_list.append(p)
        aux_list.append(aux)
        bboxes.append(bbox)
        deform.append(info["deformable"])
        classes.append(max(info["class_label"], 0))
        starts_ts.append(info["start_timestamp"])
        ends_ts.append(info["end_timestamp"])
        starts_f.append(info["start_frame"])
        ends_f.append(info["end_frame"])

    n_actors = len(track_ids)
    if n_actors:
        actors = G.stack_params(actor_list)
        actors_aux = G.stack_params(aux_list)
        pose = build_actor_pose(scene.tracklets, scene.frame_timestamps,
                                track_ids,
                                opt_track=nsg.get("opt_track", True),
                                device=dev)
    else:
        actors = actors_aux = pose = None

    meta = SceneMeta(
        num_actors=n_actors,
        bkgd_sh_degree=sh_degree,
        obj_sh_degree=gcfg.get("sh_degree_obj", sh_degree),
        fourier_dim=fourier_dim,
        fourier_scale=gcfg.get("fourier_scale", 1.0),
        num_classes=num_classes,
        semantic_mode=gcfg.get("semantic_mode", "logits"),
        flip_prob=gcfg.get("flip_prob", 0.0),
        use_color_correction=cfg.model.use_color_correction,
        use_pose_correction=cfg.model.use_pose_correction,
        include_sky=nsg.get("include_sky", False),
        include_sky_gaussians=nsg.get("include_sky_gaussians", False),
    )

    def t(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

    def one(xs, d=0.0):
        return t(np.asarray(xs if xs else [d], np.float32))

    arrays = SceneArrays(
        actor_start_ts=one(starts_ts),
        actor_end_ts=one(ends_ts, 1.0),
        actor_start_frame=one(starts_f),
        actor_end_frame=one(ends_f, 1.0),
        actor_bbox=t(np.stack(bboxes) if bboxes
                     else np.zeros((1, 3), np.float32)),
        actor_deformable=t(np.asarray(deform if deform else [0], bool),
                           torch.bool),
        actor_class=t(np.asarray(classes if classes else [0]), torch.int64),
        scene_center=t(scene_c),
        scene_radius=t(np.float32(scene_r)),
        sphere_center=t(np.asarray(sphere_c, np.float32)),
        sphere_radius=t(np.float32(sphere_r)),
    )

    sky_g = sky_g_aux = None
    if meta.include_sky_gaussians:
        sky_g, sky_g_aux = init_sky_gaussians(
            scene.datadir, sphere_c, sphere_r,
            int(cfg.model.get("sky_capacity", 16384)), sh_degree, device=dev)

    num_images = scene.num_frames * len(scene.cameras)
    models = SceneModels(
        background=bkgd,
        bkgd_aux=bkgd_aux,
        actors=actors,
        actors_aux=actors_aux,
        actor_pose=pose,
        sky=init_sky_cubemap(device=dev) if meta.include_sky else None,
        color_correction=init_color_correction(
            num_images, cfg.model.color_correction.mode,
            use_mlp=cfg.model.color_correction.get("use_mlp", False),
            device=dev)
        if meta.use_color_correction else None,
        pose_correction=init_pose_correction(
            num_images, cfg.model.pose_correction.mode, device=dev)
        if meta.use_pose_correction else None,
        sky_gauss=sky_g,
        sky_gauss_aux=sky_g_aux,
    )
    return models, meta, arrays, actor_names
