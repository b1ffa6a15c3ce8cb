"""Synthetic street scenes (background + box actors driving forward + sky)
for tests, the closed-loop demo and the chip smoke run; and the test scene
of the fused braking event (`red_lead_setup`) with its stand-in predictor
(`red_blob_predict`).

Counterpart of `gaussianrpg_tpu/utils/synthetic.py`: the same seeded numpy
draws, so one seed gives the same scene in both packages.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..models import gaussians as G
from ..models.actor_pose import build_actor_pose
from ..models.corrections import init_color_correction, init_pose_correction
from ..models.scene_graph import SceneArrays, SceneMeta, SceneModels
from ..models.sky import init_sky_cubemap
from ..render.camera import make_camera
from .device import resolve_device


def make_scene(
    n_background: int = 2000,
    bkgd_capacity: int = 4096,
    n_actors: int = 2,
    actor_capacity: int = 512,
    n_frames: int = 10,
    sh_degree: int = 1,
    fourier_dim: int = 2,
    num_classes: int = 0,
    include_sky: bool = False,
    use_color_correction: bool = False,
    use_pose_correction: bool = False,
    opt_track: bool = True,
    num_images: int = 10,
    seed: int = 0,
    device=None,
):
    """A street-like scene: ground + blobs background, box actors driving
    forward over n_frames (timestamps 0..1). Returns (models, meta,
    arrays) on `device` (CUDA unless given)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    ground = np.stack([
        rng.uniform(-20, 20, n_background // 2),
        rng.uniform(1.4, 1.6, n_background // 2),
        rng.uniform(2, 60, n_background // 2),
    ], -1)
    blobs = np.stack([
        rng.uniform(-15, 15, n_background - n_background // 2),
        rng.uniform(-5, 1.5, n_background - n_background // 2),
        rng.uniform(2, 60, n_background - n_background // 2),
    ], -1)
    bk_pts = np.concatenate([ground, blobs]).astype(np.float32)
    bk_col = rng.uniform(0.1, 0.9, (n_background, 3)).astype(np.float32)
    bkgd, bkgd_aux = G.init_from_points(
        bk_pts, bk_col, bkgd_capacity, sh_degree, fourier_dim=1,
        num_classes=num_classes, device=dev)

    actor_params, actor_auxes, bboxes = [], [], []
    for _ in range(n_actors):
        bbox = np.array([4.0, 1.8, 1.6], np.float32)
        pts = rng.uniform(-0.5, 0.5, (actor_capacity // 2, 3)) * bbox
        col = rng.uniform(0.2, 0.95, (pts.shape[0], 3))
        p, aux = G.init_from_points(
            pts.astype(np.float32), col.astype(np.float32), actor_capacity,
            sh_degree, fourier_dim=fourier_dim, num_classes=1, device=dev)
        actor_params.append(p)
        actor_auxes.append(aux)
        bboxes.append(bbox)
    if n_actors:
        actors = G.stack_params(actor_params)
        actors_aux = G.stack_params(actor_auxes)
    else:
        actors = actors_aux = None

    tstamps = np.linspace(0.0, 1.0, n_frames).astype(np.float32)
    tracklets = np.zeros((n_frames, max(n_actors, 1), 8), np.float32)
    for a in range(n_actors):
        lane = (-3.0 if a % 2 == 0 else 3.0)
        for f in range(n_frames):
            z = 8.0 + 2.0 * a + (20.0 + 5 * a) * tstamps[f]
            tracklets[f, a] = [a, lane, 0.5, z, 1, 0, 0, 0]
    pose = build_actor_pose(tracklets, tstamps, list(range(n_actors)),
                            opt_track=opt_track, device=dev) \
        if n_actors else None

    meta = SceneMeta(
        num_actors=n_actors, bkgd_sh_degree=sh_degree,
        obj_sh_degree=sh_degree, fourier_dim=fourier_dim,
        num_classes=num_classes, include_sky=include_sky,
        use_color_correction=use_color_correction,
        use_pose_correction=use_pose_correction)
    o = max(n_actors, 1)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    arrays = SceneArrays(
        actor_start_ts=torch.zeros(o, device=dev),
        actor_end_ts=torch.ones(o, device=dev),
        actor_start_frame=torch.zeros(o, device=dev),
        actor_end_frame=torch.full((o,), float(n_frames - 1), device=dev),
        actor_bbox=f32(np.stack(bboxes) if bboxes else np.zeros((1, 3))),
        actor_deformable=torch.zeros(o, dtype=torch.bool, device=dev),
        actor_class=torch.zeros(o, dtype=torch.int64, device=dev),
        scene_center=torch.zeros(3, device=dev),
        scene_radius=f32(30.0),
        sphere_center=torch.zeros(3, device=dev),
        sphere_radius=f32(30.0),
    )
    models = SceneModels(
        background=bkgd, bkgd_aux=bkgd_aux, actors=actors,
        actors_aux=actors_aux, actor_pose=pose,
        sky=init_sky_cubemap(64, device=dev) if include_sky else None,
        color_correction=init_color_correction(num_images, device=dev)
        if use_color_correction else None,
        pose_correction=init_pose_correction(num_images, device=dev)
        if use_pose_correction else None,
    )
    return models, meta, arrays


def build_frozen_scene(device=None):
    """The repo's frozen bench scene (`bench.build_frozen_scene`): 600k
    street-like Gaussians with trained-scene opacity and 2-6 px footprint
    statistics at the Waymo FRONT resolution (1066x1600), seed 0. Returns
    (camera, (means, opacities, colors, scales, quats), height, width)."""
    dev = resolve_device(device)
    n, H, W = 600_000, 1066, 1600
    rng = np.random.default_rng(0)
    n_g, n_f, n_s = n // 2, n // 3, n - n // 2 - n // 3
    ground = np.stack([rng.uniform(-40, 40, n_g), np.full(n_g, 1.6)
                       + 0.05 * rng.standard_normal(n_g),
                       rng.uniform(0.5, 120, n_g)], -1)
    facades = np.stack([np.where(rng.random(n_f) < 0.5, -1, 1)
                        * rng.uniform(6, 12, n_f),
                        rng.uniform(-6, 1.6, n_f),
                        rng.uniform(0.5, 120, n_f)], -1)
    sky = np.stack([rng.uniform(-60, 60, n_s), rng.uniform(-30, -6, n_s),
                    rng.uniform(20, 150, n_s)], -1)
    means = np.concatenate([ground, facades, sky]).astype(np.float32)
    fovx = math.radians(50.0)
    fl = W / (2 * math.tan(fovx / 2))
    sigma_px = rng.uniform(2.0, 6.0, n)
    z = np.clip(means[:, 2], 1.0, None)
    scales = (sigma_px * z / fl)[:, None].repeat(3, 1).astype(np.float32)
    q = rng.standard_normal((n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    opac = rng.uniform(0.6, 0.99, n).astype(np.float32)
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    fovy = 2 * math.atan(math.tan(fovx / 2) * H / W)
    cam = make_camera(R=np.eye(3), T=np.zeros(3), K=None, width=W, height=H,
                      fovx=fovx, fovy=fovy, device=dev)
    args = tuple(torch.as_tensor(a, device=dev)
                 for a in (means, opac, colors, scales, q))
    return cam, args, H, W


def make_cameras(n_frames: int = 10, width: int = 128, height: int = 96,
                 fov_deg: float = 60.0, device=None):
    """Forward-facing cameras at timestamps 0..1 moving along +z."""
    cams = []
    fovx = math.radians(fov_deg)
    fovy = 2 * math.atan(math.tan(fovx / 2) * height / width)
    for f, t in enumerate(np.linspace(0.0, 1.0, n_frames)):
        c2w = np.eye(4)
        c2w[2, 3] = 4.0 * t
        w2c = np.linalg.inv(c2w)
        cams.append(make_camera(
            R=w2c[:3, :3].T, T=w2c[:3, 3], K=None, width=width,
            height=height, fovx=fovx, fovy=fovy,
            ego_pose=c2w.astype(np.float32), timestamp=float(t), frame=f,
            image_id=f, device=device))
    return cams


def lead_vehicle_scenario(width, height, ego_speed, lead_world_z,
                          n_frames, n_background, bkgd_capacity,
                          actor_capacity, device):
    """The closed-loop scenario (apps/simulate.py): a street scene whose one actor is a lead
    vehicle stopped ahead of the ego, which drives forward at ego_speed.
    Returns (models, meta, arrays, cameras, tape, gt_tracklets, v2c)."""
    from ..sim.tape import build_tape_from_cameras

    dev = resolve_device(device)
    models, meta, arrays = make_scene(
        n_background=n_background, bkgd_capacity=bkgd_capacity, n_actors=1,
        actor_capacity=actor_capacity, n_frames=n_frames, opt_track=False,
        device=dev)
    duration = (n_frames - 1) / 10.0
    ts = np.arange(n_frames) / 10.0
    trans = np.zeros((n_frames, 1, 3), np.float32)
    trans[:, 0, 1] = 0.5
    trans[:, 0, 2] = lead_world_z - ego_speed * ts
    models = models.replace(actor_pose=models.actor_pose.replace(
        input_trans=torch.as_tensor(trans, device=dev),
        timestamps=torch.as_tensor(ts.astype(np.float32), device=dev)))
    arrays = arrays.replace(actor_start_ts=torch.zeros(1, device=dev),
                            actor_end_ts=torch.full((1,), duration,
                                                    device=dev))

    fovx = math.radians(60.0)
    fovy = 2 * math.atan(math.tan(fovx / 2) * height / width)
    cams = []
    for i in range(n_frames):
        c2w = np.eye(4)
        c2w[2, 3] = ego_speed * ts[i]
        w2c = np.linalg.inv(c2w)
        cams.append(make_camera(
            R=w2c[:3, :3].T, T=w2c[:3, 3], K=None, width=width,
            height=height, fovx=fovx, fovy=fovy,
            ego_pose=c2w.astype(np.float32), timestamp=float(ts[i]),
            frame=i, image_id=i, device=dev))
    tape_frames = build_tape_from_cameras(cams, upsample_rate=5)
    tape = {"frames": tape_frames, "image_freq": 10, "dynamic_freq": 50}
    gt_tracklets = {i: (lead_world_z, 0.0, 0.0) for i in range(len(cams))}
    # synthetic vehicle frame: forward = +z_cam, left = -x_cam, up = -y_cam
    v2c = np.array([[0., -1., 0., 0.], [0., 0., -1., 0.],
                    [1., 0., 0., 0.], [0., 0., 0., 1.]])
    return models, meta, arrays, cams, tape, gt_tracklets, v2c


def fitting_renderer(models, meta, arrays, cams, active_sh_degree, dev):
    """render(cam) -> RenderResult, with the pair capacity probed from the
    tape's cameras and grown on overflow."""
    from ..render.renderer import (RenderOptions, probe_scene_capacity,
                                   render_scene, render_until_fit)

    state = {"options": probe_scene_capacity(
        models, meta, arrays, cams, active_sh_degree=active_sh_degree,
        options=RenderOptions(), slack=1.3)}

    def render(cam):
        res, state["options"] = render_until_fit(
            lambda o: render_scene(models, meta, arrays, cam,
                                   active_sh_degree=active_sh_degree,
                                   options=o, device=dev), state["options"])
        return res

    return render


RED_DC = 0.5 / 0.28209479177387814   # SH DC giving colour 1.0 (C0*dc+0.5)


def red_lead_setup(width=128, height=80, device=None):
    """(tape, render_rgb, camera_template, gt_tracklets, v2c): the
    scenario of the JAX package's fused braking test (tests/test_sim.py:
    `test_braking_event_through_fused_pipeline`) with the scene repainted
    so that the lead vehicle is unambiguous: a near-transparent grey
    background (opacity logit -5) and a pure-red actor. render_rgb(cam)
    returns the [3, H, W] image on the device, for the fused pipeline."""
    dev = resolve_device(device)
    models, meta, arrays, cams, tape, gt, v2c = lead_vehicle_scenario(
        width, height, 8.0, 30.0, 40, 8000, 16384, 1024, dev)
    bk, ac = models.background, models.actors
    red = torch.tensor([RED_DC, -RED_DC, -RED_DC], device=dev)
    models = models.replace(
        background=bk.replace(
            features_dc=torch.zeros_like(bk.features_dc),
            features_rest=torch.zeros_like(bk.features_rest),
            opacity=torch.full_like(bk.opacity, -5.0)),
        actors=ac.replace(
            features_dc=red.expand(ac.features_dc.shape).contiguous(),
            features_rest=torch.zeros_like(ac.features_rest)))
    render = fitting_renderer(models, meta, arrays, cams, 0, dev)

    def render_rgb(cam):
        return render(cam).rgb

    return tape, render_rgb, cams[0], gt, v2c


def red_blob_predict(spec, params, imgs, n_anchor: int = 8):
    """A deterministic stand-in for the YOLO graph at the fused pipeline's
    `predict_fn` contract point: the box of the red-dominant pixels of the
    letterboxed frame imgs [1, h, w, 3], as one confident 'car' row of an
    [1, n_anchor, 85] prediction (zeros elsewhere)."""
    img = imgs[0]
    h, w = img.shape[0], img.shape[1]
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    mask = (r > 0.55) & (r - torch.maximum(g, b) > 0.25)
    ys = torch.arange(h, dtype=torch.float32, device=img.device)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=img.device)[None, :]
    big = torch.tensor(1e9, device=img.device)
    x0 = torch.where(mask, xs, big).amin()
    x1 = torch.where(mask, xs, -big).amax()
    y0 = torch.where(mask, ys, big).amin()
    y1 = torch.where(mask, ys, -big).amax()
    ok = ((mask.sum() >= 3) & (x1 > x0) & (y1 > y0)).float()
    row = torch.zeros(85, device=img.device)
    row[:4] = torch.stack([(x0 + x1) / 2, (y0 + y1) / 2, (x1 - x0) + 1.0,
                           (y1 - y0) + 1.0]) * ok
    row[4] = ok                                         # objectness
    row[5 + 2] = 1.0                                    # class 2 = car
    pred = torch.zeros((n_anchor, 85), device=img.device)
    pred[0] = row
    return pred[None]
