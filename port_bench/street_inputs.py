"""The street cell's inputs, made from `--seed` on the device: the Street
Gaussians composite scene of a configuration (the background in the
builder's capacity-padded slots, the tracked vehicles with their Fourier
DC colour and learned pose deltas, the sky cube map), and each lateral
start's cameras and tape.

The world follows the Waymo vehicle convention (x forward, y left, z up):
the recorded ego drives +x from the origin, and the FRONT camera sits
`ground.y` metres above the ground at the vehicle origin, looking along
+x. The background is the frozen cell's street (`inputs.frozen_scene`,
laid out in the camera's frame) turned into that world. `draw` returns
plain tensors, which the plain reference reads; `scene_models` wraps the
same tensors in the port's scene classes.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import inputs

SH_C0 = 0.28209479177387814


def round_pow2(n: int, lo: int = 256) -> int:
    """The scene builder's slot capacity rule."""
    return max(lo, 1 << math.ceil(math.log2(max(n, 1))))


def cam_to_vehicle(height: float) -> np.ndarray:
    """The FRONT camera's camera->vehicle extrinsic: OpenCV axes (x right,
    y down, z forward) to the vehicle's (x forward, y left, z up), the
    camera `height` above the vehicle origin."""
    m = np.eye(4)
    m[:3, :3] = [[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]]
    m[2, 3] = height
    return m


def recorded_ego(t: float, wl: dict) -> np.ndarray:
    """vehicle->world of the recorded ego at `t` seconds."""
    m = np.eye(4)
    m[0, 3] = wl["ego_speed_mps"] * t
    return m


def focal(sc: dict) -> float:
    """The camera's focal length in pixels, as a camera file stores it."""
    return float(np.float32(sc["width"]
                            / (2 * math.tan(math.radians(sc["fovx_deg"])
                                            / 2))))


def intrinsics(sc: dict) -> np.ndarray:
    f = focal(sc)
    return np.array([[f, 0.0, sc["width"] / 2], [0.0, f, sc["height"] / 2],
                     [0.0, 0.0, 1.0]], np.float32)


def frames(cfg: dict) -> tuple[int, int]:
    """The configuration's first and last image frames."""
    a, b = cfg["config"]["data"]["selected_frames"]
    return int(a), int(b)


def image_hz(cfg: dict) -> float:
    return float(cfg["config"]["sim"]["image_freq"])


def vehicle_track(v: dict, wl: dict, t: float) -> tuple[float, float]:
    """(x, y) world position of a vehicle's box centre at `t` seconds; the
    lead's start and speed come from the workload."""
    if v["role"] == "lead":
        return wl["cipv_ahead_m"] + wl["cipv_speed_mps"] * t, v["y_m"]
    return v["x_m"] + v["speed_mps"] * t, v["y_m"]


def _yaw_quat(yaw: float) -> list:
    return [math.cos(yaw / 2), 0.0, 0.0, math.sin(yaw / 2)]


def draw(cfg: dict, wl: dict, gen: torch.Generator, device) -> dict:
    """The scene's tensors (float32 on `device` unless noted):

    - bkgd: xyz [C, 3], f_dc [C, 1, 3], f_rest [C, 15, 3], scaling [C, 3]
      (log), rotation [C, 4], opacity [C, 1] (logit), n_active;
    - actors (stacked [O, A, ...]): the same fields, f_dc [O, A, F, 3]
      with F Fourier coefficients, n_active [O] (int32);
    - tracklets [T, O, 8] (numpy: track id or -1 where untracked, x, y, z,
      quaternion (w, x, y, z) in the recorded ego's frame), track_ts [T]
      (numpy float32 seconds), opt_trans [T, O, 3], opt_rots [T, O, 1];
    - start_ts, end_ts, start_frame, end_frame, bbox [O, 3] (l, w, h);
    - sky [6, R, R, 3]."""
    sc, mc = cfg["scene"], cfg["config"]["model"]
    deg = int(mc["gaussian"]["sh_degree"])
    n_rest = (deg + 1) ** 2 - 1
    fdim = int(mc["gaussian"]["fourier_dim"])
    h = float(sc["ground"]["y"])

    # background: the frozen cell's layout, camera frame -> vehicle frame
    fz = inputs.frozen_scene(sc, gen, device)
    n = fz["means"].shape[0]
    cap = round_pow2(4 * n)
    m = fz["means"]
    xyz = torch.stack([m[:, 2], -m[:, 0], h - m[:, 1]], -1)
    rest = cfg["sh_rest_sd"] * torch.randn((n, n_rest, 3), generator=gen,
                                           device=device)
    bkgd = _padded(cap, xyz, (fz["colors"] - 0.5)[:, None, :] / SH_C0, rest,
                   torch.log(fz["scales"]), fz["quats"],
                   torch.logit(fz["opacities"])[:, None])

    # actors: uniform in their boxes, the background's statistics at their
    # depth at the first camera
    vs = cfg["vehicles"]
    a_cap = int(mc["actor_capacity"])
    a_n = a_cap // 2
    f0, f1 = frames(cfg)
    hz = image_hz(cfg)
    fl = focal(sc)
    parts = []
    for v in vs:
        u = torch.rand((a_n, 8), generator=gen, device=device)
        z = torch.randn((a_n, 4 + 3 * (fdim - 1) + 3 * n_rest),
                        generator=gen, device=device)
        lwh = torch.tensor(v["lwh"], device=device)
        local = (u[:, :3] - 0.5) * lwh
        x0, _ = vehicle_track(v, wl, 0.0)
        lo, hi = sc["sigma_px"]
        sigma = lo + (hi - lo) * u[:, 3]
        scale = (sigma * max(abs(x0), 1.0) / fl)[:, None].expand(a_n, 3)
        olo, ohi = sc["opacity"]
        op = olo + (ohi - olo) * u[:, 4]
        dc = torch.cat([((u[:, 5:8] - 0.5) / SH_C0)[:, None, :],
                        cfg["fourier_sd"]
                        * z[:, 4:4 + 3 * (fdim - 1)].view(a_n, fdim - 1, 3)],
                       1)
        arest = cfg["sh_rest_sd"] * z[:, 4 + 3 * (fdim - 1):].view(
            a_n, n_rest, 3)
        q = z[:, :4] / z[:, :4].norm(dim=1, keepdim=True)
        parts.append(_padded(a_cap, local, dc, arest, torch.log(scale), q,
                             torch.logit(op)[:, None]))
    actors = {k: torch.stack([p[k] for p in parts]) for k in parts[0]
              if k != "n_active"}
    actors["n_active"] = torch.full((len(vs),), a_n, dtype=torch.int32,
                                    device=device)

    # tracklets over the configuration's frames, in the recorded ego's frame
    n_t = f1 - f0 + 1
    track_ts = (np.arange(n_t) / hz).astype(np.float32)
    trk = np.zeros((n_t, len(vs), 8), np.float32)
    trk[..., 0] = -1.0
    trk[..., 4] = 1.0
    for o, v in enumerate(vs):
        a, b = v["frames"]
        yaw = math.pi if v.get("speed_mps", 0.0) < 0 else 0.0
        for f in range(a, b + 1):
            t = (f - f0) / hz
            x, y = vehicle_track(v, wl, t)
            ego = recorded_ego(t, wl)
            trk[f - f0, o] = [o, x - ego[0, 3], y - ego[1, 3],
                              v["lwh"][2] / 2, *_yaw_quat(yaw)]
    tn = cfg["track_noise"]
    noise = torch.randn((n_t, len(vs), 4), generator=gen, device=device)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    starts = [v["frames"][0] for v in vs]
    ends = [v["frames"][1] for v in vs]
    sk = cfg["sky_cubemap"]
    lo, hi = sk["value"]
    grid = lo + (hi - lo) * torch.rand((6, 3, sk["grid"], sk["grid"]),
                                       generator=gen, device=device)
    sky = torch.nn.functional.interpolate(
        grid, size=(sk["resolution"], sk["resolution"]), mode="bilinear",
        align_corners=False).permute(0, 2, 3, 1).contiguous()
    return dict(
        bkgd=bkgd, actors=actors, tracklets=trk, track_ts=track_ts,
        opt_trans=(tn["trans_m"] * noise[..., :3]).contiguous(),
        opt_rots=(tn["yaw_rad"] * noise[..., 3:]).contiguous(),
        start_ts=f32([track_ts[a - f0] for a in starts]),
        end_ts=f32([track_ts[b - f0] for b in ends]),
        start_frame=f32(starts), end_frame=f32(ends),
        bbox=f32([v["lwh"] for v in vs]), sky=sky)


def _padded(cap, xyz, f_dc, f_rest, scaling, rotation, opacity) -> dict:
    """The active rows in the first slots of `cap`, the rest padded as
    `models.gaussians.init_from_points` pads them."""
    n, dev = xyz.shape[0], xyz.device

    def pad(x, fill=0.0):
        out = torch.full((cap,) + tuple(x.shape[1:]), fill,
                         dtype=torch.float32, device=dev)
        out[:n] = x
        return out

    rot = pad(rotation)
    rot[n:, 0] = 1.0
    return dict(xyz=pad(xyz), f_dc=pad(f_dc), f_rest=pad(f_rest),
                scaling=pad(scaling, -20.0), rotation=rot,
                opacity=pad(opacity, -20.0),
                n_active=torch.tensor(n, dtype=torch.int32, device=dev))


def scene_models(s: dict, cfg: dict, device):
    """(models, meta, arrays) of the port over the tensors of `draw`."""
    from gaussianrpg_tpu_torch.models import gaussians as G
    from gaussianrpg_tpu_torch.models.actor_pose import build_actor_pose
    from gaussianrpg_tpu_torch.models.scene_graph import (SceneArrays,
                                                          SceneMeta,
                                                          SceneModels)
    from gaussianrpg_tpu_torch.models.sky import SkyCubeMap

    mc = cfg["config"]["model"]
    gc = mc["gaussian"]

    def params(p, stack=()):
        c = p["xyz"].shape[-2]
        return (G.GaussianParams(
            xyz=p["xyz"], features_dc=p["f_dc"], features_rest=p["f_rest"],
            scaling=p["scaling"], rotation=p["rotation"],
            opacity=p["opacity"],
            semantic=torch.zeros(stack + (c, 1), device=device)),
            G.GaussianAux(
                n_active=p["n_active"],
                xyz_gradient_accum=torch.zeros(stack + (c, 2),
                                               device=device),
                denom=torch.zeros(stack + (c, 1), device=device),
                max_radii2d=torch.zeros(stack + (c,), device=device)))

    bkgd, bkgd_aux = params(s["bkgd"])
    o = s["actors"]["xyz"].shape[0]
    actors, actors_aux = params(s["actors"], (o,))
    pose = build_actor_pose(s["tracklets"], s["track_ts"], list(range(o)),
                            opt_track=mc["nsg"]["opt_track"], device=device)
    pose = pose.replace(opt_trans=s["opt_trans"], opt_rots=s["opt_rots"])
    meta = SceneMeta(
        num_actors=o, bkgd_sh_degree=gc["sh_degree"],
        obj_sh_degree=gc.get("sh_degree_obj", gc["sh_degree"]),
        fourier_dim=gc["fourier_dim"], fourier_scale=gc["fourier_scale"],
        flip_prob=gc["flip_prob"], include_sky=mc["nsg"]["include_sky"])
    zero = torch.zeros(3, device=device)
    extent = torch.tensor(float(cfg["config"]["data"]["extent"]),
                          device=device)
    arrays = SceneArrays(
        actor_start_ts=s["start_ts"], actor_end_ts=s["end_ts"],
        actor_start_frame=s["start_frame"], actor_end_frame=s["end_frame"],
        actor_bbox=s["bbox"],
        actor_deformable=torch.zeros(o, dtype=torch.bool, device=device),
        actor_class=torch.zeros(o, dtype=torch.int64, device=device),
        scene_center=zero, scene_radius=extent, sphere_center=zero,
        sphere_radius=extent)
    models = SceneModels(
        background=bkgd, bkgd_aux=bkgd_aux, actors=actors,
        actors_aux=actors_aux, actor_pose=pose,
        sky=SkyCubeMap(s["sky"]) if meta.include_sky else None,
        color_correction=None, pose_correction=None)
    return models, meta, arrays


def camera_poses(cfg: dict, wl: dict, offset: float) -> list:
    """(c2w, recorded ego, seconds) of one episode's planned frames: the
    camera `offset` metres left of the recorded ego's path."""
    n = int(round(wl["episode_s"] * image_hz(cfg))) + 1
    c2v = cam_to_vehicle(cfg["scene"]["ground"]["y"])
    shift = np.eye(4)
    shift[1, 3] = offset
    out = []
    for k in range(n):
        t = k / image_hz(cfg)
        ego = recorded_ego(t, wl)
        out.append((shift @ ego @ c2v, ego, t))
    return out


def episode_cameras(cfg: dict, wl: dict, offset: float, device) -> list:
    """The port's cameras of one episode's planned frames."""
    from gaussianrpg_tpu_torch.render.camera import make_camera

    sc = cfg["scene"]
    f0, _ = frames(cfg)
    c2v = cam_to_vehicle(sc["ground"]["y"]).astype(np.float32)
    cams = []
    for k, (c2w, ego, t) in enumerate(camera_poses(cfg, wl, offset)):
        w2c = np.linalg.inv(c2w)
        cams.append(make_camera(
            R=w2c[:3, :3].T, T=w2c[:3, 3], K=intrinsics(sc),
            width=sc["width"], height=sc["height"],
            ego_pose=ego.astype(np.float32), extrinsic=c2v, timestamp=t,
            frame=f0 + k, image_id=k, device=device))
    return cams


def lead_tracklets(cfg: dict, wl: dict) -> dict:
    """The loop's ground truth: {image frame: (x, 0, 0)}, x the lead's box
    centre in the recorded ego's frame, so the ground-truth node's
    distance is the lead's x less the camera's."""
    lead = next(v for v in cfg["vehicles"] if v["role"] == "lead")
    out = {}
    for k, (_, ego, t) in enumerate(camera_poses(cfg, wl, 0.0)):
        out[k] = (vehicle_track(lead, wl, t)[0] - ego[0, 3], 0.0, 0.0)
    return out
