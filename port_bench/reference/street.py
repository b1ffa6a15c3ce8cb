"""The Street Gaussians composite frame and the closed loop's decisions on
it, written plainly from the published equations (Yan et al., "Street
Gaussians", ECCV 2024: `lib/models/street_gaussian_model.py`,
`gaussian_model_actor.py`, `actor_pose.py`, `sky_cubemap.py`;
GaussianRPG's simulator, ground-truth, detector and AEB nodes):

- actor poses: each tracked vehicle's pose in the recorded ego's frame,
  from the two tracklet frames nearest the camera's timestamp (lerp of
  the translation, shortest-arc slerp of the rotation), with the learned
  deltas (`opt_track`): a translation added, a yaw quaternion
  (cos d, 0, 0, sin d) multiplied on the right; alive where the
  timestamp lies within the track's first and last timestamps;
- the scene graph: world pose = ego o tracked pose; actor means rotated
  by that pose's quaternion and translated, rotations multiplied by it;
  the actor's DC colour the inverse DFT of its Fourier coefficients at
  the normalised frame time (frame - start) / (end - start) (x the
  Fourier scale): cos(pi t k) for even k, sin(pi t (k + 1)) for odd k;
  SH colours (the 3DGS `eval_sh` recurrence) from the camera centre,
  + 0.5, clamped below at 0; inactive slots and actors not alive left
  out;
- the composite: the Gaussians rasterized by `raster.py` with a fourth
  channel of ones (its plane is the accumulated alpha), then
  rgb + sky (1 - alpha), clamped to [0, 1]; the sky a bilinear lookup of
  the cube map (OpenGL face order and orientation) along each pixel
  centre's ray, clamped to [0, 1];
- the detector: each alive actor's eight box corners in the camera,
  those deeper than 0.2 projected, their bounding rectangle clipped to
  the image and kept when at least 4 px each way;
- the loop: `replay` steps the ego's dynamics at the dynamics rate and
  ranges each frame's boxes on the ground plane into the tiered AEB
  (`aeb.ground_range`, `aeb.brake_command`, `aeb.CIPV_LAT_M`); the
  ground truth is the lead's planned position less the camera's.

Departures from the published code: the cube map's bilinear taps are
clamped to the face's edge texels, where nvdiffrast filters across cube
edges (`boundary_mode='cube'`); the cell's camera looks along +x within
25 degrees of the face's centre, never within half a texel of an edge.
The box projection runs in float64 (the port's detector computes in
float32 numpy). `aeb.replay` takes YOLO candidates and a vehicle at a
fixed gap; its dynamics loop is restated here with boxes and the lead's
own gap.

Plain float32 PyTorch (TF32 off for every call), numpy and `math`;
nothing here knows the port.
"""
from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import numpy as np
import torch

from . import aeb, raster

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)
MIN_DEPTH = 0.2
MIN_BOX_PX = 4


class View(NamedTuple):
    """One rendered frame: the world->camera rotation's transpose R (the
    camera->world rotation) and translation T, as a tape stores them, the
    recorded ego's vehicle->world pose, the timestamp and the image
    frame."""

    R: np.ndarray        # [3, 3]
    T: np.ndarray        # [3]
    ego: np.ndarray      # [4, 4]
    t: float
    frame: int


class Form(NamedTuple):
    """What a control changes in the reference: the splats' 2D fields and
    the actors' poses rounded to `field_dtype`, another SH degree, the
    Fourier time held at 0, the sky left out."""

    field_dtype: torch.dtype | None = None
    sh_degree: int | None = None
    freeze_fourier: bool = False
    sky: bool = True


@contextlib.contextmanager
def no_tf32():
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


# -- quaternions (w, x, y, z) ------------------------------------------

def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([aw * bw - ax * bx - ay * by - az * bz,
                        aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw], -1)


def quat_of_matrix(m: np.ndarray) -> np.ndarray:
    """Unit quaternion of a rotation matrix (float64, Shepperd's method)."""
    tr = m[0, 0] + m[1, 1] + m[2, 2]
    if tr > 0:
        s = 2.0 * math.sqrt(1.0 + tr)
        q = [s / 4, (m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s,
             (m[1, 0] - m[0, 1]) / s]
    else:
        i = int(np.argmax([m[0, 0], m[1, 1], m[2, 2]]))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = 2.0 * math.sqrt(1.0 + m[i, i] - m[j, j] - m[k, k])
        q = [0.0] * 4
        q[0] = (m[k, j] - m[j, k]) / s
        q[1 + i] = s / 4
        q[1 + j] = (m[j, i] + m[i, j]) / s
        q[1 + k] = (m[k, i] + m[i, k]) / s
    q = np.asarray(q)
    return q / np.linalg.norm(q)


def slerp(q0: torch.Tensor, q1: torch.Tensor, r: torch.Tensor):
    """Shortest-arc spherical interpolation, linear where the two are
    parallel to within sin(theta) < 1e-6, normalised."""
    d = (q0 * q1).sum(-1, keepdim=True)
    q1 = torch.where(d < 0, -q1, q1)
    d = d.abs().clamp(max=1.0)
    theta = torch.arccos(d)
    s = torch.sin(theta)
    near = s < 1e-6
    safe = torch.where(near, torch.ones_like(s), s)
    w0 = torch.where(near, 1.0 - r, torch.sin((1.0 - r) * theta) / safe)
    w1 = torch.where(near, r, torch.sin(r * theta) / safe)
    out = w0 * q0 + w1 * q1
    return out / out.norm(dim=-1, keepdim=True)


# -- the scene graph ----------------------------------------------------

def actor_poses(s: dict, t: float):
    """(translation [O, 3], quaternion [O, 4], alive [O]) of every actor
    in the recorded ego's frame at timestamp `t`."""
    dev = s["opt_trans"].device
    trk = torch.as_tensor(s["tracklets"], device=dev)
    ts = torch.as_tensor(s["track_ts"], device=dev)
    tt = torch.tensor(t, dtype=torch.float32, device=dev)
    trans, rots = [], []
    for o in range(trk.shape[1]):
        rows = torch.nonzero(trk[:, o, 0] == o).flatten()
        dt = (ts[rows] - tt).abs()
        i1 = int(torch.argmin(dt))
        dt[i1] = float("inf")
        i2 = int(torch.argmin(dt)) if rows.numel() > 1 else i1
        f1, f2 = rows[i1], rows[i2]
        ends = []
        for f in (f1, f2):
            d = s["opt_rots"][f, o]
            yaw = torch.cat([torch.cos(d), torch.zeros(2, device=dev),
                             torch.sin(d)])
            ends.append((trk[f, o, 1:4] + s["opt_trans"][f, o],
                         quat_mul(trk[f, o, 4:8], yaw)))
        t1, t2 = ts[f1], ts[f2]
        r = (tt - t1) / torch.where(t2 == t1, torch.ones_like(t1), t2 - t1)
        trans.append(ends[0][0] * (1 - r) + ends[1][0] * r)
        rots.append(slerp(ends[0][1], ends[1][1], r))
    alive = (tt >= s["start_ts"]) & (tt <= s["end_ts"])
    return torch.stack(trans), torch.stack(rots), alive


def sh_colors(deg: int, sh: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """SH colours at unit directions `d` (the 3DGS `eval_sh`), + 0.5,
    clamped below at 0."""
    x, y, z = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    out = SH_C0 * sh[:, 0]
    if deg > 0:
        out = out - SH_C1 * y * sh[:, 1] + SH_C1 * z * sh[:, 2] \
            - SH_C1 * x * sh[:, 3]
    if deg > 1:
        xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
        out = (out + SH_C2[0] * xy * sh[:, 4] + SH_C2[1] * yz * sh[:, 5]
               + SH_C2[2] * (2.0 * zz - xx - yy) * sh[:, 6]
               + SH_C2[3] * xz * sh[:, 7] + SH_C2[4] * (xx - yy) * sh[:, 8])
    if deg > 2:
        out = (out + SH_C3[0] * y * (3 * xx - yy) * sh[:, 9]
               + SH_C3[1] * xy * z * sh[:, 10]
               + SH_C3[2] * y * (4 * zz - xx - yy) * sh[:, 11]
               + SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy) * sh[:, 12]
               + SH_C3[4] * x * (4 * zz - xx - yy) * sh[:, 13]
               + SH_C3[5] * z * (xx - yy) * sh[:, 14]
               + SH_C3[6] * x * (xx - 3 * yy) * sh[:, 15])
    return (out + 0.5).clamp(min=0.0)


def fourier_dc(f_dc: torch.Tensor, tnorm: torch.Tensor) -> torch.Tensor:
    """Σ_k f_dc[..., k, :] b_k(t): the inverse DFT of the Fourier-stacked
    DC coefficients [N, F, 3] at the normalised time."""
    out = torch.zeros_like(f_dc[:, 0])
    for k in range(f_dc.shape[1]):
        b = (torch.cos(math.pi * tnorm * k) if k % 2 == 0
             else torch.sin(math.pi * tnorm * (k + 1)))
        out = out + f_dc[:, k] * b
    return out


def compose(s: dict, view: View, meta: dict, form: Form = Form()) -> dict:
    """The frame's Gaussians: means, scales, quats, opacities, colors
    (float32), the active background slots then each alive actor's."""
    dev = s["bkgd"]["xyz"].device
    deg = meta["sh_degree"] if form.sh_degree is None else form.sh_degree
    center = torch.as_tensor(-view.R @ view.T, dtype=torch.float32,
                             device=dev)
    out = {k: [] for k in ("means", "scales", "quats", "opacities",
                           "colors")}

    def add(xyz, sh, scaling, q, opacity):
        d = xyz - center
        d = d / d.norm(dim=1, keepdim=True)
        out["means"].append(xyz)
        out["colors"].append(sh_colors(deg, sh, d))
        out["scales"].append(torch.exp(scaling))
        out["quats"].append(q / q.norm(dim=1, keepdim=True))
        out["opacities"].append(torch.sigmoid(opacity[:, 0]))

    b = s["bkgd"]
    n = int(b["n_active"])
    add(b["xyz"][:n], torch.cat([b["f_dc"][:n], b["f_rest"][:n]], 1),
        b["scaling"][:n], b["rotation"][:n], b["opacity"][:n])

    trans, rots, alive = actor_poses(s, view.t)
    ego = torch.as_tensor(view.ego, dtype=torch.float32, device=dev)
    q_ego = torch.as_tensor(quat_of_matrix(np.asarray(view.ego,
                                                      np.float64)[:3, :3]),
                            dtype=torch.float32, device=dev)
    a = s["actors"]
    span = (s["end_frame"] - s["start_frame"]).clamp(min=1)
    tnorm = (view.frame - s["start_frame"]) / span * meta["fourier_scale"]
    if form.freeze_fourier:
        tnorm = torch.zeros_like(tnorm)
    for o in range(a["xyz"].shape[0]):
        if not bool(alive[o]):
            continue
        m = int(a["n_active"][o])
        q_w = quat_mul(q_ego, rots[o])
        r_w = raster._rotation(q_w[None])[0]
        t_w = ego[:3, :3] @ trans[o] + ego[:3, 3]
        xyz = a["xyz"][o, :m] @ r_w.T + t_w
        ql = a["rotation"][o, :m]
        ql = ql / ql.norm(dim=1, keepdim=True)
        dc = fourier_dc(a["f_dc"][o, :m], tnorm[o])
        add(xyz, torch.cat([dc[:, None], a["f_rest"][o, :m]], 1),
            a["scaling"][o, :m], quat_mul(q_w.expand(m, 4), ql),
            a["opacity"][o, :m])
    return {k: torch.cat(v) for k, v in out.items()}


# -- camera, sky, composite ---------------------------------------------

def camera(view: View, K: np.ndarray, width: int, height: int,
           device) -> raster.Camera:
    """The rasterizer's camera of a view: V = [R^T | T] and P from K
    (z in [0.001, 1000]), both as float32."""
    V = np.eye(4)
    V[:3, :3] = np.asarray(view.R).T
    V[:3, 3] = view.T
    V = V.astype(np.float32)
    fx, fy = float(K[0, 0]), float(K[1, 1])
    P = np.zeros((4, 4))
    P[0, 0] = 2 * fx / width
    P[1, 1] = 2 * fy / height
    P[0, 2] = -1 + 2 * (float(K[0, 2]) / width)
    P[1, 2] = -1 + 2 * (float(K[1, 2]) / height)
    P[2, 2] = (raster.Z_FAR + raster.Z_NEAR) / (raster.Z_FAR - raster.Z_NEAR)
    P[2, 3] = -2 * raster.Z_FAR * raster.Z_NEAR / (raster.Z_FAR
                                                  - raster.Z_NEAR)
    P[3, 2] = 1.0
    full = (P.astype(np.float32).astype(np.float64)
            @ V.astype(np.float64)).astype(np.float32)
    return raster.Camera(torch.as_tensor(V, device=device),
                         torch.as_tensor(full, device=device), int(width),
                         int(height), fx, fy, width / (2 * fx),
                         height / (2 * fy))


def sky(cube: torch.Tensor, view: View, K: np.ndarray, width: int,
        height: int) -> torch.Tensor:
    """[3, H, W] sky: the cube map [6, R, R, 3] looked up bilinearly along
    each pixel centre's world ray, clamped to [0, 1]."""
    dev = cube.device
    j, i = torch.meshgrid(torch.arange(height, device=dev,
                                       dtype=torch.float32) + 0.5,
                          torch.arange(width, device=dev,
                                       dtype=torch.float32) + 0.5,
                          indexing="ij")
    k_inv = torch.as_tensor(np.linalg.inv(np.asarray(K, np.float64)),
                            dtype=torch.float32, device=dev)
    rot = torch.as_tensor(np.asarray(view.R), dtype=torch.float32,
                          device=dev)
    pix = torch.stack([i, j, torch.ones_like(i)], -1)
    d = pix @ k_inv.T @ rot.T
    d = d / d.norm(dim=-1, keepdim=True)
    x, y, z = d.unbind(-1)
    ax, ay, az = x.abs(), y.abs(), z.abs()
    # OpenGL's table: major axis -> face, (sc, tc, ma)
    fx_ = (ax >= ay) & (ax >= az)
    fy_ = ~fx_ & (ay >= az)
    face = torch.where(fx_, torch.where(x > 0, 0, 1),
                       torch.where(fy_, torch.where(y > 0, 2, 3),
                                   torch.where(z > 0, 4, 5)))
    sc = torch.where(fx_, torch.where(x > 0, -z, z),
                     torch.where(fy_, x, torch.where(z > 0, x, -x)))
    tc = torch.where(fx_, -y, torch.where(fy_, torch.where(y > 0, z, -z),
                                          -y))
    ma = torch.where(fx_, ax, torch.where(fy_, ay, az)).clamp(min=1e-12)
    r = cube.shape[1]
    fu = (sc / ma + 1) / 2 * r - 0.5
    fv = (tc / ma + 1) / 2 * r - 0.5
    u0, v0 = torch.floor(fu), torch.floor(fv)
    wu, wv = (fu - u0)[..., None], (fv - v0)[..., None]
    u0 = u0.long().clamp(0, r - 1)
    v0 = v0.long().clamp(0, r - 1)
    u1, v1 = (u0 + 1).clamp(max=r - 1), (v0 + 1).clamp(max=r - 1)
    c = ((1 - wv) * ((1 - wu) * cube[face, v0, u0] + wu * cube[face, v0, u1])
         + wv * ((1 - wu) * cube[face, v1, u0] + wu * cube[face, v1, u1]))
    return c.clamp(0.0, 1.0).permute(2, 0, 1)


def frame(s: dict, view: View, meta: dict, form: Form = Form(),
          count: bool = False):
    """The composite [3, H, W] image of a view (and, with `count`, the
    blend's `raster.BlendCounts`). `meta`: width, height, K, tile_x,
    tile_y, sh_degree, fourier_scale."""
    with no_tf32():
        g = compose(s, view, meta, form)
        dev = g["means"].device
        W, H = meta["width"], meta["height"]
        cam = camera(view, meta["K"], W, H, dev)
        colors = torch.cat([g["colors"], torch.ones_like(g["colors"][:, :1])],
                           1)
        out = raster.render(g["means"], g["scales"], g["quats"],
                            g["opacities"], colors, cam,
                            tile_x=meta["tile_x"], tile_y=meta["tile_y"],
                            bg=torch.zeros(4, device=dev), count=count,
                            field_dtype=form.field_dtype)
        planes, counts = out if count else (out, None)
        rgb, acc = planes[:3], planes[3:]
        if form.sky:
            rgb = rgb + sky(s["sky"], view, meta["K"], W, H) * (1.0 - acc)
        rgb = rgb.clamp(0.0, 1.0)
    return (rgb, counts) if count else rgb


# -- the detector and the loop -----------------------------------------

def boxes(s: dict, view: View, meta: dict,
          field_dtype: torch.dtype | None = None) -> list:
    """Normalised (cx, cy, w, h) of each alive actor's projected box, in
    actor order; `field_dtype` rounds the poses first (the control)."""
    trans, rots, alive = actor_poses(s, view.t)
    if field_dtype is not None:
        trans = trans.to(field_dtype).float()
        rots = rots.to(field_dtype).float()
    rm = raster._rotation(rots).double().cpu().numpy()
    tr = trans.double().cpu().numpy()
    dims = s["bbox"].double().cpu().numpy()
    ego = np.asarray(view.ego, np.float64)
    V = np.asarray(view.R, np.float32).astype(np.float64).T
    T = np.asarray(view.T, np.float32).astype(np.float64)
    K = np.asarray(meta["K"], np.float64)
    W, H = meta["width"], meta["height"]
    sign = np.array([[a, b, c] for a in (-1, 1) for b in (-1, 1)
                     for c in (-1, 1)], np.float64)
    out = []
    for o in range(tr.shape[0]):
        if not bool(alive[o]):
            continue
        r_w = ego[:3, :3] @ rm[o]
        t_w = ego[:3, :3] @ tr[o] + ego[:3, 3]
        pts = (sign * dims[o] / 2) @ r_w.T + t_w
        pts = pts @ V.T + T
        if np.all(pts[:, 2] <= MIN_DEPTH):
            continue
        pts = pts[pts[:, 2] > MIN_DEPTH]
        uv = pts @ K.T
        uv = uv[:, :2] / uv[:, 2:3]
        u0, v0 = np.clip(uv[:, 0].min(), 0, W), np.clip(uv[:, 1].min(), 0, H)
        u1, v1 = np.clip(uv[:, 0].max(), 0, W), np.clip(uv[:, 1].max(), 0, H)
        if u1 - u0 < MIN_BOX_PX or v1 - v0 < MIN_BOX_PX:
            continue
        out.append(((u0 + u1) / 2 / W, (v0 + v1) / 2 / H, (u1 - u0) / W,
                    (v1 - v0) / H))
    return out


def replay(boxes_at, *, positions: list, times: list, rate: int,
           dynamics_hz: float, episode_s: float, gap_at,
           brake_distance: float, collision_m: float, K: np.ndarray,
           v2c: np.ndarray, hw: tuple, cam_height: float) -> aeb.Episode:
    """The episode the loop should run: the planned world->camera
    translations and timestamps of the rendered frames interpolated to
    the dynamics rate; once the AEB brakes the camera moves along its -z
    at the speed the commands leave it. Each image tick checks the
    verdict (success past `episode_s`, collision where `gap_at(k, pos)`
    falls below `collision_m`), then takes `boxes_at(k, pos)`, ranges
    them on the ground plane and brakes for the nearest in-lane one
    (kept until another is seen)."""
    dt = 1.0 / dynamics_hz
    ticks_pos, ticks_t = [], []
    for k in range(len(positions) - 1):
        p0, p1 = np.asarray(positions[k]), np.asarray(positions[k + 1])
        for j in range(rate):
            ticks_pos.append(p0 + j * ((p1 - p0) / rate))
            ticks_t.append(times[k] + j * ((times[k + 1] - times[k]) / rate))
    ticks_pos.append(np.asarray(positions[-1]))
    ticks_t.append(times[-1])
    n = len(ticks_pos)

    last, speed, cmd, braking = ticks_pos[0], 0.0, 0.0, False
    z_prev, t_prev, lon_speed, cipv = None, None, 0.0, math.inf
    frames, verdict, i = [], None, 0
    while verdict is None and i < int((episode_s + 2.0) * dynamics_hz):
        pos = ticks_pos[min(i, n - 1)]
        t = ticks_t[i] if i < n else ticks_t[-1] + (i - n + 1) * dt
        if braking:
            v = max(speed + cmd * dt, 0.0)
            pos = last + v * dt * np.array([0.0, 0.0, -1.0])
        speed = float(np.linalg.norm(pos - last)) / dt
        last = pos
        if t_prev is not None and t - t_prev > 0:
            lon_speed = (z_prev - pos[2]) / (t - t_prev)
        z_prev, t_prev = pos[2], t
        if i % rate == 0:
            k = i // rate
            if t - ticks_t[0] > episode_s:
                verdict = "success"
            elif gap_at(k, pos) < collision_m:
                verdict = "collision"
        if i % rate == 0 and verdict is None:
            bx = boxes_at(k, pos)
            objects = [aeb.ground_range(b, K, v2c, hw, cam_height)
                       for b in bx]
            lane = [r for r, lat in objects
                    if r > 0 and -aeb.CIPV_LAT_M < lat < aeb.CIPV_LAT_M]
            if lane:
                cipv = min(lane)
            brake = aeb.brake_command(cipv, lon_speed, brake_distance)
            if brake != 0.0:
                braking, cmd = True, brake
            frames.append(aeb.Frame(len(bx), brake, pos.copy()))
        i += 1
    return aeb.Episode(verdict or "timeout", frames)
