"""Shared helpers for the port's parity tests (tests/test_torch_*.py): the
same numpy inputs go to the JAX package and to `gaussianrpg_tpu_torch`.
Not a test module."""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import pytest
import torch

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_cpu_thread():
    """One torch CPU thread for the tests of a module that imports this
    fixture, restored afterwards. The suite runs under pytest-xdist,
    several workers on one host; each worker's default OpenMP pool (one
    thread per core) oversubscribes the cores, and PyTorch's many small CPU
    ops then stall in spin-waits (the closed-loop tests ran 60x slower
    that way)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def cam_pose(seed):
    """(R, T) of `conftest.make_test_camera`: identity, or a small random
    rotation + translation."""
    if seed is None:
        return np.eye(3), np.zeros(3)
    rr = np.random.default_rng(seed)
    w = 0.2 * rr.standard_normal(3)
    th = np.linalg.norm(w)
    k = w / (th + 1e-12)
    K_ = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    R = np.eye(3) + math.sin(th) * K_ + (1 - math.cos(th)) * (K_ @ K_)
    return R, 0.5 * rr.standard_normal(3)


def camera_pair(width=64, height=48, seed=None, fov_deg=60.0):
    """The same camera in both packages."""
    from gaussianrpg_tpu.render.camera import make_camera as jcam

    from gaussianrpg_tpu_torch.render.camera import make_camera as tcam

    fovx = math.radians(fov_deg)
    fovy = 2 * math.atan(math.tan(fovx / 2) * height / width)
    R, T = cam_pose(seed)
    kw = dict(R=R, T=T, K=None, width=width, height=height, fovx=fovx,
              fovy=fovy)
    return jcam(**kw), tcam(**kw, device="cpu")


def tt(x):
    """numpy (or JAX) array -> CPU tensor."""
    return torch.as_tensor(np.array(x))


def tree_of(obj):
    """Walk a JAX flax dataclass (or dict) into nested dicts of numpy
    arrays and python values, keyed by field name."""
    if obj is None:
        return None
    if dataclasses.is_dataclass(obj):
        return {f.name: tree_of(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: tree_of(v) for k, v in obj.items()}
    if hasattr(obj, "shape") and hasattr(obj, "dtype"):
        return np.asarray(obj)
    return obj


def assert_planes(got, ref, *, atol=1e-5, skip=None):
    """The JAX package's blend tolerances (tests/test_pallas.py:43-52:
    rtol 1e-4, atol 1e-5; depth atol 1e-4) on every pixel outside the
    boolean [H, W] mask `skip`."""
    got, ref = np.asarray(got), np.asarray(ref)
    if skip is not None:
        keep = np.broadcast_to(~np.asarray(skip), got.shape)
        got, ref = got[keep], ref[keep]
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=atol)


def threshold_pixels(fields, radii, depths, width, height, skip_rel=1e-5,
                     stop_rel=3e-5):
    """[H, W] mask of pixels where the blend takes a decision within float32
    rounding of its threshold, found in float64 from the per-Gaussian
    fields: a pair whose op*exp(power) is within `skip_rel` of 1/255 (the
    skip test; an exp ulp plus the power's rounding is ~1e-6) or whose
    T*(1-alpha) is within `stop_rel` of 1e-4 (the stop test; T carries the
    rounding of every earlier factor).
    Two float32 implementations (XLA's exp and PyTorch's differ by an ulp)
    may decide such a pixel either way; everywhere else they must agree
    to the tolerance."""
    f = np.asarray(fields, np.float64)
    r = np.asarray(radii)
    order = np.argsort(np.where(r > 0, np.asarray(depths), np.inf),
                       kind="stable")
    py, px = np.meshgrid(np.arange(height, dtype=np.float64),
                         np.arange(width, dtype=np.float64), indexing="ij")
    T = np.ones_like(px)
    alive = np.ones(px.shape, bool)
    near = np.zeros(px.shape, bool)
    for i in order:
        if r[i] <= 0:
            break
        mx, my, ca, cb, cc, op = f[i, :6]
        dx, dy = mx - px, my - py
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        ar = op * np.exp(np.minimum(power, 0.0))
        near |= alive & (power <= 0) & (np.abs(ar * 255.0 - 1.0) < skip_rel)
        use = alive & (power <= 0) & (ar >= 1.0 / 255.0)
        test_t = T * (1.0 - np.minimum(ar, 0.99))
        near |= use & (np.abs(test_t * 1e4 - 1.0) < stop_rel)
        stop = use & (test_t < 1e-4)
        T = np.where(use & ~stop, test_t, T)
        alive &= ~stop
    return near


# ------------------------------------------------- a Waymo scene directory

# camera -> vehicle rotation of a forward camera with OpenCV axes (camera
# z = vehicle x, camera x = -vehicle y, camera y = -vehicle z)
CAM2VEH = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
SCENE_TRACKS = {          # track id -> class, (h, w, l), world xyz at f
    3: ("vehicle", (1.6, 1.9, 4.5), lambda f: (12.0 + 1.5 * f, 0.3, 0.8)),
    5: ("vehicle", (1.5, 1.8, 4.2), lambda f: (20.0, -4.0, 0.75)),
    8: ("pedestrian", (1.8, 0.6, 0.6), lambda f: (15.0, 3.0 - 0.5 * f, 0.9)),
}
MOVING_TRACKS = (3, 8)
PARKED_TRACK = 5


def _box_points(rng, dims, n):
    h, w, l = dims
    return rng.uniform(-0.45, 0.45, (n, 3)) * np.array([l, w, h])


def write_test_scene(root, n_frames=6, width=128, height=96, seed=0):
    """A scene directory in the converter's layout (written by the port's
    `utils/waymo_layout`): `n_frames` frames of the FRONT camera at
    width x height, an ego driving 1 m a frame along world x, a moving
    vehicle (track 3), a parked one (5, static: dropped on load) and a
    walking pedestrian (8); sky masks, LiDAR depth and mono-normal .npy
    planes, semantic PNGs, and a `pointcloud.npz` (no input_ply: the
    loaders build the PLYs from it). Returns the intrinsic matrix."""
    from gaussianrpg_tpu_torch.utils.waymo_layout import write_waymo_scene

    rng = np.random.default_rng(seed)
    K = np.array([[100.0, 0, width / 2], [0, 100.0, height / 2], [0, 0, 1]])
    intr = np.tile([100.0, 100.0, width / 2, height / 2, 0, 0, 0, 0, 0],
                   (5, 1))
    ext = np.tile(np.eye(4), (5, 1, 1))
    for cam in range(5):
        yaw = [0.0, 0.8, -0.8, 1.6, -1.6][cam]
        rz = np.array([[math.cos(yaw), -math.sin(yaw), 0],
                       [math.sin(yaw), math.cos(yaw), 0], [0, 0, 1]])
        ext[cam, :3, :3] = rz @ CAM2VEH
        ext[cam, :3, 3] = (1.5, 0.0, 1.8)
    ego = np.tile(np.eye(4), (n_frames, 1, 1))
    ego[:, 0, 3] = np.arange(n_frames) * 1.0 + 100.0
    ego[:, 2, 3] = 0.3
    tracks, vis = [], {}
    for tid, (cls, dims, at) in SCENE_TRACKS.items():
        for f in range(n_frames):
            x, y, z = np.asarray(at(f)) - (f * 1.0, 0.0, 0.0)
            heading = 1.57 if cls == "pedestrian" else 0.02 * f
            tracks.append((f, tid, cls, *dims, round(x, 4), round(y, 4),
                           round(z, 4), heading, 1.0))
            vis.setdefault(tid, {})[f] = [0]

    yy, xx = np.mgrid[0:height, 0:width]
    w2c_cam = np.linalg.inv(ext[0])
    images, sky, depth, normal, sem = {}, {}, {}, {}, {}
    pts3d, pts2d = {}, {}
    for f in range(n_frames):
        base = np.stack([(xx * 2 + yy + 40 * c + 9 * f) % 256
                         for c in range(3)], -1)
        images[f, 0] = np.clip(base + rng.integers(0, 25, base.shape), 0,
                               255).astype(np.uint8)
        sky[f, 0] = (yy < height // 3) & (rng.random(yy.shape) < 0.95)
        d = rng.uniform(4.0, 40.0, (height, width)).astype(np.float32)
        d[rng.random(d.shape) > 0.12] = 0.0
        depth[f, 0] = d
        nrm = rng.standard_normal((height, width, 3)).astype(np.float32)
        normal[f, 0] = nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)
        s = (yy * 3 // height).astype(np.uint8)
        s[rng.random(s.shape) < 0.05] = 255
        sem[f, 0] = s
        # LiDAR: a ground grid and each box's interior, vehicle frame
        gx, gy = np.meshgrid(np.arange(5.0, 20.0, 0.25),
                             np.arange(-4.0, 4.0, 0.25), indexing="ij")
        pts = [np.stack([gx.ravel(), gy.ravel(),
                         np.zeros(gx.size) - 0.02 * f], -1)]
        for tid, (cls, dims, at) in SCENE_TRACKS.items():
            row = [t for t in tracks if t[0] == f and t[1] == tid][0]
            c, s_ = math.cos(row[9]), math.sin(row[9])
            rot = np.array([[c, -s_, 0], [s_, c, 0], [0, 0, 1]])
            pts.append(_box_points(rng, dims, 120) @ rot.T
                       + np.asarray(row[6:9]))
        p = np.concatenate(pts)
        pc = np.c_[p, np.ones(len(p))] @ w2c_cam.T
        uv = pc[:, :3] @ K.T
        uv = uv[:, :2] / np.maximum(uv[:, 2:3], 1e-3)
        proj = np.zeros((len(p), 6), np.int16)
        proj[:, 1] = np.clip(uv[:, 0], -1, width).astype(np.int16)
        proj[:, 2] = np.clip(uv[:, 1], -1, height).astype(np.int16)
        pts3d[f], pts2d[f] = p.astype(np.float32), proj
    write_waymo_scene(
        str(root), ego_poses=ego, intrinsics=intr, extrinsics=ext,
        timestamps=1.5e9 + 0.1 * np.arange(n_frames), tracks=tracks,
        camera_vis=vis, images=images, sky_masks=sky, lidar_depth=depth,
        mono_normal=normal, semantic=sem, pointcloud=(pts3d, pts2d))
    return K
