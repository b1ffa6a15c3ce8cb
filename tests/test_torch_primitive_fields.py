"""The rasterizer's primitive stage on its two routes: the hand-written
kernel `csrc/primitive_fields.cu` (ops/fields.py) for a card's eval call,
the PyTorch composition (`rasterize.primitive_fields_plain`) for every
other call.

On the CPU: the router's choice (the composition for CPU tensors, for a
call autograd records and for each train hook; the kernel for an eval
call on the card, the launch stood in for), the wrapper's refusals, and
the render graph's counter. On the card (marked `cuda`): the kernel's
FieldSet against the composition's, bit for bit, on the street slot
layout, a frozen-style scene at 64x32, semantics widths 0, 3 and 13, a
precomputed covariance, the loose rect with a scale modifier, and rows
behind the near plane, with a zero determinant, below 1/255 opacity and
on the image border; a graph replay over 20 poses, one launch a frame.
This file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_primitive_fields.py
"""
import math

import numpy as np
import pytest
import torch

from gaussianrpg_tpu_torch.ops import fields, raster_graph
from gaussianrpg_tpu_torch.ops import rasterize as R
from gaussianrpg_tpu_torch.render.camera import make_camera

from .torch_parity import one_cpu_thread  # noqa: F401  (autouse fixture)

OUTPUTS = ("fields", "rect_min", "rect_max", "radii", "depths", "means2d")


def _camera(device, width, height, fov=60.0, pose=0.0, back=0.0):
    """A camera looking down +z, turned by `pose` degrees about y, with
    the world origin `back` metres in front of it."""
    a = math.radians(pose)
    R_ = np.array([[math.cos(a), 0, math.sin(a)], [0, 1, 0],
                   [-math.sin(a), 0, math.cos(a)]])
    fovx = math.radians(fov)
    fovy = 2 * math.atan(math.tan(fovx / 2) * height / width)
    return make_camera(R=R_, T=np.array([0.0, 0.0, back]), K=None,
                       width=width, height=height, fovx=fovx, fovy=fovy,
                       device=device)


def _gaussians(rng, n, lo, hi, log_scale=(-3.5, -1.0)):
    q = rng.standard_normal((n, 4))
    return dict(means3d=rng.uniform(lo, hi, (n, 3)),
                opacities=rng.uniform(0.02, 0.99, n),
                colors=rng.uniform(0, 1, (n, 3)),
                scales=np.exp(rng.uniform(*log_scale, (n, 3))),
                rotations=q * rng.uniform(0.5, 2.0, (n, 1)))


def _cat(parts):
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def _to(host, device):
    return {k: torch.as_tensor(v, device=device,
                               dtype=torch.bool if v.dtype == bool
                               else torch.float32)
            for k, v in host.items()}


def street(device, n=300_000, shown=40_000, actors=2, per_actor=2048):
    """The street scene's slot layout at a few hundred thousand rows:
    background slots (the first `shown` live), then each actor's slots
    (three quarters live), ~85% of all rows inactive; inactive slots
    padded as `init_from_points` pads them (origin, scale e^-20, identity
    rotation, opacity sigmoid(-20)) and masked out."""
    rng = np.random.default_rng(21)
    n_bg = n - actors * per_actor
    bg = _gaussians(rng, n_bg, (-20, -3, 2), (20, 2, 80))
    parts, mask = [bg], [np.arange(n_bg) < shown]
    for k in range(actors):
        c = np.array([3.0 * k - 1.5, 0.0, 15.0 + 8 * k])
        parts.append(_gaussians(rng, per_actor, c - 2, c + 2, (-4, -2)))
        mask.append(np.arange(per_actor) < 3 * per_actor // 4)
    host = _cat(parts)
    mask = np.concatenate(mask)
    host["means3d"][~mask] = 0.0
    host["scales"][~mask] = math.exp(-20.0)
    host["rotations"][~mask] = [1.0, 0.0, 0.0, 0.0]
    host["opacities"][~mask] = 1.0 / (1.0 + math.exp(20.0))
    host["active_mask"] = mask
    return _camera(device, 640, 384, pose=3.0, back=5.0), _to(host, device)


def frozen(device):
    """The frozen bench scene (600,000 Gaussians, 1600x1066)."""
    from gaussianrpg_tpu_torch.utils.synthetic import build_frozen_scene

    cam, (means, opac, colors, scales, quats), _, _ = build_frozen_scene(
        device)
    return cam, dict(means3d=means, opacities=opac, colors=colors,
                     scales=scales, rotations=quats)


def random_scene(device, s_ch=0, n=20_000, seed=4):
    rng = np.random.default_rng(seed)
    host = _gaussians(rng, n, (-4, -3, 0.5), (4, 3, 12))
    if s_ch:
        host["semantics"] = rng.normal(0, 1, (n, s_ch))
    return _camera(device, 320, 192, pose=-4.0), _to(host, device)


def _border_and_near(rng, n):
    """Rows whose means sit on the image border and just beyond it, and
    rows at, behind and just in front of the 0.2 near plane."""
    z = rng.uniform(1, 10, n)
    t = math.tan(math.radians(30.0))
    edge = rng.choice([-1.0, 1.0], n) * t * z * rng.choice(
        [1.0, 1.0 - 1e-3, 1.0 + 1e-3, 1.02], n)
    other = rng.uniform(-0.5, 0.5, n) * t * z
    xy = np.where(rng.uniform(size=(n, 1)) < 0.5,
                  np.stack([edge, other], -1), np.stack([other, edge], -1))
    border = np.concatenate([xy, z[:, None]], -1)
    near = np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n),
                     rng.choice([-2.0, -1e-3, 0.0, 0.1, 0.2, 0.2001, 0.3],
                                n)], -1)
    return np.concatenate([border, near])


def edges(device):
    """Rows behind the near plane, with a zero determinant (a rank-one
    covariance on the optical axis of a square camera: c00 = c01 = c11),
    with opacity under 1/255 and on the image border; every row's
    covariance precomputed."""
    rng = np.random.default_rng(8)
    cam = _camera(device, 96, 96, fov=60.0)
    cam = cam.replace(tan_fovy=cam.tan_fovx)    # focal_y == focal_x
    n = 4000
    g = _gaussians(rng, n, (-2, -2, 0.5), (2, 2, 8))
    g["means3d"][: n // 2] = _border_and_near(rng, n // 4)
    # world covariance R S^2 R^T of each row, then the degenerate rows
    q = g["rotations"] / np.linalg.norm(g["rotations"], axis=-1,
                                        keepdims=True)
    w, x, y, z = q.T
    rot = np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                    2 * (x * z + w * y), 2 * (x * y + w * z),
                    1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
                    2 * (x * z - w * y), 2 * (y * z + w * x),
                    1 - 2 * (x * x + y * y)], -1).reshape(n, 3, 3)
    m = rot * g["scales"][:, None, :]
    sig = m @ m.transpose(0, 2, 1)
    cov = sig[:, [0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]]
    degenerate = np.arange(n - 200, n)
    g["means3d"][degenerate] = np.stack(
        [np.zeros(200), np.zeros(200), rng.uniform(1, 20, 200)], -1)
    cov[degenerate] = [1e10, 1e10, 0.0, 1e10, 0.0, 0.0]
    g["cov3d_precomp"] = cov
    g["opacities"][rng.choice(n, 400, replace=False)] = rng.choice(
        [0.0, 1e-4, 1 / 255 - 1e-6, 1 / 255, 1 / 255 + 1e-6], 400)
    del g["scales"], g["rotations"]
    return cam, _to(g, device)


def _plain(cam, scene, scale_modifier=1.0, tile_x=16, tile_y=16,
           tight_rect=True):
    s = dict(scene)
    sem = s.get("semantics")
    out = R.primitive_fields_plain(
        s["means3d"], s["opacities"].reshape(-1), camera=cam,
        colors=s["colors"], semantics=sem, scales=s.get("scales"),
        rotations=s.get("rotations"), cov3d_precomp=s.get("cov3d_precomp"),
        scale_modifier=scale_modifier, means2d_offset=None,
        absgrad_sink=None, active_mask=s.get("active_mask"), tile_x=tile_x,
        tile_y=tile_y, tight_rect=tight_rect)
    return R.FieldSet(*out, s_ch=0 if sem is None else sem.shape[1],
                      tile_x=tile_x, tile_y=tile_y)


def _routed(cam, scene, **kw):
    s = dict(scene)
    return R.primitive_fields(s.pop("means3d"), s.pop("opacities"),
                              camera=cam, **s, **kw)


def _assert_same_bits(got, ref, scene):
    """Every output equal bit for bit (floats compared as their bits, so
    -0.0 differs from +0.0); on a difference, the first row's inputs and
    both rows."""
    assert got.s_ch == ref.s_ch
    for name in OUTPUTS:
        a, b = getattr(got, name), getattr(ref, name)
        assert a.shape == b.shape and a.dtype == b.dtype, name
        bits_a = a.view(torch.int32) if a.is_floating_point() else a
        bits_b = b.view(torch.int32) if b.is_floating_point() else b
        bad = bits_a != bits_b
        if bad.dim() > 1:
            bad = bad.any(-1)
        if bad.any():
            i = int(torch.nonzero(bad)[0])
            row = {k: v[i].tolist() for k, v in scene.items()}
            pytest.fail(f"{name}: {int(bad.sum())} of {bad.numel()} rows "
                        f"differ; row {i}: kernel {a[i].tolist()}, "
                        f"composition {b[i].tolist()}; inputs {row}")


# -- on the CPU --------------------------------------------------------------

def _stubbed(monkeypatch, cam):
    """The kernel's launch stood in for by the composition's answer for
    camera `cam`; the launch arguments of the calls that reached it."""
    calls = []

    def launch(means3d, opacities, colors, semantics, scales, rotations,
               cov3d, mask, view, proj, **kw):
        calls.append(kw)
        assert view.data_ptr() == cam.viewmatrix.data_ptr()
        return R.primitive_fields_plain(
            means3d, opacities, camera=cam, colors=colors,
            semantics=semantics, scales=scales, rotations=rotations,
            cov3d_precomp=cov3d, scale_modifier=kw["scale_modifier"],
            means2d_offset=None, absgrad_sink=None, active_mask=mask,
            tile_x=kw["tile_x"], tile_y=kw["tile_y"],
            tight_rect=bool(kw["tight"]))

    monkeypatch.setattr(fields, "_launch", launch)
    return calls


def test_the_router_takes_the_composition_on_the_cpu(monkeypatch):
    cam, scene = random_scene("cpu", s_ch=3, n=500)
    calls = _stubbed(monkeypatch, cam)
    got = _routed(cam, scene)
    assert not calls
    _assert_same_bits(got, _plain(cam, scene), scene)


@pytest.mark.parametrize("case", ["eval", "no_grad", "means3d_grad",
                                  "colors_grad", "camera_grad",
                                  "means2d_offset", "absgrad_sink"])
def test_the_router_on_the_card(case, monkeypatch):
    """With the card's device type stood in for by the CPU's: an eval
    call, and one whose inputs need grad under no_grad, take the kernel
    (one launch, the composition's bits); a call autograd records, or
    that passes a train hook, takes the composition."""
    cam, scene = random_scene("cpu", s_ch=3, n=500)
    calls = _stubbed(monkeypatch, cam)
    monkeypatch.setattr(fields, "CARD", "cpu")
    kw = {}
    if case in ("no_grad", "means3d_grad"):
        scene["means3d"].requires_grad_(True)
    if case == "colors_grad":
        scene["colors"].requires_grad_(True)
    if case == "camera_grad":
        cam.viewmatrix.requires_grad_(True)
    if case == "means2d_offset":
        kw["means2d_offset"] = torch.zeros(500, 2)
    if case == "absgrad_sink":
        kw["absgrad_sink"] = torch.zeros(500)
    with torch.set_grad_enabled(case != "no_grad"):
        got = _routed(cam, scene, **kw)
    kernel = case in ("eval", "no_grad")
    assert len(calls) == (1 if kernel else 0)
    if kernel:
        assert calls[0]["nf"] == 16 and calls[0]["s_ch"] == 3
        with torch.no_grad():
            _assert_same_bits(got, _plain(cam, scene), scene)
    else:
        assert got.fields.requires_grad == case.endswith("_grad")


def test_the_kernel_takes_spherical_harmonics_as_colours(monkeypatch):
    """With `shs` given, the colours are evaluated first and handed to
    the kernel: the same FieldSet as the composition's route."""
    cam, scene = random_scene("cpu", n=300)
    calls = _stubbed(monkeypatch, cam)
    del scene["colors"]
    shs = torch.randn(300, 4, 3, generator=torch.Generator().manual_seed(2))
    ref = _routed(cam, scene, shs=shs, sh_degree=1)
    monkeypatch.setattr(fields, "CARD", "cpu")
    got = _routed(cam, scene, shs=shs, sh_degree=1)
    assert len(calls) == 1
    _assert_same_bits(got, ref, scene)


@pytest.mark.parametrize("bad,error", [
    ("means3d_f64", TypeError), ("opacities_shape", ValueError),
    ("rotations_shape", ValueError), ("semantics_1d", ValueError),
    ("mask_float", TypeError), ("view_f64", TypeError)])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(bad, error,
                                                          monkeypatch):
    cam, scene = random_scene("cpu", s_ch=3, n=100)
    calls = _stubbed(monkeypatch, cam)
    monkeypatch.setattr(fields, "CARD", "cpu")
    scene["active_mask"] = torch.ones(100, dtype=torch.bool)
    if bad == "means3d_f64":
        scene["means3d"] = scene["means3d"].double()
    if bad == "opacities_shape":
        scene["opacities"] = scene["opacities"][:99]
    if bad == "rotations_shape":
        scene["rotations"] = scene["rotations"][:, :3]
    if bad == "semantics_1d":
        scene["semantics"] = scene["semantics"][:, 0]
    if bad == "mask_float":
        scene["active_mask"] = scene["active_mask"].float()
    if bad == "view_f64":
        cam = cam.replace(viewmatrix=cam.viewmatrix.double())
    with pytest.raises(error):
        _routed(cam, scene)
    assert not calls


def test_replays_advance_the_fields_counter():
    """The kernel's launch counter is among those a replay of the
    render's CUDA graph advances."""
    assert (fields, "launches") in raster_graph.COUNTERS


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    raster_graph.release()
    yield torch.device("cuda")
    raster_graph.release()


CASES = {
    "street_16x16": (street, {}, {}),
    "frozen_64x32": (frozen, {}, dict(tile_x=64, tile_y=32)),
    "sem0": (random_scene, dict(s_ch=0), {}),
    "sem3": (random_scene, dict(s_ch=3), dict(tile_x=64, tile_y=32)),
    "sem13": (random_scene, dict(s_ch=13), {}),
    "loose_scaled": (random_scene, {}, dict(tight_rect=False,
                                            scale_modifier=0.7)),
    "edges_precomputed": (edges, {}, {}),
    "edges_loose": (edges, {}, dict(tight_rect=False, tile_x=8, tile_y=8)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_the_kernel_equals_the_composition(cuda, case):
    build, scene_kw, kw = CASES[case]
    cam, scene = build(cuda, **scene_kw)
    with torch.no_grad():
        n0 = fields.launches
        got = _routed(cam, scene, **kw)
        torch.cuda.synchronize()
        assert fields.launches == n0 + 1
        ref = _plain(cam, scene, **kw)
    assert got.fields.shape[1] == R._round_up(
        R.NF_BASE + got.s_ch, 8) and got.fields.is_contiguous()
    _assert_same_bits(got, ref, scene)
    assert int((ref.radii > 0).sum()) > 0
    if case.startswith("edges"):
        # the cases the rows were drawn for do occur
        vz = ref.depths
        assert bool((vz <= 0.2).any()) and bool((vz > 0.2).any())
        conic_zero = (ref.fields[:, 2:5] == 0).all(-1)
        assert bool((conic_zero & (vz > 0.2)).any())
    if case == "street_16x16":
        assert not bool(ref.radii[~scene["active_mask"]].any())


@pytest.mark.cuda
def test_graph_replays_over_20_poses_launch_once_a_frame(cuda):
    """Rendered through the render's CUDA graph over 20 poses, each frame
    advances the kernel's counter by one (the eager call and the capture
    call by one and two), and each replay's radii and means equal the
    composition's for that pose: the kernel reads the camera the replay
    copied in. The trace's kernel records agree with the counter."""
    from gaussianrpg_tpu_torch.tools._timing import kernel_trace

    _, scene = random_scene(cuda, n=30_000)
    bg = torch.zeros(3, device=cuda)
    deltas, trace = [], []
    with torch.no_grad():
        for pose in range(20):
            cam = _camera(cuda, 320, 192, pose=pose - 10.0)
            n0 = fields.launches
            out = R.rasterize(camera=cam, bg_color=bg, capacity=1 << 18,
                              device="cuda", **scene)
            torch.cuda.synchronize()
            deltas.append(fields.launches - n0)
            ref = _plain(cam, scene)
            assert torch.equal(out.radii, ref.radii)
            assert torch.equal(out.means2d.view(torch.int32),
                               ref.means2d.view(torch.int32))
            with R.eager():
                eager = R.rasterize(camera=cam, bg_color=bg,
                                    capacity=1 << 18, device="cuda", **scene)
            for x, y in zip(out, eager):
                assert torch.equal(x, y)
        r0 = R.graph_counts["replays"]
        n0 = fields.launches
        trace.extend(kernel_trace(lambda: R.rasterize(
            camera=cam, bg_color=bg, capacity=1 << 18, device="cuda",
            **scene), reps=3))
        traced = fields.launches - n0
    # pose 0 runs eagerly, pose 1 warms up and captures (two runs), the
    # rest replay; the eager renders in between leave the graph alone
    assert deltas == [1, 2] + [1] * 18
    assert R.graph_counts["replays"] == r0 + 7
    assert traced == 7
    records = sum(k["launches_per_call"] for k in trace
                  if "primitive_fields" in k["name"])
    assert records == 1
