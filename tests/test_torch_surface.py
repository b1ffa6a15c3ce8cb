"""The port's last public functions held against the JAX package on the
CPU: quaternion, covariance and SE(3) helpers of `ops/math3d.py`,
`ops/sh.num_sh_coeffs` / `sh_to_rgb`, `ops/binning.depth_order`,
`render/camera.camera_from_c2w`, `models/scene_graph.submodel_slices`,
`models/sky.cubemap_to_latlong` (integers exactly, floats at rtol 1e-6, or
1e-5 where the JAX function is float32 trigonometry), the `Detector`
protocol satisfied by the port's detectors, and `apps/profile_trace` with
the JAX app's flags."""
import json
import math
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from gaussianrpg_tpu.models import scene_graph as jsg  # noqa: E402
from gaussianrpg_tpu.models import sky as jsky  # noqa: E402
from gaussianrpg_tpu.ops import binning as jbin  # noqa: E402
from gaussianrpg_tpu.ops import math3d as jm  # noqa: E402
from gaussianrpg_tpu.ops import sh as jsh  # noqa: E402
from gaussianrpg_tpu.render import camera as jcam  # noqa: E402
from gaussianrpg_tpu.utils import synthetic as jsyn  # noqa: E402

from gaussianrpg_tpu_torch.apps import profile_trace  # noqa: E402
from gaussianrpg_tpu_torch.models import scene_graph as tsg  # noqa: E402
from gaussianrpg_tpu_torch.models import sky as tsky  # noqa: E402
from gaussianrpg_tpu_torch.models.convert import scene_from_tree  # noqa: E402
from gaussianrpg_tpu_torch.ops import binning as tbin  # noqa: E402
from gaussianrpg_tpu_torch.ops import math3d as tm  # noqa: E402
from gaussianrpg_tpu_torch.ops import sh as tsh  # noqa: E402
from gaussianrpg_tpu_torch.render import camera as tcam  # noqa: E402
from gaussianrpg_tpu_torch.sim import detector as tdet  # noqa: E402

from .torch_parity import one_cpu_thread, tree_of, tt  # noqa: E402,F401

RTOL = 1e-6
RTOL_TRIG = 1e-5


def _rot(rng, n):
    q = rng.standard_normal((n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return q.astype(np.float32)


def _close(port, ref, rtol=RTOL):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(port), ref, rtol=rtol,
                               atol=rtol * (np.abs(ref).max() + 1e-30))


def _math3d_cases(rng):
    q = _rot(rng, 40)
    v = rng.standard_normal((40, 3)).astype(np.float32)
    s = np.exp(rng.uniform(-3, 0, (40, 3))).astype(np.float32)
    sym = rng.standard_normal((40, 3, 3)).astype(np.float32)
    sym = sym + np.swapaxes(sym, -1, -2)
    cov6 = rng.standard_normal((40, 6)).astype(np.float32)
    R1 = np.asarray(jm.quaternion_to_matrix(jnp.asarray(_rot(rng, 40))))
    R2 = np.asarray(jm.quaternion_to_matrix(jnp.asarray(_rot(rng, 40))))
    t1 = rng.standard_normal((40, 3)).astype(np.float32)
    t2 = rng.standard_normal((40, 3)).astype(np.float32)
    return {
        "quaternion_invert": (q,),
        "quaternion_rotate": (q, v),
        "build_scaling_rotation": (s, q),
        "strip_symmetric": (sym,),
        "unpack_sym6": (cov6,),
        "se3_compose": (R1, t1, R2, t2),
        "se3_inverse": (R1, t1),
    }


@pytest.mark.parametrize("name", list(_math3d_cases(
    np.random.default_rng(0))))
def test_math3d_function_matches_jax(name):
    args = _math3d_cases(np.random.default_rng(0))[name]
    ref = getattr(jm, name)(*map(jnp.asarray, args))
    got = getattr(tm, name)(*map(tt, args))
    refs = ref if isinstance(ref, tuple) else (ref,)
    gots = got if isinstance(got, tuple) else (got,)
    assert len(refs) == len(gots)
    for g, r in zip(gots, refs):
        assert tuple(g.shape) == tuple(r.shape)
        _close(g.numpy(), r)


def test_sh_helpers_match_jax():
    for d in range(5):
        assert tsh.num_sh_coeffs(d) == jsh.num_sh_coeffs(d)
    sh = np.random.default_rng(1).standard_normal((30, 16, 3)).astype(
        np.float32)
    _close(tsh.sh_to_rgb(tt(sh)).numpy(), jsh.sh_to_rgb(jnp.asarray(sh)))
    _close(tsh.sh_to_rgb(tsh.rgb_to_sh(tt(sh))).numpy(), sh, 1e-5)


def test_depth_order_matches_jax():
    """Stable (depth, id) order with culled Gaussians last, on depths with
    ties; exact."""
    rng = np.random.default_rng(2)
    depths = rng.integers(0, 20, 500).astype(np.float32) * 0.5
    radii = rng.integers(0, 4, 500).astype(np.int32)
    ref = jbin.depth_order(types.SimpleNamespace(
        depths=jnp.asarray(depths), radii=jnp.asarray(radii)))
    got = tbin.depth_order(types.SimpleNamespace(depths=tt(depths),
                                                 radii=tt(radii)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("seed", [0, 1])
def test_camera_from_c2w_matches_jax(seed):
    rng = np.random.default_rng(seed)
    w = 0.3 * rng.standard_normal(3)
    th = np.linalg.norm(w)
    k = w / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    c2w = np.eye(4)
    c2w[:3, :3] = np.eye(3) + math.sin(th) * Kx + (1 - math.cos(th)) * (
        Kx @ Kx)
    c2w[:3, 3] = 3.0 * rng.standard_normal(3)
    K = np.array([[700.0, 0.5, 321.0], [0.0, 690.0, 239.5], [0, 0, 1]],
                 np.float32)
    kw = dict(frame=3, image_id=7, timestamp=0.25)
    ref = jcam.camera_from_c2w(c2w, K, 640, 480, **kw)
    got = tcam.camera_from_c2w(c2w, K, 640, 480, device="cpu", **kw)
    for f in ("viewmatrix", "projmatrix", "cam_center", "K", "ego_pose",
              "extrinsic", "timestamp"):
        _close(getattr(got, f).numpy(), getattr(ref, f))
    assert (got.width, got.height) == (ref.width, ref.height)
    assert int(got.frame) == int(ref.frame) and \
        int(got.image_id) == int(ref.image_id)
    np.testing.assert_allclose([got.tan_fovx, got.tan_fovy],
                               [ref.tan_fovx, ref.tan_fovy], rtol=RTOL)


@pytest.mark.parametrize("include_background", [True, False])
def test_submodel_slices_match_jax(include_background):
    jm_, jmeta, jarr = jsyn.make_scene(
        n_background=100, bkgd_capacity=128, n_actors=3, actor_capacity=32,
        n_frames=4)
    tmodels, _, _ = scene_from_tree(
        {"models": tree_of(jm_), "meta": tree_of(jmeta),
         "arrays": tree_of(jarr)}, device="cpu")
    ref = jsg.submodel_slices(jm_, include_background)
    got = tsg.submodel_slices(tmodels, include_background)
    assert got == [(n, int(a), int(b)) for n, a, b in ref]
    assert len(got) == 3 + include_background


def test_cubemap_to_latlong_matches_jax():
    cube = np.random.default_rng(3).uniform(-0.2, 1.2, (6, 8, 8, 3)).astype(
        np.float32)
    ref = jsky.cubemap_to_latlong(jsky.SkyCubeMap(jnp.asarray(cube)), 16)
    got = tsky.cubemap_to_latlong(tsky.SkyCubeMap(tt(cube)), 16)
    assert got.shape == ref.shape == (16, 32, 3)
    _close(got, ref, RTOL_TRIG)


def test_detectors_satisfy_the_protocol():
    """The JAX package's `Detector` protocol: the port's detectors have
    its `detect(image_chw, camera)`; an object without it does not."""
    assert isinstance(tdet.BoxProjectionDetector(arrays=None,
                                                 actor_pose=None),
                      tdet.Detector)
    assert isinstance(tdet.YoloDetector(device="cpu"), tdet.Detector)
    assert not isinstance(object(), tdet.Detector)


def test_profile_trace_takes_the_jax_flags(tmp_path, capsys):
    """`profile_trace --steps 1 --width 64 --height 48 --logdir DIR` (the
    JAX app's flags) writes a chrome trace of one render and one train
    step of the JAX app's bench scene."""
    logdir = tmp_path / "prof"
    profile_trace.main(["--steps", "1", "--width", "64", "--height", "48",
                        "--logdir", str(logdir), "--device", "cpu"])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    rec = json.loads(lines[-1])
    assert rec["workload"] == "bench_scene" and rec["renders"] == 1
    assert rec["size"] == "64x48" and rec["device"] == "cpu"
    assert rec["host_ms"] > 0 and rec["top_ops"]
    trace = json.loads((logdir / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "_Blend" in names and any("Backward" in str(n) for n in names)
