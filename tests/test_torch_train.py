"""The port's trainer held against the JAX package on the CPU: losses,
Adam, densification statistics, opacity reset, capacity growth and
densify-and-prune (the random draws fed from JAX's keys through the port's
draw helpers), every loss term, and one full train step from an identical
composite state (actors with the symmetry flip, sky cube map with jittered
rays, colour correction, semantics): every parameter and Adam moment at
1e-4 of its leaf's max. Plus the port's own trainer behaviour, mirroring
tests/test_train.py: the loss goes down, an overflowed step is discarded
and retried, the opacity reset fans out to the actors."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from gaussianrpg_tpu.apps import train as japp  # noqa: E402
from gaussianrpg_tpu.models import gaussians as JG  # noqa: E402
from gaussianrpg_tpu.models.scene_graph import \
    total_capacity as j_total_capacity  # noqa: E402
from gaussianrpg_tpu.render import renderer as jren  # noqa: E402
from gaussianrpg_tpu.render.renderer import RenderResult  # noqa: E402
from gaussianrpg_tpu.train import losses as JL  # noqa: E402
from gaussianrpg_tpu.train import trainer as jtr  # noqa: E402
from gaussianrpg_tpu.utils import synthetic as jsyn  # noqa: E402

from gaussianrpg_tpu_torch.apps import train as tapp  # noqa: E402
from gaussianrpg_tpu_torch.models import gaussians as TG  # noqa: E402
from gaussianrpg_tpu_torch.models import scene_graph as tsg  # noqa: E402
from gaussianrpg_tpu_torch.models import sky as tsky  # noqa: E402
from gaussianrpg_tpu_torch.models.convert import scene_from_tree  # noqa: E402
from gaussianrpg_tpu_torch.ops import blend as tblend  # noqa: E402
from gaussianrpg_tpu_torch.ops import rasterize as TR  # noqa: E402
from gaussianrpg_tpu_torch.render import renderer as tren  # noqa: E402
from gaussianrpg_tpu_torch.train import losses as TL  # noqa: E402
from gaussianrpg_tpu_torch.train import trainer as ttr  # noqa: E402
from gaussianrpg_tpu_torch.utils import synthetic as tsyn  # noqa: E402

from .torch_parity import one_cpu_thread, tree_of, tt  # noqa: E402,F401

W, H = 64, 48
STATE_RTOL = 1e-4


def _params_t(jparams):
    return TG.GaussianParams(**{k: tt(v) for k, v in
                                tree_of(jparams).items()})


def _flat(tree, prefix=""):
    """{path: numpy array} of a nested dict of arrays."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


def _assert_trees(port, ref, rtol=STATE_RTOL, skip=(), resolved=None):
    """Every leaf within rtol of its max. With `resolved` ({path: bool
    mask}), a leaf is compared only where the mask holds."""
    a, b = _flat(tree_of(port)), _flat(tree_of(ref))
    assert set(a) == set(b), set(a) ^ set(b)
    for k in sorted(a):
        if any(k.startswith(s) for s in skip):
            continue
        x, y = a[k].astype(np.float64), b[k].astype(np.float64)
        assert x.shape == y.shape, k
        scale = np.abs(y).max() + 1e-30
        if resolved is not None:
            x, y = x[resolved[k]], y[resolved[k]]
        err = np.abs(x - y).max() if x.size else 0.0
        assert err <= rtol * scale, (k, err, scale)


# ----------------------------------------------------------------- losses

def test_losses_match_jax():
    rng = np.random.default_rng(0)
    a = rng.uniform(0, 1, (3, 40, 56)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(a.shape), 0, 1).astype(
        np.float32)
    mask = rng.random((1, 40, 56)) < 0.7
    for name in ("l1_loss", "l2_loss", "psnr"):
        for m in (None, mask):
            got = getattr(TL, name)(tt(a), tt(b),
                                    None if m is None else tt(m))
            ref = getattr(JL, name)(jnp.asarray(a), jnp.asarray(b),
                                    None if m is None else jnp.asarray(m))
            np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
    np.testing.assert_allclose(float(TL.ssim(tt(a), tt(b))),
                               float(JL.ssim(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-5)
    # SSIM's gradient too (the train step differentiates it)
    x = tt(a).requires_grad_(True)
    (g,) = torch.autograd.grad(TL.ssim(x, tt(b)), x)
    gj = jax.grad(lambda v: JL.ssim(v, jnp.asarray(b)))(jnp.asarray(a))
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), rtol=1e-4,
                               atol=1e-4 * float(np.abs(gj).max()))


def _result_pair(rng, s_ch=3):
    planes = dict(
        rgb=rng.uniform(0, 1, (3, H, W)), acc=rng.uniform(0.01, 0.99,
                                                          (1, H, W)),
        depth=rng.uniform(1, 20, (1, H, W)),
        semantic=rng.standard_normal((s_ch, H, W)),
        normals=rng.standard_normal((3, H, W)))
    planes = {k: v.astype(np.float32) for k, v in planes.items()}
    n = 50
    radii = rng.integers(0, 5, n).astype(np.int32)
    common = dict(viewspace_grad_sink=None)
    jres = RenderResult(**{k: jnp.asarray(v) for k, v in planes.items()},
                        radii=jnp.asarray(radii),
                        visibility=jnp.asarray(radii > 0), **common)
    tres = tren.RenderResult(
        **{k: tt(v) for k, v in planes.items()}, radii=tt(radii),
        visibility=tt(radii > 0), overflow=torch.tensor(False),
        n_pairs=torch.tensor(0))
    return jres, tres


@pytest.mark.parametrize("full_lidar", [False, True])
def test_compute_losses_every_term_matches_jax(full_lidar):
    """Every loss term of `compute_losses` on identical render results."""
    rng = np.random.default_rng(5)
    jm, jmeta, jarr = jsyn.make_scene(
        n_background=100, bkgd_capacity=128, n_actors=1, actor_capacity=32,
        n_frames=4, num_classes=3, use_color_correction=True,
        use_pose_correction=True)
    jm = jm.replace(
        color_correction=jm.color_correction.replace(
            affine=jm.color_correction.affine + 0.05),
        pose_correction=jm.pose_correction.replace(
            trans=jm.pose_correction.trans + 0.1))
    tm, tmeta, _ = scene_from_tree(
        {"models": tree_of(jm), "meta": tree_of(jmeta),
         "arrays": tree_of(jarr)}, device="cpu")
    jcam = jsyn.make_cameras(4, width=W, height=H)[2]
    tcam = tsyn.make_cameras(4, width=W, height=H, device="cpu")[2]
    jres, tres = _result_pair(rng)
    lidar = rng.uniform(1, 20, (1, H, W)).astype(np.float32)
    mask = None
    if not full_lidar:
        lidar[rng.random(lidar.shape) < 0.3] = 0.0
        mask = rng.random((1, H, W)) < 0.9
    planes = dict(
        gt_image=rng.uniform(0, 1, (3, H, W)).astype(np.float32), mask=mask,
        sky_mask=rng.random((1, H, W)) < 0.2, lidar_depth=lidar,
        gt_semantic=rng.integers(-1, 3, (1, H, W)).astype(np.int32),
        mono_normal=rng.standard_normal((3, H, W)).astype(np.float32),
        sky_scale=np.float32(0.7))
    jb = jtr.Batch(**{k: None if v is None else jnp.asarray(v)
                      for k, v in planes.items()})
    tb = ttr.Batch(**{k: None if v is None else tt(v)
                      for k, v in planes.items()})
    lam = dict(lambda_sky=0.3, lambda_semantic=0.5, lambda_depth_lidar=0.2,
               lambda_color_correction=0.1, lambda_pose_correction=0.1,
               lambda_scale_flatten=0.05, lambda_opacity_sparse=0.05,
               lambda_normal_mono=0.1)
    n = 50
    op = rng.uniform(0, 1, n).astype(np.float32)
    _, js = jtr.compute_losses(jres, jb, jm, jmeta, jtr.OptimConfig(**lam),
                               jres.visibility, jnp.asarray(op), camera=jcam)
    _, ts = ttr.compute_losses(tres, tb, tm, tmeta, ttr.OptimConfig(**lam),
                               tres.visibility, tt(op), camera=tcam)
    assert set(ts) == set(js)
    for k in js:
        np.testing.assert_allclose(float(ts[k]), float(js[k]), rtol=2e-5,
                                   err_msg=k)


# ----------------------------------------------------- optimizer, stats

def _jtiny():
    return jsyn.make_scene(n_background=600, bkgd_capacity=1024, n_actors=1,
                           actor_capacity=256, n_frames=4, sh_degree=1,
                           fourier_dim=2)


def test_adam_update_matches_jax():
    rng = np.random.default_rng(1)
    jm, _, _ = _jtiny()
    jp = jm.background
    grads = jax.tree.map(lambda x: jnp.asarray(rng.standard_normal(
        x.shape).astype(np.float32)), jp)
    lrs = JG.GaussianParams(xyz=jnp.float32(1.3e-4), features_dc=2.5e-3,
                            features_rest=1.25e-4, scaling=5e-3,
                            rotation=1e-3, opacity=0.05, semantic=1e-3)
    state = JG.adam_init(jp)
    tp, tstate = _params_t(jp), TG.adam_init(_params_t(jp))
    for _ in range(3):
        jp, state = JG.adam_update(jp, grads, state, lrs)
        tp, tstate = TG.adam_update(
            tp, _params_t(grads), tstate,
            dataclasses.replace(TG.GaussianParams(**{
                f.name: float(getattr(lrs, f.name))
                for f in dataclasses.fields(lrs)})))
    _assert_trees(tp, jp, rtol=1e-6)
    _assert_trees(tstate.mu, state.mu, rtol=1e-6)
    _assert_trees(tstate.nu, state.nu, rtol=1e-6)
    assert int(tstate.count) == int(state.count) == 3


def test_stats_reset_and_growth_match_jax():
    rng = np.random.default_rng(2)
    jm, _, _ = _jtiny()
    jaux = jm.bkgd_aux
    taux = TG.GaussianAux(**{k: tt(v) for k, v in tree_of(jaux).items()})
    n = jm.background.capacity
    vg = rng.standard_normal((n, 2)).astype(np.float32)
    ag = rng.uniform(0, 3, n).astype(np.float32)
    radii = rng.integers(0, 9, n).astype(np.int32)
    vis = radii > 0
    for _ in range(2):
        jaux = JG.add_densification_stats(jaux, jnp.asarray(vg),
                                          jnp.asarray(ag),
                                          jnp.asarray(radii),
                                          jnp.asarray(vis))
        taux = TG.add_densification_stats(taux, tt(vg), tt(ag), tt(radii),
                                          tt(vis))
    _assert_trees(taux, jaux, rtol=1e-6)

    jp = jm.background.replace(opacity=jnp.asarray(
        rng.normal(0, 3, (n, 1)).astype(np.float32)))
    jadam = JG.adam_init(jp)
    jadam = jadam.replace(mu=jax.tree.map(jnp.ones_like, jadam.mu))
    tadam = TG.AdamState(mu=_params_t(jadam.mu), nu=_params_t(jadam.nu),
                         count=torch.tensor(0, dtype=torch.int32))
    jp2, jadam2 = JG.reset_opacity(jp, jadam)
    tp2, tadam2 = TG.reset_opacity(_params_t(jp), tadam)
    _assert_trees(tp2, jp2, rtol=1e-6)
    _assert_trees(tadam2.mu, jadam2.mu, rtol=0)

    jp3, jaux3, jadam3 = JG.grow_capacity(jp2, jaux, jadam2, 2 * n)
    tp3, taux3, tadam3 = TG.grow_capacity(tp2, taux, tadam2, 2 * n)
    _assert_trees(tp3, jp3, rtol=1e-6)
    _assert_trees(taux3, jaux3, rtol=0)
    _assert_trees(tadam3.mu, jadam3.mu, rtol=0)


def _feed(monkeypatch, module, name, draws):
    """Replace a port draw helper by one returning the JAX draws in turn
    (cycling, so a repeated pass draws the same numbers)."""
    it = {"i": 0}

    def fake(shape, generator, device):
        d = draws[it["i"] % len(draws)]
        it["i"] += 1
        assert tuple(d.shape) == tuple(shape)
        return tt(d).to(device)
    monkeypatch.setattr(module, name, fake)


@pytest.mark.parametrize("actor", [False, True])
def test_densify_and_prune_matches_jax(monkeypatch, actor):
    """Clone -> split -> prune with the Adam-moment surgery: the random
    draws are JAX's (same key splits), then masks, counts and every field
    agree."""
    rng = np.random.default_rng(3)
    jm, _, jarr = _jtiny()
    if actor:
        jp = jax.tree.map(lambda x: x[0], jm.actors)
        jaux = jax.tree.map(lambda x: x[0], jm.actors_aux)
        jp = jp.replace(xyz=jp.xyz.at[0].set(jnp.asarray([9.0, 9.0, 9.0])))
    else:
        jp, jaux = jm.background, jm.bkgd_aux
    n = jp.capacity
    na = int(jaux.n_active)
    op = np.asarray(jp.opacity).copy()
    op[rng.random(n) < 0.1] = -8.0                 # low-opacity prune
    scaling = np.asarray(jp.scaling).copy()
    scaling[:na] += rng.uniform(-1.5, 1.5, (na, 1)).astype(np.float32)
    jp = jp.replace(opacity=jnp.asarray(op), scaling=jnp.asarray(scaling))
    acc = np.zeros((n, 2), np.float32)
    acc[:, 0] = rng.uniform(0, 1, n)
    acc[:, 1] = rng.uniform(0, 1, n)
    jaux = jaux.replace(xyz_gradient_accum=jnp.asarray(acc),
                        denom=jnp.asarray(rng.integers(
                            0, 3, (n, 1)).astype(np.float32)))
    jadam = JG.adam_init(jp)
    jadam = jadam.replace(
        mu=jax.tree.map(lambda x: jnp.asarray(rng.standard_normal(
            x.shape).astype(np.float32)), jadam.mu),
        nu=jax.tree.map(lambda x: jnp.asarray(rng.uniform(
            0, 1, x.shape).astype(np.float32)), jadam.nu))
    key = jax.random.PRNGKey(7)
    cfg = dict(grad_threshold=0.6, prune_big_points=True, min_opacity=0.005,
               use_abs_grad=actor)
    if actor:
        half = np.asarray(jarr.actor_bbox[0]) / 2.0
        kw_j = dict(extent=jnp.float32(30.0), bbox_min=-jnp.asarray(half),
                    bbox_max=jnp.asarray(half))
        kw_t = dict(extent=torch.tensor(30.0), bbox_min=-tt(half),
                    bbox_max=tt(half))
        k, bkey = jax.random.split(key)
        draws = [np.asarray(jax.random.normal(bkey, (n, 2, 3)))]
    else:
        kw_j = dict(sphere_center=jarr.sphere_center,
                    sphere_radius=jarr.sphere_radius)
        kw_t = dict(sphere_center=tt(jarr.sphere_center),
                    sphere_radius=tt(jarr.sphere_radius))
        cfg["extent"] = 200.0
        k, draws = key, []
    draws += [np.asarray(jax.random.normal(ks, (n, 3)))
              for ks in jax.random.split(k, 2)]
    _feed(monkeypatch, TG, "_randn", draws)
    jp2, jaux2, jadam2, jst = JG.densify_and_prune(
        jp, jaux, jadam, key, JG.DensifyConfig(**cfg), **kw_j)
    tadam = TG.AdamState(mu=_params_t(jadam.mu), nu=_params_t(jadam.nu),
                         count=torch.tensor(0, dtype=torch.int32))
    taux = TG.GaussianAux(**{k: tt(v) for k, v in tree_of(jaux).items()})
    tp2, taux2, tadam2, tst = TG.densify_and_prune(
        _params_t(jp), taux, tadam, None, TG.DensifyConfig(**cfg), **kw_t)
    assert {k: int(v) for k, v in jst.items()} == tst
    assert tst["n_clone"] > 0 and tst["n_split"] > 0
    assert tst["n_keep"] < na
    _assert_trees(tp2, jp2, rtol=1e-6)
    _assert_trees(taux2, jaux2, rtol=0)
    _assert_trees(tadam2.mu, jadam2.mu, rtol=0)
    _assert_trees(tadam2.nu, jadam2.nu, rtol=0)


# ------------------------------------------------------- the train step

def _composite():
    """A JAX composite scene with actors (flip on), sky cube map, colour
    correction and semantics, and its port copy."""
    rng = np.random.default_rng(4)
    jm, jmeta, jarr = jsyn.make_scene(
        n_background=600, bkgd_capacity=1024, n_actors=1, actor_capacity=256,
        n_frames=4, sh_degree=1, fourier_dim=2, num_classes=3,
        include_sky=True, use_color_correction=True, opt_track=True)
    jmeta = jmeta.replace(flip_prob=0.5)
    jm = jm.replace(
        background=jm.background.replace(semantic=jnp.asarray(
            rng.standard_normal(jm.background.semantic.shape)
            .astype(np.float32))),
        sky=jm.sky.replace(cube_map=jnp.asarray(rng.uniform(
            0, 1, jm.sky.cube_map.shape).astype(np.float32))),
        color_correction=jm.color_correction.replace(
            affine=jm.color_correction.affine + jnp.asarray(
                0.03 * rng.standard_normal(jm.color_correction.affine.shape)
                .astype(np.float32))))
    tm, tmeta, tarr = scene_from_tree(
        {"models": tree_of(jm), "meta": tree_of(jmeta),
         "arrays": tree_of(jarr)}, device="cpu")
    return (jm, jmeta, jarr), (tm, tmeta, tarr), rng


def _step_both(monkeypatch, blend_backward):
    """One train step of the composite scene in both packages from
    identical states and identical random draws, and the port's step again
    with another blend backward. The port sums its pair cotangents in the
    JAX package's order, one running float32 sum down each column, and
    records what it summed: on this scene the largest prefix of a conic
    column is more than 2^24 times the actor's conic-gradient sums, below
    float32 resolution, so only the same summation order gives the JAX
    package's rounding there (test_segment_sum_resolution holds the
    blocked order that the port runs to float64 on the same cotangents)."""
    summed = []
    segment_sum = TR._segment_sum_expansion

    def recorded_segment_sum(d_gm, seg_offs, seg_area):
        summed.append((d_gm.detach().clone(), seg_offs, seg_area))
        return segment_sum(d_gm, seg_offs, seg_area)

    monkeypatch.setattr(TR, "_column_prefix_sums",
                        lambda x: x.t().cumsum(dim=1))
    monkeypatch.setattr(TR, "_segment_sum_expansion", recorded_segment_sum)
    (jm, jmeta, jarr), (tm, tmeta, tarr), rng = _composite()
    jcam = jsyn.make_cameras(4, width=W, height=H)[1]
    tcam = tsyn.make_cameras(4, width=W, height=H, device="cpu")[1]
    gt = rng.uniform(0, 1, (3, H, W)).astype(np.float32)
    sem = rng.integers(-1, 3, (1, H, W)).astype(np.int32)
    lam = dict(lambda_semantic=0.5, lambda_color_correction=0.1)
    n_total = j_total_capacity(jm)
    key = jax.random.PRNGKey(3)
    flip_key, sky_key = jax.random.split(key)
    ki, kj = jax.random.split(sky_key)
    _feed(monkeypatch, tsg, "_uniform", [np.asarray(jax.random.uniform(
        flip_key, (1, 256)))])
    _feed(monkeypatch, tsky, "_uniform",
          [np.asarray(jax.random.uniform(k, (H, W))) for k in (ki, kj)])
    jstep = jtr.make_train_step(jmeta, jarr, jtr.OptimConfig(**lam),
                                jren.RenderOptions(capacity=8192,
                                                   interpret=True), n_total)
    jout = jstep(jtr.init_train_state(jm), jcam,
                 jtr.Batch(gt_image=jnp.asarray(gt),
                           gt_semantic=jnp.asarray(sem)), key, 1)
    tstep = ttr.make_train_step(tmeta, tarr, ttr.OptimConfig(**lam),
                                tren.RenderOptions(capacity=8192), n_total,
                                device="cpu")
    tbatch = ttr.Batch(gt_image=tt(gt), gt_semantic=tt(sem))
    tout = tstep(ttr.init_train_state(tm), tcam, tbatch, torch.Generator(),
                 1)
    with monkeypatch.context() as m:
        m.setattr(tblend, "blend_backward", blend_backward)
        t64 = tstep(ttr.init_train_state(tm), tcam, tbatch,
                    torch.Generator(), 1)
    return jout, tout, t64, tm, summed


# Leaves of the train step that float32 cannot give to STATE_RTOL, each
# held to the JAX package's step at its own limit (of the leaf's max).
# Geometry (xyz, scaling, the actor pose) sits behind the ill-conditioned
# inverse of the 2D covariance. The actors' gradients are ~1e-3 of the
# background's here, so the float32 prefix sum of the segment sum over the
# whole capacity leaves them ~2e-4 of their max. The Adam step of a
# features_rest entry whose gradient is near Adam's epsilon moves with it.
# The two packages' steps differ there by about as much as the JAX
# package's step differs from the port's with a float64 blend backward.
# Measured between the packages on this scene: mu 3.4e-2 actors/scaling,
# 5.8e-3 background/scaling, 5.5e-3 actor_pose/opt_trans, 4.9e-3
# actors/xyz, 3.6e-4 background/xyz, 2.9e-4 actors/semantic, 1.9e-4 the
# actors' colours; nu 1.7e-2, 2.0e-3, 1.8e-3, 4.6e-4, 2.2e-4 for the
# actors' scaling, pose, xyz, semantic, colours; 1.6e-4 the features_rest
# parameters, 1.0e-4 the actors' AbsGS accumulator. Each limit is 2-6x
# its reading.
COND_STATE_RTOL = {
    **{f"{t}/actors/{k}": 1e-3 for t in ("mu", "nu")
       for k in ("features_dc", "features_rest", "semantic")},
    "mu/actors/scaling": 1e-1, "nu/actors/scaling": 5e-2,
    "mu/actors/xyz": 2e-2, "nu/actors/xyz": 1e-2,
    "mu/actor_pose/opt_trans": 2e-2, "nu/actor_pose/opt_trans": 1e-2,
    "mu/background/scaling": 2e-2, "mu/background/xyz": 1e-3,
    "param/background/features_rest": 1e-3,
    "actors_aux/xyz_gradient_accum": 1e-3,
}


@pytest.fixture(scope="module")
def composite_step():
    from tests.test_torch_raster_grad import _blend_backward_f64

    with pytest.MonkeyPatch.context() as mp:
        return _step_both(mp, _blend_backward_f64)


def test_train_step_matches_jax(composite_step):
    """One step from an identical composite state: loss terms at 1e-5;
    every Adam moment, every parameter and the densification statistics
    against the JAX package's step, at 1e-4 of each leaf's max or, for the
    leaves named in COND_STATE_RTOL, at their own limit. Where the JAX
    step is itself further than 1e-4 from the port's step with a float64
    blend backward, the port must also be within twice the JAX package's
    distance to that step. The JAX step's tracked-rotation residual is NaN
    (its slerp gradient at equal tracklet rotations, ROADMAP faults); the
    port's is finite."""
    (js, jloss, jsc, _), (ts, tloss, tsc, _), (t64, _, _, _), tm, _ = \
        composite_step
    assert not tsc["overflow"] and not bool(jsc["overflow"])
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    for k in ("l1", "dssim", "semantic", "cc_reg"):
        np.testing.assert_allclose(float(tsc[k]), float(jsc[k]), rtol=1e-5)
    assert int(tsc["n_pairs"]) == int(jsc["n_pairs"])
    assert int(ts.adam.count) == int(js.adam.count) == 1

    nan_leaf = "/actor_pose/opt_rots"
    assert np.isnan(np.asarray(js.adam.mu["actor_pose"]["opt_rots"])).any()
    trees = {}
    for name, get in (("mu", lambda s: s.adam.mu), ("nu", lambda s: s.adam.nu),
                      ("param", lambda s: ttr._learnables(s.models)
                       if isinstance(s, ttr.TrainState)
                       else jtr._learnables(s.models)),
                      ("bkgd_aux", lambda s: s.models.bkgd_aux),
                      ("actors_aux", lambda s: s.models.actors_aux)):
        trees[name] = [_flat(tree_of(get(s))) for s in (ts, js, t64)]
    assert np.isfinite(trees["mu"][0][nan_leaf]).all()
    assert np.isfinite(trees["param"][0][nan_leaf]).all()
    mu_t, mu_j = trees["mu"][0], trees["mu"][1]
    compared = set()
    for name, (tp, jp, fp) in trees.items():
        for k in jp:
            if k == nan_leaf:
                continue
            x, y, z = (tp[k].astype(np.float64), jp[k].astype(np.float64),
                       fp[k].astype(np.float64))
            if name == "param":
                # Adam's first step is lr * sign(gradient): compare where
                # both packages' gradients have one sign; elsewhere the
                # step is bounded by the learning rate (all <= 0.05)
                same = np.sign(mu_t[k]) == np.sign(mu_j[k])
                x0 = _flat(tree_of(ttr._learnables(tm)))[k]
                assert np.abs(x - x0).max() <= 0.05 * (1 + 1e-5), k
                x, y, z = x[same], y[same], z[same]
                if not x.size:
                    continue
            scale = np.abs(y).max() + 1e-30
            e_pj = np.abs(x - y).max() / scale
            e_jf = np.abs(y - z).max() / scale
            e_pf = np.abs(x - z).max() / scale
            path = name + k
            assert e_pj <= COND_STATE_RTOL.get(path, STATE_RTOL), \
                (path, e_pj)
            compared.add(path)
            if e_jf > STATE_RTOL:
                # two float32 evaluations of an ill-conditioned quantity:
                # the port also within twice the JAX package's distance
                assert e_pf <= 2 * e_jf, (path, e_pf, e_jf)
    assert set(COND_STATE_RTOL) <= compared, set(COND_STATE_RTOL) - compared
    for tree in ("mu", "nu", "param"):
        for leaf in ("actors/xyz", "actors/scaling", "actors/rotation",
                     "actors/opacity", "actors/features_dc",
                     "actor_pose/opt_trans", "background/xyz",
                     "color_correction/affine", "sky"):
            assert f"{tree}/{leaf}" in compared, (tree, leaf)


def test_segment_sum_resolution(composite_step):
    """The blocked column prefix sum that the port runs, on the composite
    step's pair cotangents in expansion order, is within 4 float32 ulps of
    each column's largest prefix of a float64 prefix sum (measured: 2.4;
    the JAX package's one running sum per column: 1.0). A segment's sum is
    a difference of two prefixes, so both orders resolve it only to that
    absolute error, which on this scene exceeds the actor's conic sums
    (the Gaussians after the background's 1024 rows): the largest conic
    prefix is more than 2^24 times their largest."""
    summed = composite_step[-1]
    assert len(summed) == 2
    eps = 2.0 ** -24
    conic = slice(tblend.F_CA, tblend.F_CC + 1)
    for x, seg_offs, seg_area in summed:
        ref = torch.cumsum(x.double(), dim=0).t()
        top = ref.abs().max(dim=1).values
        err_blocked = (TR._column_prefix_sums(x).double() - ref).abs().max(
            dim=1).values
        assert (err_blocked <= 4 * eps * top).all()
        actor = TR._segment_sum_expansion(x.double(), seg_offs,
                                          seg_area)[1024:, conic]
        assert top[conic].max() > actor.abs().max() / eps


# --------------------------------------- trainer behaviour (port only)

OPTS = tren.RenderOptions(capacity=8192)


def _ttiny():
    return tsyn.make_scene(n_background=600, bkgd_capacity=1024, n_actors=1,
                           actor_capacity=256, n_frames=4, sh_degree=1,
                           fourier_dim=2, device="cpu")


def test_train_step_reduces_loss():
    """tests/test_train.py:42 for the port."""
    models, meta, arrays = _ttiny()
    cams = tsyn.make_cameras(n_frames=4, width=W, height=H, device="cpu")
    gts = [tren.render_scene(models, meta, arrays, c, active_sh_degree=1,
                             options=OPTS, device="cpu").rgb for c in cams]
    gen = torch.Generator().manual_seed(0)
    bk = models.background
    noisy = models.replace(background=bk.replace(
        features_dc=bk.features_dc + 0.3 * torch.randn(
            bk.features_dc.shape, generator=gen)))
    step = ttr.make_train_step(meta, arrays, ttr.OptimConfig(lambda_dssim=0.0),
                               OPTS, tsg.total_capacity(noisy), device="cpu")
    state = ttr.init_train_state(noisy)
    losses = []
    for it in range(12):
        ci = it % len(cams)
        state, loss, scalars, _ = step(state, cams[ci],
                                       ttr.Batch(gt_image=gts[ci]),
                                       torch.Generator().manual_seed(it), 1)
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    # the same views: the third pass over the four views against the first
    first, last = np.array(losses[:4]), np.array(losses[-4:])
    assert (last < first).all(), losses
    assert last.sum() < first.sum() * 0.7, losses
    assert float(state.models.bkgd_aux.denom.max()) > 0
    assert float(state.models.bkgd_aux.xyz_gradient_accum[:, 1].max()) > 0


def test_overflow_step_discarded_and_retried():
    """tests/test_train.py:280 for the port: the overflowed step is not
    applied; the retried state equals a never-overflowed run."""
    models, meta, arrays = _ttiny()
    cams = tsyn.make_cameras(n_frames=4, width=W, height=H, device="cpu")
    gt = tren.render_scene(models, meta, arrays, cams[1], active_sh_degree=1,
                           options=OPTS, device="cpu").rgb
    n_total = tsg.total_capacity(models)
    cfg = ttr.OptimConfig(lambda_dssim=0.0)

    def make_step(o):
        return ttr.make_train_step(meta, arrays, cfg, o, n_total,
                                   device="cpu")
    batch = ttr.Batch(gt_image=gt)
    small = tren.RenderOptions(capacity=1024)
    state0 = ttr.init_train_state(models)
    out = tapp.step_with_overflow_retry(
        make_step(small), make_step, small, state0, cams[1], batch,
        torch.Generator().manual_seed(0), 1)
    _, opts2, state_r, loss_r, scalars_r, _, retries = out
    assert opts2.capacity > small.capacity and retries > 0
    assert not scalars_r["overflow"]
    state_ref, loss_ref, _, _ = make_step(opts2)(
        state0, cams[1], batch, torch.Generator().manual_seed(0), 1)
    np.testing.assert_allclose(float(loss_r), float(loss_ref), rtol=1e-6)
    _assert_trees(state_r.models.background, state_ref.models.background,
                  rtol=0)
    _assert_trees(state_r.adam.mu["background"],
                  state_ref.adam.mu["background"], rtol=0)
    # the overflowed step left the input state untouched
    _assert_trees(state0.models.background, models.background, rtol=0)


def test_opacity_reset_fans_out_to_actors():
    """tests/test_train.py:322 for the port."""
    models, meta, arrays = _ttiny()
    models = models.replace(
        background=models.background.replace(
            opacity=torch.full_like(models.background.opacity, 3.0)),
        actors=models.actors.replace(
            opacity=torch.full_like(models.actors.opacity, 3.0)))
    state = ttr.init_train_state(models)
    mu = dict(state.adam.mu)
    mu["actors"] = mu["actors"].replace(
        opacity=torch.ones_like(mu["actors"].opacity))
    state = state.replace(adam=state.adam.replace(mu=mu))
    state2 = tapp.apply_opacity_reset(state, meta)
    assert float(torch.sigmoid(state2.models.background.opacity).max()) \
        <= 0.011
    assert float(torch.sigmoid(state2.models.actors.opacity).max()) <= 0.011
    assert float(state2.adam.mu["actors"].opacity.abs().max()) == 0.0
    assert torch.equal(state2.models.actors.xyz, models.actors.xyz)


def test_training_loop_densifies_and_resets():
    """`run_training` on the tiny scene: one densify-and-prune event
    (background and actor), one opacity reset, the loss recorded every
    iteration."""
    models, meta, arrays = _ttiny()
    cams = tsyn.make_cameras(n_frames=4, width=W, height=H, device="cpu")
    cam_gt = [(c, tren.render_scene(models, meta, arrays, c,
                                    active_sh_degree=1, options=OPTS,
                                    device="cpu").rgb) for c in cams]
    cfg = ttr.OptimConfig(densify_from_iter=1, densification_interval=3,
                          opacity_reset_interval=4,
                          densify_grad_threshold=1e-7)
    state, rec = tapp.run_training(models, meta, arrays, cam_gt, cfg, OPTS,
                                   4, device="cpu", log_every=1000)
    assert len(rec["loss"]) == 4 and np.isfinite(rec["loss"]).all()
    (ev,) = rec["densify"]
    assert ev["it"] == 3 and ev["n_active"] > ev["n_active_before"]
    assert int(state.models.bkgd_aux.n_active) == ev["n_active"]
    assert float(torch.sigmoid(state.models.background.opacity).max()) \
        <= 0.011
    assert rec["evals"] and rec["evals"][-1]["it"] == 4


def test_train_entry_point_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tapp.main(["--synthetic", "--iterations", "1"])
