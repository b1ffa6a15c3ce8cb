"""Mesh training in the port held against the JAX package on the CPU,
mirroring tests/test_sharded.py:70-333: the production train step on a
2-rank `data` mesh against the JAX package's single-device step (loss
rtol 1e-5, densification statistics atol 1e-5 / rtol 1e-4, parameters
within 2.5x each leaf's learning rate), the 2x2 ("data", "model") step
against it (loss 1e-3 relative, float leaves 5e-3 of their max,
opt_track=False), 20 steps on the mesh tracking the port's single-device
trajectory, a step whose regularizers reach the parameters outside the
render (counted once, not once a rank), the app's loop through overflow
retry, densify and prune, capacity growth and opacity reset with the
ranks in step, `apps.train --mesh 2` under
`torch.distributed.run` (rank 0 alone prints and writes; outside a
launch: tests/test_torch_apps.py::test_train_cli_refuses_mesh), and
`apps.scaling_bench` on 1 and 2 ranks. The port's
ranks are spawned gloo processes (`tests/torch_dist.py`); the launcher
runs take a free port of their own (`--standalone`)."""
import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from gaussianrpg_tpu.models.scene_graph import (actor_extents,  # noqa: E402
                                                total_capacity)
from gaussianrpg_tpu.render.renderer import (RenderOptions,  # noqa: E402
                                             render_scene)
from gaussianrpg_tpu.train import trainer as jtr  # noqa: E402
from gaussianrpg_tpu.utils import synthetic as jsyn  # noqa: E402

from gaussianrpg_tpu_torch.models.convert import scene_from_tree  # noqa: E402
from gaussianrpg_tpu_torch.render import renderer as tren  # noqa: E402
from gaussianrpg_tpu_torch.train import trainer as ttr  # noqa: E402
from gaussianrpg_tpu_torch.utils import synthetic as tsyn  # noqa: E402

from . import torch_dist as D  # noqa: E402
from .torch_parity import one_cpu_thread, tree_of  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH_TIMEOUT_S = 240


def _perturbed(models, key):
    """tests/test_sharded.py's perturbation of the background colours."""
    bk = models.background
    return models.replace(background=bk.replace(
        features_dc=bk.features_dc + 0.3 * jax.random.normal(
            jax.random.PRNGKey(key), bk.features_dc.shape)))


def _tree(models, meta, arrays):
    return {"models": tree_of(models), "meta": tree_of(meta),
            "arrays": tree_of(arrays)}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _assert_replicated(outs):
    """Every rank ends the steps with the same losses and state."""
    (l0, s0) = outs[0]
    a = _leaves(s0)
    for loss, s in outs[1:]:
        assert loss == l0
        b = _leaves(s)
        for k in a:
            if isinstance(a[k], np.ndarray):
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_mesh_train_step_matches_jax_single_device(tmp_path):
    """tests/test_sharded.py:70: the production step (every loss, the
    AbsGS statistics, Adam) on a 2-rank `data` mesh reproduces the JAX
    package's single-device step."""
    models, meta, arrays = jsyn.make_scene(
        n_background=400, bkgd_capacity=512, n_actors=1, actor_capacity=128,
        n_frames=4)
    cams = jsyn.make_cameras(n_frames=4, width=48, height=48)
    opts = RenderOptions(capacity=4096, interpret=True)
    gt = np.asarray(render_scene(models, meta, arrays, cams[1],
                                 active_sh_degree=1, options=opts).rgb)
    models = _perturbed(models, 5)
    cfg = jtr.OptimConfig(lambda_dssim=0.0)
    s1, l1, _, _ = jtr.make_train_step(
        meta, arrays, cfg, opts, total_capacity(models))(
        jtr.init_train_state(models), cams[1], jtr.Batch(gt_image=jnp.asarray(
            gt)), jax.random.PRNGKey(3), 1)

    outs = D.spawn(D.mesh_train, 2, tmp_path, None,
                   _tree(models, meta, arrays), (48, 48), [1], {1: gt}, 4096,
                   dict(lambda_dssim=0.0))
    _assert_replicated(outs)
    (loss,), state = outs[0]
    np.testing.assert_allclose(loss, float(l1), rtol=1e-5)
    # the densification statistics are the summed hook gradients
    ref_aux, got_aux = tree_of(s1.models.bkgd_aux), state["models"][
        "bkgd_aux"]
    assert set(ref_aux) == set(got_aux)
    for k in ref_aux:
        np.testing.assert_allclose(got_aux[k], ref_aux[k], atol=1e-5,
                                   rtol=1e-4, err_msg=k)
    # one Adam step moves a parameter by about its learning rate; float32
    # gradient noise can flip the sign of a near-zero gradient's step
    lrs = jtr._lr_tree(jtr._learnables(models), cfg, 0,
                       actor_extent=actor_extents(arrays, meta.box_scale))
    for name in ("background", "actors"):
        ref = tree_of(getattr(s1.models, name))
        got = state["models"][name]
        lr = tree_of(lrs[name])
        for k in ref:
            np.testing.assert_allclose(
                got[k], ref[k], err_msg=f"{name}/{k}",
                atol=2.5 * float(np.max(np.asarray(lr[k]))) + 1e-7)


def test_mesh2d_train_step_matches_jax_single_device(tmp_path):
    """tests/test_sharded.py:244: the production step on a 2x2 ("data",
    "model") mesh: tile strips over `data`, the primitive stage sharded
    over `model` (field rows all-gathered, gradients reduce-scattered)."""
    models, meta, arrays = jsyn.make_scene(
        n_background=300, bkgd_capacity=384, n_actors=1, actor_capacity=128,
        n_frames=4, opt_track=False)
    cam = jsyn.make_cameras(n_frames=4, width=48, height=32)[1]
    opts = RenderOptions(capacity=4096, interpret=True)
    gt = np.asarray(render_scene(models, meta, arrays, cam,
                                 active_sh_degree=1, options=opts).rgb)
    models = _perturbed(models, 3)
    assert total_capacity(models) % 2 == 0
    cfg = jtr.OptimConfig(lambda_dssim=0.0)
    s1, l1, _, _ = jtr.make_train_step(
        meta, arrays, cfg, opts, total_capacity(models))(
        jtr.init_train_state(models), cam, jtr.Batch(gt_image=jnp.asarray(
            gt)), jax.random.PRNGKey(0), 1)

    outs = D.spawn(D.mesh_train, 4, tmp_path, (2, 2),
                   _tree(models, meta, arrays), (48, 32), [1], {1: gt}, 4096,
                   dict(lambda_dssim=0.0))
    _assert_replicated(outs)
    (loss,), state = outs[0]
    assert float(l1) > 1e-5 and abs(loss - float(l1)) / float(l1) < 1e-3
    ref, got = _leaves(tree_of(s1.models)), _leaves(state["models"])
    compared = 0
    for k, a in ref.items():
        if not isinstance(a, np.ndarray) or a.dtype.kind != "f":
            continue
        scale = np.abs(a).max() + 1e-6
        assert np.abs(got[k] - a).max() / scale < 5e-3, k
        compared += 1
    assert compared >= 14


def test_mesh_training_run_tracks_single_device(tmp_path):
    """tests/test_sharded.py:190: 20 steps on a 2-rank mesh learn (the
    loss falls below 0.6 of the first) and track the port's single-device
    run step for step (rtol 2e-3 for five steps, 0.15 for all)."""
    models, meta, arrays = jsyn.make_scene(
        n_background=400, bkgd_capacity=512, n_actors=1, actor_capacity=128,
        n_frames=4)
    tree = _tree(_perturbed(models, 5), meta, arrays)
    clean, _, _ = scene_from_tree(_tree(models, meta, arrays), device="cpu")
    tm, tmeta, tarr = scene_from_tree(tree, device="cpu")
    cams = tsyn.make_cameras(n_frames=4, width=64, height=48, device="cpu")
    opts = tren.RenderOptions(capacity=8192)
    gts = {i: tren.render_scene(clean, tmeta, tarr, c, active_sh_degree=1,
                                options=opts, device="cpu").rgb.numpy()
           for i, c in enumerate(cams)}
    views = [it % 4 for it in range(20)]
    cfg = dict(lambda_dssim=0.0)

    step = ttr.make_train_step(tmeta, tarr, ttr.OptimConfig(**cfg), opts,
                               total_capacity(models), device="cpu")
    state, single = ttr.init_train_state(tm), []
    for it, v in enumerate(views):
        state, loss, _, _ = step(state, cams[v], ttr.Batch(
            gt_image=torch.as_tensor(gts[v])), torch.Generator().manual_seed(
                it), 1)
        single.append(float(loss))

    outs = D.spawn(D.mesh_train, 2, tmp_path, None, tree, (64, 48), views,
                   gts, 8192, cfg)
    _assert_replicated(outs)
    m, s = np.asarray(outs[0][0]), np.asarray(single)
    assert np.isfinite(m).all()
    assert m[-1] < m[0] * 0.6, m
    np.testing.assert_allclose(m[:5], s[:5], rtol=2e-3)
    np.testing.assert_allclose(m, s, rtol=0.15)


def test_mesh_step_counts_regularizers_once(tmp_path):
    """The loss's terms outside the render (colour-correction and
    scale-flatten regularizers) reach the parameters once on the mesh, as
    in JAX, where they lie outside the shard_map. The 2-rank step's Adam
    moments of the colour correction (render and regularizer) and the
    background (render, and scale flatten for the scales) equal the port's
    single-device step to 1e-4 of each leaf's max (the scales, behind the
    2D covariance's inverse, to 1e-3), while the single-device step with
    the regularizers counted twice, once a rank, is 1e-2 away."""
    models, meta, arrays = jsyn.make_scene(
        n_background=400, bkgd_capacity=512, n_actors=1, actor_capacity=128,
        n_frames=4, use_color_correction=True)
    models = models.replace(color_correction=models.color_correction.replace(
        affine=models.color_correction.affine + 0.05))
    tree = _tree(_perturbed(models, 5), meta, arrays)
    tm, tmeta, tarr = scene_from_tree(tree, device="cpu")
    cam = tsyn.make_cameras(n_frames=4, width=48, height=48, device="cpu")[1]
    gt = np.random.default_rng(0).uniform(0, 1, (3, 48, 48)).astype(
        np.float32)
    cfg = dict(lambda_dssim=0.0, lambda_color_correction=0.5,
               lambda_scale_flatten=0.5)

    def single(**kw):
        step = ttr.make_train_step(tmeta, tarr, ttr.OptimConfig(**kw),
                                   tren.RenderOptions(capacity=4096),
                                   total_capacity(models), device="cpu")
        state, loss, _, _ = step(ttr.init_train_state(tm), cam, ttr.Batch(
            gt_image=torch.as_tensor(gt)), torch.Generator().manual_seed(0),
            1)
        return float(loss), _leaves(tree_of(state.adam.mu))

    loss_ref, mu_ref = single(**cfg)
    _, mu_twice = single(**dict(cfg, lambda_color_correction=1.0,
                                lambda_scale_flatten=1.0))
    outs = D.spawn(D.mesh_train, 2, tmp_path, None, tree, (48, 48), [1],
                   {1: gt}, 4096, cfg)
    _assert_replicated(outs)
    (loss,), state = outs[0]
    np.testing.assert_allclose(loss, loss_ref, rtol=1e-5)
    mu = _leaves(state["mu"])
    for k, lim in (("/color_correction/affine", 1e-4),
                   ("/background/scaling", 1e-3),
                   ("/background/features_dc", 1e-4),
                   ("/background/opacity", 1e-4)):
        scale = np.abs(mu_ref[k]).max()
        assert scale > 0 and np.abs(mu[k] - mu_ref[k]).max() < lim * scale, k
    for k in ("/color_correction/affine", "/background/scaling"):
        scale = np.abs(mu_ref[k]).max()
        assert np.abs(mu[k] - mu_twice[k]).max() > 1e-2 * scale, k


def test_mesh_schedule_keeps_the_ranks_in_step(tmp_path):
    """The app's loop on a 2-rank mesh through every branch that must be
    decided alike on each rank, or the ranks hang in the next collective:
    the first step overflows a 512-pair capacity (discarded, the capacity
    doubled, retried with the same draws), densify and prune run at steps
    3, 6 and 9 (their draws seeded alike), the background outgrows its
    capacity and is grown, and the opacities are reset at step 10. Both
    ranks end with the same losses, events and state, within the group's
    timeout."""
    cfg = dict(lambda_dssim=0.0, densify_from_iter=2,
               densification_interval=3, opacity_reset_interval=10,
               densify_grad_threshold=2e-5, min_opacity=0.05)
    outs = D.spawn(D.mesh_schedule, 2, tmp_path, 300, 320, (64, 48), 512,
                   10, cfg, timeout=D.GROUP_TIMEOUT_S)
    _assert_replicated(outs)
    (losses, events, retries, capacity, bkgd_capacity), state = outs[0]
    assert len(losses) == 10 and np.isfinite(losses).all()
    assert retries >= 1 and capacity > 512
    assert [e["it"] for e in events] == [3, 6, 9]
    assert sum(e["n_split"] + e["n_clone"] for e in events) > 0
    assert any(e["n_keep"] < e["n_active_before"] for e in events)
    assert bkgd_capacity > 320
    op = state["models"]["background"]["opacity"]
    assert op.shape[0] == bkgd_capacity
    assert (1.0 / (1.0 + np.exp(-op)) <= 0.01 + 1e-6).all()


def _launch(nproc, module, args, tmp_path, log_dir=None):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(nproc)]
    if log_dir is not None:
        cmd += ["--log-dir", str(log_dir), "--redirects", "3"]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    proc = subprocess.run(cmd + ["-m", module] + args, cwd=str(tmp_path),
                          env=env, capture_output=True, text=True,
                          timeout=LAUNCH_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc


def test_train_cli_on_a_mesh_under_the_launcher(tmp_path):
    """`python -m torch.distributed.run --nproc_per_node 2 -m
    gaussianrpg_tpu_torch.apps.train --synthetic --device cpu --mesh 2
    --dist-backend gloo --iterations 2`: both ranks train, rank 0 alone
    prints, evaluates and writes the checkpoint and PLY."""
    out = tmp_path / "out"
    logs = tmp_path / "logs"
    _launch(2, "gaussianrpg_tpu_torch.apps.train",
            ["--synthetic", "--device", "cpu", "--mesh", "2",
             "--dist-backend", "gloo", "--iterations", "2",
             "model_path", str(out)], tmp_path, log_dir=logs)
    assert (out / "trained_model" / "iteration_2.npz").exists()
    assert (out / "point_cloud" / "iteration_2" / "point_cloud.ply").exists()
    stdout = {int(p.split(os.sep)[-2]): open(p).read() for p in glob.glob(
        str(logs / "**" / "stdout.log"), recursive=True)}
    assert set(stdout) == {0, 1}
    assert "training on a 2-rank 'data' mesh (gloo, cpu)" in stdout[0]
    assert "checkpoint ->" in stdout[0] and "[eval train]" in stdout[0]
    assert "done: 2 iters" in stdout[0]
    assert stdout[1] == ""


def test_scaling_bench_prints_the_jax_apps_keys(tmp_path):
    """`apps.scaling_bench` at 64x48 with 300 Gaussians under the launcher
    with 2 gloo ranks: one JSON line each for 1 and 2 ranks with the JAX
    app's keys."""
    proc = _launch(2, "gaussianrpg_tpu_torch.apps.scaling_bench",
                   ["--width", "64", "--height", "48", "--gaussians", "300",
                    "--capacity", "65536", "--reps", "1", "--device", "cpu",
                    "--dist-backend", "gloo"], tmp_path)
    lines = [json.loads(ln) for ln in proc.stdout.splitlines()
             if ln.startswith("{")]
    assert [ln["devices"] for ln in lines] == [1, 2]
    for ln in lines:
        assert {"devices", "platform", "pixels_per_s",
                "scaling_efficiency_vs_1dev", "frame_ms"} <= set(ln)
        assert ln["platform"] == "cpu" and ln["backend"] == "gloo"
        assert ln["pixels_per_s"] > 0 and ln["frame_ms"] > 0
    assert lines[0]["scaling_efficiency_vs_1dev"] == 1.0
