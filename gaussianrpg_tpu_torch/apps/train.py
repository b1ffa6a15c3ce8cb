"""Training CLI, synthetic scene.

Counterpart of `gaussianrpg_tpu/apps/train.py` with `--synthetic`: the
settings are the `OptimConfig` and `RenderOptions` defaults with the JAX
configuration's model defaults (SH degree 3, Fourier dim 1, seed 0). The
YAML configuration, the Waymo scene, `--mesh`, checkpoints and PLY export
come with later slices.

    python -m gaussianrpg_tpu_torch.apps.train --synthetic --iterations 200

`run_training` is the loop itself (overflow discard-and-retry, densify and
prune, capacity growth, opacity reset, SH-degree upgrade, evaluation),
shared with `chip_smoke.py`.
"""
from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch

from ..models import gaussians as G
from ..models.scene_graph import actor_extents, total_capacity
from ..render.renderer import RenderOptions, probe_scene_capacity, render_scene
from ..train.losses import l1_loss, psnr
from ..train.trainer import (Batch, OptimConfig, TrainState, _index,
                             init_train_state, make_train_step)
from ..utils.device import resolve_device

SH_DEGREE = 3      # model.gaussian.sh_degree default of the JAX config
FOURIER_DIM = 1    # model.gaussian.fourier_dim default
SEED = 0


def step_with_overflow_retry(step_fn, make_step, opts: RenderOptions,
                             state: TrainState, cam, batch: Batch,
                             generator: torch.Generator, active_sh: int):
    """One train step; on pair-capacity overflow the step was not applied
    (the state is unchanged): double the capacity (and explicit tail
    sizes), rebuild the step and retry from the same state with the same
    random draws. Returns (step_fn, opts, new_state, loss, scalars, res,
    retries)."""
    draws = generator.get_state()
    retries = 0
    new_state, loss, scalars, res = step_fn(state, cam, batch, generator,
                                            active_sh)
    while scalars["overflow"]:
        opts = opts.replace(
            capacity=opts.capacity * 2,
            tail_cap=opts.tail_cap * 2 if opts.tail_cap is not None else None,
            big_cap=opts.big_cap * 2 if opts.big_cap is not None else None)
        print(f"  pair overflow: growing capacity to {opts.capacity}, "
              "retrying step", flush=True)
        retries += 1
        step_fn = make_step(opts)
        generator.set_state(draws)
        new_state, loss, scalars, res = step_fn(state, cam, batch,
                                                generator, active_sh)
    return step_fn, opts, new_state, loss, scalars, res, retries


def _with_submodel(state: TrainState, name: str, params, aux=None,
                   adam=None) -> TrainState:
    """The state with one sub-model's parameters, statistics and Adam
    moments replaced."""
    mu, nu = dict(state.adam.mu), dict(state.adam.nu)
    if adam is not None:
        mu[name], nu[name] = adam.mu, adam.nu
    kw = {name: params}
    if aux is not None:
        kw[{"background": "bkgd_aux", "actors": "actors_aux",
            "sky_gauss": "sky_gauss_aux"}[name]] = aux
    return state.replace(models=state.models.replace(**kw),
                         adam=state.adam.replace(mu=mu, nu=nu))


def _adam_of(state: TrainState, name: str) -> G.AdamState:
    return G.AdamState(mu=state.adam.mu[name], nu=state.adam.nu[name],
                       count=state.adam.count)


def apply_opacity_reset(state: TrainState, meta) -> TrainState:
    """Opacity reset of every sub-model (background, actors, sky
    Gaussians) with their Adam moments zeroed."""
    for name in ("background", "actors", "sky_gauss"):
        params = getattr(state.models, name)
        if params is None or (name == "actors" and meta.num_actors == 0):
            continue
        p2, adam2 = G.reset_opacity(params, _adam_of(state, name))
        state = _with_submodel(state, name, p2, adam=adam2)
    return state


def _autosize(opts: RenderOptions, cams, models, meta, arrays
              ) -> RenderOptions:
    """Right-size the binning buffers from a few probe frames, with extra
    slack for densification growth."""
    sized = probe_scene_capacity(models, meta, arrays, cams,
                                 active_sh_degree=meta.bkgd_sh_degree,
                                 options=opts, slack=1.5)
    print(f"pair capacity right-sized to {sized.capacity} (tail "
          f"{sized.tail_cap}, big {sized.big_cap})", flush=True)
    return sized


def evaluate_views(models, meta, arrays, cam_gt, opts: RenderOptions,
                   active_sh: int, max_views: int = 8, device=None):
    """Mean PSNR / L1 of up to `max_views` views rendered in eval mode."""
    psnrs, l1s = [], []
    for cam, gt in cam_gt[:max_views]:
        if gt is None:
            continue
        res = render_scene(models, meta, arrays, cam,
                           active_sh_degree=active_sh, options=opts,
                           device=device)
        rgb = torch.clamp(res.rgb, 0.0, 1.0)
        psnrs.append(float(psnr(rgb, gt)))
        l1s.append(float(l1_loss(rgb, gt)))
    if not psnrs:
        return None
    return {"psnr": sum(psnrs) / len(psnrs), "l1": sum(l1s) / len(l1s),
            "n_views": len(psnrs)}


def _densify(state: TrainState, meta, arrays, ocfg: OptimConfig, it: int,
             dev) -> tuple[TrainState, dict]:
    """Densify and prune the background and every actor."""
    dcfg = G.DensifyConfig(
        grad_threshold=ocfg.densify_grad_threshold,
        min_opacity=ocfg.min_opacity, percent_dense=ocfg.percent_dense,
        percent_big_ws=ocfg.percent_big_ws,
        extent=float(arrays.scene_radius),
        use_abs_grad=ocfg.densify_grad_abs_bkgd,
        prune_big_points=it > ocfg.opacity_reset_interval)
    gen = torch.Generator(device=dev).manual_seed(10000 + it)
    p2, aux2, adam2, stats = G.densify_and_prune(
        state.models.background, state.models.bkgd_aux,
        _adam_of(state, "background"), gen, dcfg,
        sphere_center=arrays.sphere_center,
        sphere_radius=arrays.sphere_radius)
    state = _with_submodel(state, "background", p2, aux2, adam2)
    if meta.num_actors > 0:
        dcfg_obj = G.DensifyConfig(
            grad_threshold=(ocfg.densify_grad_threshold_obj
                            or ocfg.densify_grad_threshold),
            min_opacity=ocfg.min_opacity, percent_dense=ocfg.percent_dense,
            percent_big_ws=ocfg.percent_big_ws,
            use_abs_grad=ocfg.densify_grad_abs_obj,
            prune_big_points=it > ocfg.opacity_reset_interval)
        a_ext = actor_extents(arrays, meta.box_scale)
        half = arrays.actor_bbox / 2.0
        # deformable actors skip the outside-bbox sampled prune
        half = torch.where(arrays.actor_deformable[:, None],
                           torch.full_like(half, float("inf")), half)
        adam_a = _adam_of(state, "actors")
        gen = torch.Generator(device=dev).manual_seed(20000 + it)
        outs = []
        for o in range(meta.num_actors):
            outs.append(G.densify_and_prune(
                _index(state.models.actors, o),
                _index(state.models.actors_aux, o),
                G.AdamState(mu=_index(adam_a.mu, o), nu=_index(adam_a.nu, o),
                            count=adam_a.count),
                gen, dcfg_obj, extent=a_ext[o], bbox_min=-half[o],
                bbox_max=half[o]))
        params = G.stack_params([x[0] for x in outs])
        aux = G.stack_params([x[1] for x in outs])
        adam = G.AdamState(mu=G.stack_params([x[2].mu for x in outs]),
                           nu=G.stack_params([x[2].nu for x in outs]),
                           count=adam_a.count)
        state = _with_submodel(state, "actors", params, aux, adam)
        stats["actors_n_active"] = [x[3]["n_active"] for x in outs]
    return state, stats


def run_training(models, meta, arrays, cam_gt, ocfg: OptimConfig,
                 opts: RenderOptions, iters: int, *, device=None,
                 seed: int = SEED, test_iters=(), log_every: int = 50):
    """The training loop over `cam_gt` [(camera, gt image [3, H, W])]:
    one random view per iteration, overflow discard-and-retry, the
    densify / capacity-growth / opacity-reset / SH-upgrade schedule of the
    JAX trainer, evaluation at `test_iters` and the last iteration.
    Returns (state, record): per-iteration losses and host step times
    (synchronized), densify events, overflow retries."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n_total = total_capacity(models)

    def make_step(o):
        return make_train_step(meta, arrays, ocfg, o, n_total, device=dev)

    step_fn = make_step(opts)
    state = init_train_state(models)
    active_sh = 0
    max_sh = meta.bkgd_sh_degree
    rec = dict(loss=[], step_s=[], densify=[], retries=0, evals=[])
    ema_loss = ema_psnr = 0.0
    t0 = time.time()
    for it in range(1, iters + 1):
        if it % 1000 == 0 and active_sh < max_sh:
            active_sh += 1
        cam, gt = cam_gt[int(rng.integers(len(cam_gt)))]
        gen = torch.Generator(device=dev).manual_seed(it)
        ts = time.perf_counter()
        step_fn, opts, state, loss, scalars, res, retries = \
            step_with_overflow_retry(step_fn, make_step, opts, state, cam,
                                     Batch(gt_image=gt), gen, active_sh)
        loss_f = float(loss)          # synchronizes the step
        rec["step_s"].append(time.perf_counter() - ts)
        rec["loss"].append(loss_f)
        rec["retries"] += retries
        ema_loss = 0.4 * loss_f + 0.6 * ema_loss
        ema_psnr = 0.4 * float(psnr(res.rgb, gt)) + 0.6 * ema_psnr
        if it % log_every == 0:
            print(f"[{it}/{iters}] loss {ema_loss:.5f} psnr {ema_psnr:.2f} "
                  f"({(time.time() - t0) / it:.3f}s/it)", flush=True)

        if (ocfg.densify_from_iter < it < ocfg.densify_until_iter
                and it % ocfg.densification_interval == 0):
            before = int(state.models.bkgd_aux.n_active)
            state, stats = _densify(state, meta, arrays, ocfg, it, dev)
            rec["densify"].append(dict(it=it, n_active_before=before,
                                       **stats))
            print(f"  densify: active {stats['n_active']} "
                  f"(+{stats['n_clone']}c/+{stats['n_split']}s)", flush=True)
            bcap = state.models.background.capacity
            if stats["n_active"] > 0.9 * bcap:
                gp, gaux, gadam = G.grow_capacity(
                    state.models.background, state.models.bkgd_aux,
                    _adam_of(state, "background"), bcap * 2)
                state = _with_submodel(state, "background", gp, gaux, gadam)
                n_total = total_capacity(state.models)
                print(f"  background capacity grown to {bcap * 2}",
                      flush=True)
                step_fn = make_step(opts)

        if (it < ocfg.densify_until_iter
                and it % ocfg.opacity_reset_interval == 0):
            state = apply_opacity_reset(state, meta)

        if it in set(test_iters) | {iters}:
            rep = evaluate_views(state.models, meta, arrays, cam_gt[:4],
                                 opts, active_sh, device=dev)
            if rep is not None:
                rec["evals"].append(dict(it=it, **rep))
                print(f"  [eval train] iter {it}: psnr {rep['psnr']:.2f} "
                      f"l1 {rep['l1']:.4f} ({rep['n_views']} views)",
                      flush=True)
    rec["median_step_ms"] = statistics.median(rec["step_s"]) * 1e3
    rec["opts"] = opts
    return state, rec


def synthetic_setup(device=None, n_background=5000, bkgd_capacity=16384,
                    width=256, height=160):
    """The JAX trainer's synthetic scene and views: by default 5000
    background Gaussians (capacity 16384) and 2 actors (1024 each) over
    10 frames at 256x160 (`chip_smoke.py` and `profile_trace` ask for
    600k at 1600x1066); ground truth is the initial render, then the
    background's DC colours are perturbed. Returns (models, meta, arrays,
    cam_gt, opts)."""
    from ..utils.synthetic import make_cameras, make_scene

    dev = resolve_device(device)
    models, meta, arrays = make_scene(
        n_background=n_background, bkgd_capacity=bkgd_capacity, n_actors=2,
        actor_capacity=1024, n_frames=10, sh_degree=SH_DEGREE,
        fourier_dim=FOURIER_DIM, device=dev)
    cams = make_cameras(n_frames=10, width=width, height=height, device=dev)
    opts = _autosize(RenderOptions(), cams, models, meta, arrays)
    gts = [render_scene(models, meta, arrays, c,
                        active_sh_degree=meta.bkgd_sh_degree, options=opts,
                        device=dev).rgb for c in cams]
    gen = torch.Generator(device=dev).manual_seed(1)
    bk = models.background
    models = models.replace(background=bk.replace(
        features_dc=bk.features_dc + 0.3 * torch.randn(
            bk.features_dc.shape, generator=gen, device=dev)))
    return models, meta, arrays, list(zip(cams, gts)), opts


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="gaussianrpg_tpu_torch training (synthetic scene)")
    parser.add_argument("--synthetic", action="store_true",
                        help="train the synthetic street scene (the only "
                             "scene of this slice)")
    parser.add_argument("--iterations", type=int, default=30000)
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    if not args.synthetic:
        parser.error("only --synthetic is supported (YAML configs and "
                     "Waymo scenes come with a later slice)")
    dev = resolve_device(args.device)
    models, meta, arrays, cam_gt, opts = synthetic_setup(dev)
    t0 = time.time()
    state, rec = run_training(models, meta, arrays, cam_gt, OptimConfig(),
                              opts, args.iterations, device=dev,
                              test_iters=(7000, 30000))
    print(f"done: {args.iterations} iters in {time.time() - t0:.1f}s, "
          f"first loss {rec['loss'][0]:.5f}, last loss "
          f"{rec['loss'][-1]:.5f}, median step "
          f"{rec['median_step_ms']:.2f} ms", flush=True)
    return state, rec


if __name__ == "__main__":
    main()
