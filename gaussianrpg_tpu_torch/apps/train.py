"""Training CLI; counterpart of `gaussianrpg_tpu/apps/train.py`.

    python -m gaussianrpg_tpu_torch.apps.train [--device cuda] \
        --config configs/waymo_149_1cam.yaml source_path <scene dir> \
        [KEY VALUE ...]

reads the Waymo scene (`data/waymo.WaymoScene`, the converter's layout),
builds the composite scene (`models/scene_builder`), trains with the
configured loss planes (sky mask, LiDAR depth, object bound, mono normal,
semantics: each wired when every train view has it), resumes from the
latest `trained_model/iteration_*.npz` when there is one, and writes the
JAX package's checkpoint and composite PLY files. `--device` and the other
flags go before the `KEY VALUE` overrides.

    python -m gaussianrpg_tpu_torch.apps.train --synthetic --iterations 200

trains the synthetic street scene (also when `source_path` is empty),
with the same resume, checkpoints and PLYs.

    python -m torch.distributed.run --nproc_per_node N \
        -m gaussianrpg_tpu_torch.apps.train --mesh N [--dist-backend gloo] ...

trains either scene on an N-rank `data` mesh (the JAX app's `--mesh N`
over N devices of one process; here N processes, one a rank): each rank
renders a tile strip of every view, the gradients are summed over the
ranks and every rank takes the same steps. Each rank's device is
`cuda:LOCAL_RANK % device_count()` unless `--device` names one; NCCL
(the default `--dist-backend`) needs one card a rank, gloo also runs
several ranks on one card or on the CPU. Rank 0 alone prints, evaluates
and writes the checkpoints, PLYs and TensorBoard logs. `--mesh N` outside
an N-rank launch raises.

`run_training` is the loop itself (overflow discard-and-retry, densify and
prune, capacity growth, opacity reset, SH-degree upgrade, evaluation, the
per-iteration hook that writes checkpoints), shared with `chip_smoke.py`.
"""
from __future__ import annotations

import contextlib
import os
import statistics
import time
import zipfile

import numpy as np
import torch

from ..models import gaussians as G
from ..models.scene_graph import actor_extents, total_capacity
from ..render.renderer import (RenderOptions, options_from_cfg,
                               probe_scene_capacity, render_scene)
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


def _log_eval(rec, writer, split, it, rep):
    rec["evals" if split == "train" else "evals_test"].append(dict(it=it,
                                                                   **rep))
    print(f"  [eval {split}] iter {it}: psnr {rep['psnr']:.2f} "
          f"l1 {rep['l1']:.4f} ({rep['n_views']} views)", flush=True)
    if writer is not None:
        writer.add_scalar(f"eval_{split}/psnr", rep["psnr"], it)
        writer.add_scalar(f"eval_{split}/l1", rep["l1"], it)


def run_training(models, meta, arrays, cam_gt, ocfg: OptimConfig,
                 opts: RenderOptions, iters: int, *, device=None,
                 seed: int = SEED, test_iters=(), log_every: int = 50,
                 batches=None, state: TrainState | None = None,
                 start_it: int = 0, active_sh: int = 0, test_cam_gt=(),
                 writer=None, on_step_end=None, mesh=None):
    """The training loop over `cam_gt` [(camera, gt image [3, H, W] or
    None)]: one random view per iteration (views without an image are
    skipped), overflow discard-and-retry, the densify / capacity-growth /
    opacity-reset / SH-upgrade schedule of the JAX trainer, evaluation of
    `test_cam_gt` and the first four views at `test_iters` and the last
    iteration. `batches` holds each view's loss planes (Batch without the
    image); `state`, `start_it` and `active_sh` resume a checkpoint;
    `writer` is a TensorBoard writer or None; `on_step_end(it, state,
    active_sh)` runs after every iteration (checkpoints, PLYs). With a
    `mesh` (`parallel.sharded.Mesh`; every rank calls this with the same
    arguments) the steps render tile strips over it and only the mesh's
    first rank evaluates.
    Returns (state, record): per-iteration losses and host step times
    (synchronized), densify events, overflow retries, evaluations."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    if state is None:
        state = init_train_state(models)
    n_total = total_capacity(state.models)

    def make_step(o):
        return make_train_step(meta, arrays, ocfg, o, n_total, device=dev,
                               mesh=mesh)

    step_fn = make_step(opts)
    max_sh = meta.bkgd_sh_degree
    rec = dict(loss=[], step_s=[], densify=[], retries=0, evals=[],
               evals_test=[])
    ema_loss = ema_psnr = 0.0
    t0 = time.time()
    for it in range(start_it + 1, iters + 1):
        if it % 1000 == 0 and active_sh < max_sh:
            active_sh += 1
        ci = int(rng.integers(len(cam_gt)))
        cam, gt = cam_gt[ci]
        if gt is None:
            continue
        batch = (batches[ci]._replace(gt_image=gt) if batches is not None
                 else Batch(gt_image=gt))
        gen = torch.Generator(device=dev).manual_seed(it)
        ts = time.perf_counter()
        step_fn, opts, state, loss, scalars, res, retries = \
            step_with_overflow_retry(step_fn, make_step, opts, state, cam,
                                     batch, gen, active_sh)
        loss_f = float(loss)          # synchronizes the step
        rec["step_s"].append(time.perf_counter() - ts)
        rec["loss"].append(loss_f)
        rec["retries"] += retries
        ema_loss = 0.4 * loss_f + 0.6 * ema_loss
        ema_psnr = 0.4 * float(psnr(res.rgb, gt)) + 0.6 * ema_psnr
        if writer is not None and it % 10 == 0:
            writer.add_scalar("train/loss", loss_f, it)
            writer.add_scalar("train/ema_psnr", ema_psnr, it)
            for k, v in scalars.items():
                writer.add_scalar(f"train/{k}", float(v), it)
        if it % log_every == 0:
            print(f"[{it}/{iters}] loss {ema_loss:.5f} psnr {ema_psnr:.2f} "
                  f"({(time.time() - t0) / (it - start_it):.3f}s/it)",
                  flush=True)

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

        if it in set(test_iters) | {iters} and (mesh is None or mesh.lead):
            for split, cams in (("test", test_cam_gt), ("train", cam_gt[:4])):
                rep = evaluate_views(state.models, meta, arrays, cams, opts,
                                     active_sh, device=dev)
                if rep is not None:
                    _log_eval(rec, writer, split, it, rep)
        if on_step_end is not None:
            on_step_end(it, state, active_sh)
    rec["median_step_ms"] = (statistics.median(rec["step_s"]) * 1e3
                             if rec["step_s"] else None)
    rec["opts"] = opts
    return state, rec


def synthetic_scene(device=None, n_background=5000, bkgd_capacity=16384,
                    sh_degree=SH_DEGREE, fourier_dim=FOURIER_DIM):
    """The JAX trainer's synthetic scene (`train.py:200-205`): by default
    5000 background Gaussians (capacity 16384) and 2 actors (1024 each)
    over 10 frames. Returns (models, meta, arrays)."""
    from ..utils.synthetic import make_scene

    return make_scene(
        n_background=n_background, bkgd_capacity=bkgd_capacity, n_actors=2,
        actor_capacity=1024, n_frames=10, sh_degree=sh_degree,
        fourier_dim=fourier_dim, device=resolve_device(device))


def synthetic_setup(device=None, n_background=5000, bkgd_capacity=16384,
                    width=256, height=160, sh_degree=SH_DEGREE,
                    fourier_dim=FOURIER_DIM):
    """The JAX trainer's synthetic scene (`synthetic_scene`) and views: 10
    frames at 256x160 by default (`chip_smoke.py` and `profile_trace` ask
    for 600k at 1600x1066); ground truth is the initial render, then the
    background's DC colours are perturbed. Returns (models, meta, arrays,
    cam_gt, opts)."""
    from ..utils.synthetic import make_cameras

    dev = resolve_device(device)
    models, meta, arrays = synthetic_scene(dev, n_background, bkgd_capacity,
                                           sh_degree, fourier_dim)
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


def _make_writer(logdir: str):
    """TensorBoard writer where tensorboard is installed, else None (as
    the JAX trainer)."""
    try:
        from torch.utils.tensorboard import SummaryWriter
        return SummaryWriter(logdir)
    except Exception:
        return None


def optim_config(cfg) -> OptimConfig:
    """OptimConfig from a config's `optim` block (the keys the JAX
    trainer reads)."""
    o = cfg.optim
    return OptimConfig(
        position_lr_init=o.position_lr_init,
        position_lr_final=o.position_lr_final,
        position_lr_max_steps=o.position_lr_max_steps,
        feature_lr=o.feature_lr,
        opacity_lr=o.opacity_lr,
        scaling_lr=o.scaling_lr,
        rotation_lr=o.rotation_lr,
        position_lr_init_obj=o.get("position_lr_init_obj"),
        position_lr_final_obj=o.get("position_lr_final_obj"),
        feature_lr_obj=o.get("feature_lr_obj"),
        feature_rest_lr_obj=o.get("feature_rest_lr_obj"),
        scaling_lr_obj=o.get("scaling_lr_obj"),
        rotation_lr_obj=o.get("rotation_lr_obj"),
        opacity_lr_obj=o.get("opacity_lr_obj"),
        semantic_lr_obj=o.get("semantic_lr_obj"),
        lambda_l1=o.lambda_l1,
        lambda_dssim=o.lambda_dssim,
        lambda_sky=o.lambda_sky,
        lambda_semantic=o.lambda_semantic,
        lambda_depth_lidar=o.lambda_depth_lidar,
        lambda_reg=o.get("lambda_reg", 0.0),
        lambda_normal_mono=o.get("lambda_normal_mono", 0.0),
        lambda_scale_flatten=o.get("lambda_scale_flatten", 0.0),
        lambda_opacity_sparse=o.get("lambda_opacity_sparse", 0.0),
        densify_from_iter=o.densify_from_iter,
        densify_until_iter=o.densify_until_iter,
        densification_interval=o.densification_interval,
        opacity_reset_interval=o.opacity_reset_interval,
        densify_grad_threshold=o.densify_grad_threshold,
        densify_grad_abs_bkgd=o.get("densify_grad_abs_bkgd", False),
        densify_grad_threshold_obj=o.get("densify_grad_threshold_obj"),
        densify_grad_abs_obj=o.get("densify_grad_abs_obj", False),
        min_opacity=o.min_opacity,
        percent_dense=o.percent_dense,
        percent_big_ws=o.percent_big_ws,
    )


PLANE_KEYS = ("sky_mask", "lidar_depth", "obj_bound", "mono_normal",
              "semantic")


def view_batches(scene, cam_gt, cfg, device) -> list:
    """Each train view's loss planes as a Batch (without the image), on
    `device`. A plane is wired only when every view has it, so every step
    sees one Batch structure."""
    all_planes = [scene.load_batch_planes(int(c.frame), c.cam_id,
                                          gt.shape[1:])
                  if gt is not None else {} for c, gt in cam_gt]
    have = {k: all(k in p for p in all_planes) for k in PLANE_KEYS}
    lss = list(cfg.optim.get("lambda_sky_scale", []) or [])

    def plane(planes, k):
        return (torch.as_tensor(planes[k], device=device) if have[k]
                else None)

    return [Batch(gt_image=None, sky_mask=plane(p, "sky_mask"),
                  lidar_depth=plane(p, "lidar_depth"),
                  obj_bound=plane(p, "obj_bound"),
                  mono_normal=plane(p, "mono_normal"),
                  gt_semantic=plane(p, "semantic"),
                  sky_scale=(torch.tensor(float(lss[c.cam_id]),
                                          device=device)
                             if lss and c.cam_id < len(lss) else None))
            for (c, _), p in zip(cam_gt, all_planes)]


def images_on(cam_gt, device) -> list:
    """[(camera, image on `device` or None)] from host images."""
    return [(c, None if g is None else torch.as_tensor(g, device=device))
            for c, g in cam_gt]


def resume(cfg, state: TrainState):
    """Best-effort resume from the latest checkpoint of
    `cfg.trained_model_dir` (`train.py:36-47`): (state, start iteration,
    active SH degree), or the given state and 0 when there is none or it
    does not fit the scene."""
    from ..models.scene_io import load_checkpoint, search_max_iteration

    it0 = search_max_iteration(cfg.trained_model_dir)
    if not cfg.get("resume", True) or it0 is None:
        return state, 0, 0
    try:
        state2, start_it, sh = load_checkpoint(
            os.path.join(cfg.trained_model_dir, f"iteration_{it0}.npz"),
            state)
    except (OSError, ValueError, KeyError, EOFError,
            zipfile.BadZipFile) as e:
        print(f"resume from iteration {it0} failed ({e}); training from "
              "scratch", flush=True)
        return state, 0, 0
    print(f"resumed from iteration {it0}", flush=True)
    return state2, start_it, sh


def mesh_setup(n: int, backend: str, device=None):
    """(mesh, device) of `--mesh n`: this rank's device, the process group
    from the launcher's environment, and an n-rank `data` mesh. Raises
    unless the launch has exactly n ranks."""
    from ..parallel.distributed import (host_local_mesh_info, initialize,
                                        local_device)
    from ..parallel.sharded import make_mesh

    dev = local_device(device)
    if not initialize(backend):
        raise RuntimeError(
            f"--mesh {n} trains on {n} ranks, one process each: launch it "
            f"with `python -m torch.distributed.run --nproc_per_node {n} -m "
            "gaussianrpg_tpu_torch.apps.train --mesh ...`")
    _, world, _ = host_local_mesh_info()
    if world != n:
        raise RuntimeError(f"--mesh {n}, but the launch has {world} ranks")
    return make_mesh(), dev


def main(argv=None):
    from ..config.config import load_config, make_argparser

    parser = make_argparser("gaussianrpg_tpu_torch training")
    parser.add_argument("--synthetic", action="store_true",
                        help="train the synthetic street scene")
    parser.add_argument("--iterations", type=int, default=None)
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda; with --mesh, "
                             "cuda:LOCAL_RANK)")
    parser.add_argument(
        "--mesh", type=int, default=0, metavar="N",
        help="train with the render tile-strip-sharded over N ranks "
             "(replicated parameters, gradients summed over the ranks); "
             "launch with python -m torch.distributed.run "
             "--nproc_per_node N")
    parser.add_argument("--dist-backend", choices=("nccl", "gloo"),
                        default="nccl",
                        help="process-group backend of --mesh (nccl: one "
                             "card a rank; gloo: CPU ranks, or ranks "
                             "sharing a card)")
    args = parser.parse_args(argv)
    mesh = None
    if args.mesh and args.mesh > 1:
        mesh, dev = mesh_setup(args.mesh, args.dist_backend, args.device)
    else:
        dev = resolve_device(args.device)
    with contextlib.ExitStack() as stack:
        if mesh is not None and not mesh.lead:
            stack.enter_context(contextlib.redirect_stdout(
                stack.enter_context(open(os.devnull, "w"))))
        if mesh is not None:
            print(f"training on a {args.mesh}-rank 'data' mesh "
                  f"({args.dist_backend}, {dev})", flush=True)
        cfg = load_config(args.config, args.opts, mode="train")
        iters = args.iterations or cfg.train.iterations
        ocfg = optim_config(cfg)
        test_iters = set(cfg.train.get("test_iterations", []))
        t0 = time.time()
        train = (train_synthetic if args.synthetic or not cfg.source_path
                 else train_waymo)
        state, rec = train(cfg, ocfg, iters, test_iters, dev, mesh)
        losses = rec["loss"]
        summary = (f", first loss {losses[0]:.5f}, last loss "
                   f"{losses[-1]:.5f}, median step "
                   f"{rec['median_step_ms']:.2f} ms" if losses else "")
        print(f"done: {iters} iters in {time.time() - t0:.1f}s{summary}",
              flush=True)
    if mesh is not None:
        import torch.distributed as dist
        dist.destroy_process_group()
    return state, rec


def waymo_setup(cfg, dev):
    """The configured scene as `train_waymo` trains it: (scene, models,
    meta, arrays, actor names, [(camera, host image)] of the train split,
    render options right-sized on the built scene)."""
    from ..data.waymo import WaymoScene
    from ..models.scene_builder import build_scene_from_waymo

    scene = WaymoScene(
        cfg.source_path,
        selected_frames=cfg.data.selected_frames or None,
        cameras=tuple(cfg.data.cameras),
        box_scale=cfg.data.get("box_scale", 1.0),
        test_every=(cfg.data.split_test
                    if cfg.data.split_test > 0 else None),
        train_every=(cfg.data.split_train
                     if cfg.data.split_train > 0 else None),
        resolution=cfg.resolution)
    models, meta, arrays, actor_names = build_scene_from_waymo(
        scene, cfg, device=dev)
    cam_gt = scene.build_cameras("train", device=dev)
    opts = options_from_cfg(
        cfg.render,
        render_normals=bool(cfg.optim.get("lambda_normal_mono", 0.0)))
    if cfg.render.get("autosize", True):
        opts = _autosize(opts, [c for c, _ in cam_gt], models, meta, arrays)
    return scene, models, meta, arrays, actor_names, cam_gt, opts


def checkpoint_writer(cfg, iters: int, actor_names=None):
    """The per-iteration hook of both branches of `main`: a checkpoint at
    `checkpoint_iterations` and a composite PLY at `save_iterations`, each
    with the last iteration (`train.py:495-504`)."""
    from ..models.scene_io import save_checkpoint, save_composite_ply

    os.makedirs(cfg.trained_model_dir, exist_ok=True)
    os.makedirs(cfg.point_cloud_dir, exist_ok=True)
    ckpt_iters = set(cfg.train.checkpoint_iterations) | {iters}
    ply_iters = set(cfg.train.save_iterations) | {iters}

    def save(it, state, active_sh):
        if it in ckpt_iters:
            path = os.path.join(cfg.trained_model_dir, f"iteration_{it}.npz")
            save_checkpoint(path, state, it, active_sh)
            print(f"  checkpoint -> {path}", flush=True)
        if it in ply_iters:
            ply_dir = os.path.join(cfg.point_cloud_dir, f"iteration_{it}")
            os.makedirs(ply_dir, exist_ok=True)
            save_composite_ply(os.path.join(ply_dir, "point_cloud.ply"),
                               state.models, actor_names)
    return save


def _resumed(cfg, models, meta):
    """(state, start iteration, active SH degree) after `resume`."""
    state, start_it, sh = resume(cfg, init_train_state(models))
    return state, start_it, (min(sh, meta.bkgd_sh_degree) if start_it > 0
                             else 0)


def _outputs(cfg, iters: int, mesh, actor_names=None):
    """(TensorBoard writer or None, per-iteration hook or None): the run's
    outputs, written by the mesh's first rank alone."""
    if mesh is not None and not mesh.lead:
        return None, None
    return (_make_writer(os.path.join(cfg.model_path, "tensorboard")),
            checkpoint_writer(cfg, iters, actor_names))


def train_synthetic(cfg, ocfg: OptimConfig, iters: int, test_iters, dev,
                    mesh=None):
    """The synthetic branch of `main` (`train.py:200-226`): the scene at
    the config's SH degree and Fourier size, resume, and the checkpoints
    and PLYs of `checkpoint_writer`."""
    gcfg = cfg.model.gaussian
    models, meta, arrays, cam_gt, opts = synthetic_setup(
        dev, sh_degree=gcfg.sh_degree,
        fourier_dim=gcfg.get("fourier_dim", FOURIER_DIM))
    state, start_it, active_sh = _resumed(cfg, models, meta)
    writer, on_step_end = _outputs(cfg, iters, mesh)
    state, rec = run_training(
        models, meta, arrays, cam_gt, ocfg, opts, iters, device=dev,
        seed=cfg.seed, test_iters=test_iters, state=state, start_it=start_it,
        active_sh=active_sh, writer=writer, on_step_end=on_step_end,
        mesh=mesh)
    if writer is not None:
        writer.close()
    return state, rec


def train_waymo(cfg, ocfg: OptimConfig, iters: int, test_iters, dev,
                mesh=None):
    """The Waymo branch of `main`: scene, batches, resume, training with
    the checkpoints and PLYs of `checkpoint_writer`."""
    scene, models, meta, arrays, actor_names, cam_gt, opts = waymo_setup(
        cfg, dev)
    test_cam_gt = images_on(scene.build_cameras("test", device=dev), dev)
    batches = view_batches(scene, cam_gt, cfg, dev)
    cam_gt = images_on(cam_gt, dev)
    state, start_it, active_sh = _resumed(cfg, models, meta)
    writer, on_step_end = _outputs(cfg, iters, mesh, actor_names)
    state, rec = run_training(
        models, meta, arrays, cam_gt, ocfg, opts, iters, device=dev,
        seed=cfg.seed, test_iters=test_iters, batches=batches, state=state,
        start_it=start_it, active_sh=active_sh, test_cam_gt=test_cam_gt,
        writer=writer, on_step_end=on_step_end, mesh=mesh)
    if writer is not None:
        writer.close()
    return state, rec


if __name__ == "__main__":
    main()
