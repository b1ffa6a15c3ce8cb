"""Device-time breakdown of the port's frame on one card.

Counterpart of `gaussianrpg_tpu/apps/profile_trace.py`. Runs N frames of
three workloads under `torch.profiler` and prints one JSON line for each:
  frame  `rasterize` on the frozen bench scene (600k Gaussians,
         1066x1600) at the loop's 16x16 tiling;
  loop   the closed loop's render function (compose, rasterize, host copy
         of the image) on the synthetic 600k-background scene at 1066x1600;
  train  one step of the trainer (`train.trainer.make_train_step`: train
         render, losses, backward, Adam, densification statistics) on the
         synthetic 600k-background + 2-actor scene at 1066x1600.
With `--config`, two workloads of the configured scene instead:
  config_loop   `apps.simulate.config_setup`'s render function (the
                latest checkpoint, its pair capacity) on its first camera;
  config_train  one step of the trainer on the first train view with its
                loss planes, the scene and capacity as `apps.train
                --config` trains them, from the latest checkpoint.
Each line holds the host ms per frame (synchronized), the device ms per
frame spent in kernels and in copies, the device's busy ms per frame (the
union of its kernel, copy and set intervals, so work that overlaps on two
streams counts once), its idle share (1 - busy / host), and the kernels
that took the most device time. The chrome traces (`--trace`) carry the
program's spans (`utils/spans.py`: `loop.*`, `pipeline.*`, `raster.*`)
on the device records' clock:

    python -m gaussianrpg_tpu_torch.apps.profile_trace [--frames 5] \
        [--trace DIR]      # DIR/<workload>.json: chrome traces
    python -m gaussianrpg_tpu_torch.apps.profile_trace [--frames 5] \
        --config CFG --cipv ID [KEY VALUE ...]

The JAX app's flags run its workload instead: a `torch.profiler` trace of
`--steps` renders and one train step of its bench scene (20000 background
Gaussians, 2 actors, `--width` x `--height`, pair capacity 2^18), written
as a chrome trace to `--logdir`/trace.json, beside the same JSON line:

    python -m gaussianrpg_tpu_torch.apps.profile_trace [--logdir PROF] \
        [--steps 3] [--width 512] [--height 320] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import time
from collections import defaultdict


def _union_us(intervals) -> float:
    """Length of the union of [start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def _breakdown(run, frames, trace_path=None, top=12, device="cuda"):
    """Device ms by kernel over `frames` calls of `run` (after two warm-up
    calls: the second captures an eval render's CUDA graph, which the
    profiled calls replay). On the CPU (`device`) there is no device
    time: the line then holds the host ms and the CPU ops that took the
    most time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    run()                                     # warm: builds, caches
    run()                                     # the render's CUDA graph
    sync()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(frames):
            run()
        sync()
        host_s = time.perf_counter() - t0
    if trace_path:
        prof.export_chrome_trace(trace_path)
    by_name = defaultdict(float)
    copy_us = 0.0
    busy = []
    for e in prof.events():
        if e.device_type != (DeviceType.CUDA if cuda else DeviceType.CPU):
            continue
        us = e.time_range.elapsed_us()
        busy.append((e.time_range.start, e.time_range.end))
        if e.name.startswith(("Memcpy", "Memset")):
            copy_us += us
        else:
            by_name[e.name] += us
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    host_ms = host_s * 1e3 / frames
    if not cuda:
        # CPU ops nest, so their times are not summed into a device share
        return dict(frames=frames, device="cpu", host_ms=host_ms,
                    top_ops=[dict(name=n[:120], ms=us / 1e3 / frames)
                             for n, us in ranked])
    kernel_ms = sum(by_name.values()) / 1e3 / frames
    copy_ms = copy_us / 1e3 / frames
    busy_ms = _union_us(busy) / 1e3 / frames
    return dict(
        frames=frames, host_ms=host_ms, kernel_ms=kernel_ms,
        copy_ms=copy_ms, busy_ms=busy_ms,
        idle_share=1.0 - busy_ms / host_ms if by_name else None,
        top_kernels=[dict(name=n[:120], ms=us / 1e3 / frames)
                     for n, us in ranked])


def bench_scene_trace(args):
    """The JAX app's workload (`--logdir`, `--steps`, `--width`,
    `--height`): its bench scene, `--steps` renders and one train step
    under the profiler, the chrome trace written to the log directory."""
    import torch

    from ..models.scene_graph import total_capacity
    from ..render.renderer import RenderOptions, render_scene
    from ..train.trainer import (Batch, OptimConfig, init_train_state,
                                 make_train_step)
    from ..utils.device import resolve_device
    from ..utils.synthetic import make_cameras, make_scene

    dev = resolve_device(args.device)
    models, meta, arrays = make_scene(
        n_background=20000, bkgd_capacity=32768, n_actors=2,
        actor_capacity=2048, n_frames=4, device=dev)
    cams = make_cameras(n_frames=4, width=args.width, height=args.height,
                        device=dev)
    options = RenderOptions(capacity=1 << 18)
    gt = render_scene(models, meta, arrays, cams[0], active_sh_degree=1,
                      options=options, device=dev).rgb
    step = make_train_step(meta, arrays, OptimConfig(), options,
                           total_capacity(models), device=dev)
    state = init_train_state(models)
    frame = [0]

    def renders_and_step():
        for i in range(args.steps):
            render_scene(models, meta, arrays, cams[i % len(cams)],
                         active_sh_degree=1, options=options, device=dev)
        step(state, cams[0], Batch(gt_image=gt),
             torch.Generator(device=dev).manual_seed(frame[0]), 1)
        frame[0] += 1

    os.makedirs(args.logdir, exist_ok=True)
    path = os.path.join(args.logdir, "trace.json")
    rec = _breakdown(renders_and_step, 1, path, device=dev)
    print(json.dumps(dict(workload="bench_scene", renders=args.steps,
                          train_steps=1, size=f"{args.width}x{args.height}",
                          trace=path, **rec)), flush=True)
    print(f"trace written to {args.logdir} (chrome://tracing or "
          f"https://ui.perfetto.dev: {path})")


def config_workloads(args, trace):
    """The configured scene's loop render and train step (`--config`)."""
    import torch

    from ..apps.simulate import config_setup
    from ..apps.train import optim_config, view_batches, waymo_setup
    from ..config.config import load_config
    from ..models.scene_graph import total_capacity
    from ..models.scene_io import load_latest_checkpoint
    from ..train.trainer import init_train_state, make_train_step

    dev = torch.device("cuda")
    cfg = load_config(args.config, args.opts)
    _, render_fn, _, cam0, _, _, _ = config_setup(cfg, args.cipv, 0, dev)
    rec = _breakdown(lambda: render_fn(cam0), args.frames,
                     trace("config_loop"))
    print(json.dumps(dict(workload="config_loop", config=args.config,
                          **rec)), flush=True)
    del render_fn
    torch.cuda.empty_cache()

    scene, models, meta, arrays, _, cam_gt, opts = waymo_setup(cfg, dev)
    models = load_latest_checkpoint(cfg.trained_model_dir, models)
    step = make_train_step(meta, arrays, optim_config(cfg), opts,
                           total_capacity(models), device=dev)
    state = init_train_state(models)
    cam, gt = cam_gt[0]
    batch = view_batches(scene, cam_gt[:1], cfg, dev)[0]._replace(
        gt_image=torch.as_tensor(gt, device=dev))

    def train_step():
        return step(state, cam, batch,
                    torch.Generator(device=dev).manual_seed(1), 0)

    rec = _breakdown(train_step, args.frames, trace("config_train"))
    print(json.dumps(dict(workload="config_train", config=args.config,
                          capacity=opts.capacity, **rec)), flush=True)


def main(argv=None):
    import torch

    from ..apps.simulate import _synthetic_setup
    from ..apps.train import synthetic_setup
    from ..models.scene_graph import total_capacity
    from ..ops.rasterize import (primitive_fields, rasterize,
                                 suggest_binning_sizes)
    from ..train.trainer import (Batch, OptimConfig, init_train_state,
                                 make_train_step)
    from ..utils.synthetic import build_frozen_scene

    p = argparse.ArgumentParser()
    p.add_argument("--frames", type=int, default=5)
    p.add_argument("--trace", default=None)
    p.add_argument("--config", default=None)
    p.add_argument("--cipv", type=int, default=-1)
    # the JAX app's flags (its workload: `bench_scene_trace`)
    p.add_argument("--logdir", default=None)
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--device", default=None,
                   help="torch device of the JAX app's workload (default: "
                        "cuda)")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    args = p.parse_args(argv)
    jax_flags = dict(logdir="PROF", steps=3, width=512, height=320)
    if any(getattr(args, k) is not None for k in jax_flags):
        for k, v in jax_flags.items():
            if getattr(args, k) is None:
                setattr(args, k, v)
        return bench_scene_trace(args)
    if args.trace:
        os.makedirs(args.trace, exist_ok=True)

    def trace(name):
        return os.path.join(args.trace, f"{name}.json") if args.trace \
            else None

    if args.config:
        return config_workloads(args, trace)

    dev = torch.device("cuda")
    cam, (means, opac, colors, scales, quats), H, W = build_frozen_scene(
        device=dev)
    fs = primitive_fields(means, opac, camera=cam, colors=colors,
                          scales=scales, rotations=quats)
    sizes = suggest_binning_sizes(fs, width=W, height=H)
    bg = torch.zeros(3, device=dev)

    def frame():
        return rasterize(means, opac, camera=cam, bg_color=bg, colors=colors,
                         scales=scales, rotations=quats,
                         capacity=sizes.capacity, device=dev)

    rec = _breakdown(frame, args.frames, trace("frame"))
    print(json.dumps(dict(workload="frame", tile="16x16", **rec)),
          flush=True)
    del fs, means, opac, colors, scales, quats
    torch.cuda.empty_cache()

    _, render_fn, _, cam0, _, _ = _synthetic_setup(
        width=1600, height=1066, n_background=600_000,
        bkgd_capacity=600_000, device=dev)
    rec = _breakdown(lambda: render_fn(cam0), args.frames, trace("loop"))
    print(json.dumps(dict(workload="loop", tile="16x16", **rec)),
          flush=True)
    del render_fn
    torch.cuda.empty_cache()

    models, meta, arrays, cam_gt, opts = synthetic_setup(
        dev, n_background=600_000, bkgd_capacity=786_432, width=1600,
        height=1066)
    step = make_train_step(meta, arrays, OptimConfig(), opts,
                           total_capacity(models), device=dev)
    state = init_train_state(models)
    cam, gt = cam_gt[0]

    def train_step():
        # the same state every time: the step is out of place
        return step(state, cam, Batch(gt_image=gt),
                    torch.Generator(device=dev).manual_seed(1), 0)

    rec = _breakdown(train_step, args.frames, trace("train"))
    print(json.dumps(dict(workload="train", tile="16x16", **rec)),
          flush=True)


if __name__ == "__main__":
    main()
