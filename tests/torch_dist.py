"""Spawned gloo ranks for the port's multi-device tests
(tests/test_torch_sharded.py, tests/test_torch_mesh_train.py) and the
rank bodies they run. Not a test module. Imports neither JAX nor the JAX
package, so that each spawned rank starts quickly: the tests compute the
JAX references in the pytest process and pass numpy inputs in.

`spawn(fn, world, tmp_path, *args)` runs `fn(rank, world, *args)` in
`world` processes (spawn start method, one torch thread each) joined in a
gloo group that meets through a file under `tmp_path` (no port, so pytest
workers never collide) with a 60 s timeout; it joins them within a
deadline, kills any left and fails, and returns each rank's return value
(written by the rank with `torch.save`).
"""
from __future__ import annotations

import datetime
import math
import os
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

GROUP_TIMEOUT_S = 60
JOIN_TIMEOUT_S = 150


class RankFailed(RuntimeError):
    pass


def _entry(fn, rank, world, init, out_dir, args):
    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", init_method=init, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
        out = fn(rank, world, *args)
    except BaseException:   # reported to the parent, which raises
        torch.save(("error", traceback.format_exc()),
                   os.path.join(out_dir, f"rank{rank}.pt"))
        os._exit(1)         # closes the sockets: the peers fail fast
    torch.save(("ok", out), os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def spawn(fn, world, tmp_path, *args, timeout=JOIN_TIMEOUT_S):
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    out_dir = os.path.join(str(tmp_path), f"ranks_{fn.__name__}_{world}")
    os.makedirs(out_dir)
    init = "file://" + os.path.join(out_dir, "rendezvous")
    procs = [ctx.Process(target=_entry,
                         args=(fn, r, world, init, out_dir, args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [i for i, p in enumerate(procs) if p.is_alive()]
    for i in hung:
        procs[i].kill()
        procs[i].join(10)
    results, errors = [], []
    for r in range(world):
        path = os.path.join(out_dir, f"rank{r}.pt")
        if not os.path.exists(path):
            errors.append(f"rank {r}: no result (exit code "
                          f"{procs[r].exitcode})")
            continue
        status, val = torch.load(path, weights_only=False)
        if status == "error":
            errors.append(f"rank {r}:\n{val}")
        results.append(val)
    if hung or errors:
        raise RankFailed((f"ranks {hung} hung past {timeout} s; " if hung
                          else "") + "\n".join(errors))
    return results


# ----------------------------------------------------------- scenes

def camera(width, height, fov_deg=60.0, R=None, T=None):
    """`conftest.make_test_camera`'s camera on the CPU."""
    from gaussianrpg_tpu_torch.render.camera import make_camera

    fovx = math.radians(fov_deg)
    fovy = 2 * math.atan(math.tan(fovx / 2) * height / width)
    return make_camera(R=np.eye(3) if R is None else R,
                       T=np.zeros(3) if T is None else T, K=None,
                       width=width, height=height, fovx=fovx, fovy=fovy,
                       device="cpu")


BG = (0.1, 0.2, 0.3)


def render_fn(capacity):
    """`tests/test_sharded._render_fn` for the port: planes [color,
    depth, alpha] of `rasterize`."""
    from gaussianrpg_tpu_torch.ops.rasterize import rasterize

    def fn(cam, m, op, c, s, r):
        out = rasterize(m, op, colors=c, scales=s, rotations=r, camera=cam,
                        bg_color=torch.tensor(BG), capacity=capacity,
                        device="cpu")
        return torch.cat([out.color, out.depth, out.alpha], dim=0)
    return fn


def fields_fn(cam, m, op, c, s, r):
    from gaussianrpg_tpu_torch.ops.rasterize import primitive_fields
    return primitive_fields(m, op, camera=cam, colors=c, scales=s,
                            rotations=r)


def _tensors(arrays, grad=False):
    return [torch.as_tensor(a).requires_grad_(grad) for a in arrays]


def _grads_of(loss, args, idx):
    g = torch.autograd.grad(loss, [args[i] for i in idx])
    return [x.numpy() for x in g]


# ----------------------------------------------------------- rank bodies

def strips_forward(rank, world, size, arrays, capacity):
    """`render_strips` on a `world`-rank mesh: the planes every rank
    holds."""
    from gaussianrpg_tpu_torch.parallel.sharded import (make_mesh,
                                                        render_strips)

    mesh = make_mesh()
    with torch.no_grad():
        out = render_strips(render_fn(capacity), camera(*size), mesh,
                            *_tensors(arrays))
    return out.numpy()


def strips_grads(rank, world, size, arrays, capacity, idx):
    """Gradients of sum(color^2) through `render_strips`."""
    from gaussianrpg_tpu_torch.parallel.sharded import (make_mesh,
                                                        render_strips)

    args = _tensors(arrays, grad=True)
    img = render_strips(render_fn(capacity), camera(*size), make_mesh(),
                        *args)
    return _grads_of(torch.sum(img[:3] ** 2), args, idx)


def sharded_2d(rank, world, shape, size, arrays, capacity, idx):
    """`render_sharded_2d` on an n_data x n_model mesh: the planes, and
    with `idx` the gradients of sum(color^2) w.r.t. those args."""
    from gaussianrpg_tpu_torch.parallel.sharded import (make_mesh_2d,
                                                        render_sharded_2d)

    mesh = make_mesh_2d(*shape)
    args = _tensors(arrays, grad=bool(idx))
    img = render_sharded_2d(fields_fn, camera(*size), mesh, *args,
                            capacity=capacity, bg_color=torch.tensor(BG),
                            train_mode=bool(idx))
    if not idx:
        return img.detach().numpy()
    return _grads_of(torch.sum(img[:3] ** 2), args, idx)


def psum_overlap(rank, world, size, arrays, capacity, n_sub, explicit):
    """`value_and_grad_psum_overlapped` with loss sum(color^2)."""
    from gaussianrpg_tpu_torch.parallel.sharded import (
        make_mesh, value_and_grad_psum_overlapped)

    loss, grads = value_and_grad_psum_overlapped(
        render_fn(capacity), camera(*size), make_mesh(),
        lambda planes: torch.sum(planes[:3] ** 2), n_sub,
        *_tensors(arrays), explicit_psum=explicit)
    return float(loss), [g.numpy() for g in grads]


def scene_sharded_radii(rank, world, tree, size, capacity):
    """`render_scene_sharded` of a composite scene (from the JAX
    package's tree) in eval mode: radii, visibility, planes."""
    from gaussianrpg_tpu_torch.models.convert import scene_from_tree
    from gaussianrpg_tpu_torch.parallel.sharded import (make_mesh,
                                                        render_scene_sharded)
    from gaussianrpg_tpu_torch.render.renderer import RenderOptions
    from gaussianrpg_tpu_torch.utils.synthetic import make_cameras

    models, meta, arrays = scene_from_tree(tree, device="cpu")
    cam = make_cameras(n_frames=4, width=size[0], height=size[1],
                       device="cpu")[1]
    res = render_scene_sharded(models, meta, arrays, cam, make_mesh(),
                               active_sh_degree=1,
                               options=RenderOptions(capacity=capacity),
                               device="cpu")
    return dict(radii=res.radii.numpy(), rgb=res.rgb.numpy(),
                visibility=res.visibility.numpy(),
                overflow=bool(res.overflow), n_pairs=int(res.n_pairs))


def mesh_train(rank, world, shape, tree, size, views, gts, capacity, cfg_kw):
    """Train steps of the port's trainer on a mesh (`shape` None: a 1-axis
    mesh of every rank; else (n_data, n_model)): step `it` trains view
    `views[it]` of `make_cameras(4, *size)` against `gts[views[it]]` with a
    generator seeded `it`. Returns the losses and the final state (models
    and Adam moments as nested dicts of numpy)."""
    from gaussianrpg_tpu_torch.models.convert import scene_from_tree
    from gaussianrpg_tpu_torch.models.scene_graph import total_capacity
    from gaussianrpg_tpu_torch.parallel.sharded import (make_mesh,
                                                        make_mesh_2d)
    from gaussianrpg_tpu_torch.render.renderer import RenderOptions
    from gaussianrpg_tpu_torch.train.trainer import (Batch, OptimConfig,
                                                     init_train_state,
                                                     make_train_step)
    from gaussianrpg_tpu_torch.utils.synthetic import make_cameras

    from .torch_parity import tree_of

    mesh = make_mesh() if shape is None else make_mesh_2d(*shape)
    models, meta, arrays = scene_from_tree(tree, device="cpu")
    cams = make_cameras(n_frames=4, width=size[0], height=size[1],
                        device="cpu")
    step = make_train_step(meta, arrays, OptimConfig(**cfg_kw),
                           RenderOptions(capacity=capacity),
                           total_capacity(models), device="cpu", mesh=mesh)
    state = init_train_state(models)
    losses = []
    for it, v in enumerate(views):
        state, loss, scalars, _ = step(
            state, cams[v], Batch(gt_image=torch.as_tensor(gts[v])),
            torch.Generator().manual_seed(it), 1)
        assert not scalars["overflow"]
        losses.append(float(loss))
    return losses, tree_of(dict(models=state.models, mu=state.adam.mu,
                                nu=state.adam.nu))



def mesh_schedule(rank, world, n_background, bkgd_capacity, size, capacity,
                  iters, cfg_kw):
    """`apps.train.run_training` (overflow discard-and-retry, densify and
    prune, capacity growth, opacity reset) of the synthetic scene on a
    `world`-rank `data` mesh, starting from a pair capacity of
    `capacity`. Returns ((losses, densify events, retries, final pair
    capacity, final background capacity), the final state as nested dicts
    of numpy)."""
    from gaussianrpg_tpu_torch.apps import train as A
    from gaussianrpg_tpu_torch.parallel.sharded import make_mesh
    from gaussianrpg_tpu_torch.render.renderer import RenderOptions
    from gaussianrpg_tpu_torch.train.trainer import OptimConfig

    from .torch_parity import tree_of

    mesh = make_mesh()
    models, meta, arrays, cam_gt, _ = A.synthetic_setup(
        "cpu", n_background=n_background, bkgd_capacity=bkgd_capacity,
        width=size[0], height=size[1])
    state, rec = A.run_training(
        models, meta, arrays, cam_gt, OptimConfig(**cfg_kw),
        RenderOptions(capacity=capacity), iters, device="cpu",
        log_every=iters + 1, mesh=mesh)
    return ((rec["loss"], rec["densify"], rec["retries"],
             rec["opts"].capacity, state.models.background.capacity),
            tree_of(dict(models=state.models, mu=state.adam.mu,
                         nu=state.adam.nu)))
