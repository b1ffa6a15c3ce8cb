"""Pixel-throughput scaling of the strip-sharded eval render.

Counterpart of `gaussianrpg_tpu/apps/scaling_bench.py`: the same scene
(`--gaussians` random Gaussians of 2-6 px in front of a 50-degree camera,
seed 0), the same flags and defaults and the same JSON line per point:
devices, platform, pixels_per_s, scaling_efficiency_vs_1dev, frame_ms.
The JAX app drives 1, 2, 4, ... devices from one process; here the points
are meshes of the first 1, 2, 4, ... ranks of a launch, which render the
strips of one frame while the other ranks wait:

    python -m torch.distributed.run --nproc_per_node N \\
        -m gaussianrpg_tpu_torch.apps.scaling_bench [--dist-backend gloo]

Each rank's device is `cuda:LOCAL_RANK % device_count()` unless
`--device` names one. A point's frame time is rank 0's host time of a
frame (ended by synchronizing its device), averaged over `--reps`. Rank 0
prints the lines; `backend` names the process group's backend (ranks
sharing one card under gloo measure that sharing, not scaling).
"""
from __future__ import annotations

import argparse
import json
import math
import time


def main(argv=None):
    import numpy as np
    import torch
    import torch.distributed as dist

    from ..ops.rasterize import rasterize
    from ..parallel.distributed import (host_local_mesh_info, initialize,
                                        local_device)
    from ..parallel.sharded import make_mesh, render_strips
    from ..render.camera import make_camera

    p = argparse.ArgumentParser()
    p.add_argument("--width", type=int, default=1600)
    p.add_argument("--height", type=int, default=1066)
    p.add_argument("--gaussians", type=int, default=200_000)
    p.add_argument("--capacity", type=int, default=1 << 20)
    p.add_argument("--reps", type=int, default=4)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda:LOCAL_RANK)")
    p.add_argument("--dist-backend", choices=("nccl", "gloo"),
                   default="nccl")
    args = p.parse_args(argv)

    dev = local_device(args.device)
    if not initialize(args.dist_backend):
        raise RuntimeError(
            "scaling_bench runs under the launcher: python -m "
            "torch.distributed.run --nproc_per_node N -m "
            "gaussianrpg_tpu_torch.apps.scaling_bench")
    rank, n_ranks, _ = host_local_mesh_info()
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    rng = np.random.default_rng(0)
    n = args.gaussians
    means = np.stack([rng.uniform(-30, 30, n),
                      rng.uniform(-8, 2, n),
                      rng.uniform(0.5, 100, n)], -1).astype(np.float32)
    fovx = math.radians(50.0)
    fl = args.width / (2 * math.tan(fovx / 2))
    sigma = rng.uniform(2.0, 6.0, n)
    zc = np.clip(means[:, 2], 1.0, None)
    scales = (sigma * zc / fl)[:, None].repeat(3, 1).astype(np.float32)
    q = np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1))
    opac = rng.uniform(0.5, 0.95, n).astype(np.float32)
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    fovy = 2 * math.atan(math.tan(fovx / 2) * args.height / args.width)
    cam = make_camera(R=np.eye(3), T=np.zeros(3), K=None, width=args.width,
                      height=args.height, fovx=fovx, fovy=fovy, device=dev)
    margs = [torch.as_tensor(a, device=dev)
             for a in (means, opac, colors, scales, q)]
    bg = torch.zeros(3, device=dev)

    def render_fn(c, m, op, co, s, r):
        return rasterize(m, op, colors=co, scales=s, rotations=r, camera=c,
                         bg_color=bg, capacity=args.capacity,
                         device=dev).color

    px = args.width * args.height
    base = None
    for nd in [s for s in (1, 2, 4, 8, 16, 32) if s <= n_ranks]:
        mesh = make_mesh(range(nd))      # every rank takes part in this
        if mesh is not None:
            with torch.no_grad():
                render_strips(render_fn, cam, mesh, *margs)    # warm-up
                sync()
                t0 = time.perf_counter()
                for i in range(args.reps):
                    render_strips(render_fn, cam, mesh, margs[0], margs[1],
                                  margs[2] * (1.0 + 1e-6 * i), *margs[3:])
                    sync()
                dt = (time.perf_counter() - t0) / args.reps
        dist.barrier()
        if rank == 0:
            pps = px / dt
            base = pps if base is None else base
            print(json.dumps({
                "devices": nd, "platform": "gpu" if dev.type == "cuda"
                else "cpu", "pixels_per_s": round(pps),
                "scaling_efficiency_vs_1dev": round(pps / (base * nd), 3),
                "frame_ms": round(dt * 1e3, 1),
                "backend": dist.get_backend()}), flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
