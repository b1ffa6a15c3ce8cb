#!/usr/bin/env python3
"""Closed-loop benchmark of the PyTorch/H100 port: render -> YOLOv5s ->
AEB -> dynamics on one card, at the Waymo FRONT resolution (1066x1600).

    python3 loop_bench_gpu.py [--sim-time 10]

The port's counterpart of `loop_bench.py`: the real loop machinery
(`sim/loop.run_closed_loop`: 50 Hz dynamics, AEB controller, ground truth
and evaluation nodes) over the frozen bench scene (600k Gaussians, 64x32
tiles) with the fused inline-perception path (`sim/pipeline.py`: render,
letterbox to 384x640, YOLOv5s and the top-K prefilter on the card, the
[K, 6] candidates copied to the host, greedy NMS and ground-plane ranging
there). The ego drives at 8 m/s toward a virtual vehicle parked 150 m
ahead, so the verdict is `success`; braking events are exercised by
`chip_smoke.py` phase `perception` and tests/test_torch_perception.py.

YOLOv5s runs with random weights (`init_params(spec, seed=0)`): the same
graph and FLOPs as the real weights, whose detections are noise. TF32 is
off for matmuls and cuDNN convolutions. Prints one JSON line: the loop's
rates, the median host time of a frame, and the device times of the
render alone and of the fused step (CUDA events around one call queued
behind a spin kernel, the median over ten cameras:
`tools/_timing.device_ms_each`), whose difference is `yolo_ms`; the
launches of kernels A and B in the loop alone; with the card's name and
power limit. Needs CUDA.
"""
import argparse
import json
import math
import time

import numpy as np
import torch

EGO_SPEED = 8.0
TILE_X, TILE_Y = 64, 32
SIZE = (384, 640)
K = 256
CONF_THRES = 0.4


def yolo_flops(spec, h: int, w: int) -> int:
    """Multiply-add FLOPs (2 a product) of the graph's 60 convolutions on
    one [h, w] image; the activations, pools and decode are not counted."""
    flops = 0
    sizes = [(h, w)]        # the input's, then each layer's output size

    def conv(hw, cin, cout, k, s=1):
        nonlocal flops
        ho, wo = -(-hw[0] // s), -(-hw[1] // s)
        flops += 2 * cin * cout * k * k * ho * wo
        return ho, wo

    for lay in spec:
        x, kind = sizes[-1], lay["kind"]
        if kind == "conv":
            x = conv(x, lay["cin"], lay["cout"], lay["k"], lay["s"])
        elif kind == "c3":
            c_ = lay["cout"] // 2
            conv(x, lay["cin"], c_, 1)
            conv(x, lay["cin"], c_, 1)
            for _ in range(lay["n"]):
                conv(x, c_, c_, 1)
                conv(x, c_, c_, 3)
            x = conv(x, 2 * c_, lay["cout"], 1)
        elif kind == "sppf":
            conv(x, lay["cin"], lay["cin"] // 2, 1)
            x = conv(x, lay["cin"] // 2 * 4, lay["cout"], 1)
        elif kind == "upsample":
            x = (x[0] * 2, x[1] * 2)
        elif kind == "detect":
            for f, cin in zip(lay["frms"], lay["cins"]):
                conv(sizes[f + 1], cin, (lay["nc"] + 5) * 3, 1)
        sizes.append(x)
    return flops


def setup(sim_time: float = 10.0, seed: int = 0, device=None):
    """The frozen scene, the ego's cameras and tape, the pair capacity
    probed over the trajectory, and the fused step. Returns a dict."""
    from gaussianrpg_tpu_torch.ops.rasterize import (primitive_fields,
                                                     rasterize,
                                                     suggest_binning_sizes)
    from gaussianrpg_tpu_torch.render.camera import make_camera
    from gaussianrpg_tpu_torch.sim.detector import VEHICLE_CLASSES
    from gaussianrpg_tpu_torch.sim.pipeline import make_fused_step
    from gaussianrpg_tpu_torch.sim.tape import build_tape_from_cameras
    from gaussianrpg_tpu_torch.sim.yolo import init_params, spec_yolov5
    from gaussianrpg_tpu_torch.utils.device import resolve_device
    from gaussianrpg_tpu_torch.utils.synthetic import build_frozen_scene

    dev = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cam0, args, H, W = build_frozen_scene(dev)
    n_img = int(round(sim_time * 10)) + 1
    ts = np.arange(n_img) / 10.0
    fovx = math.radians(50.0)
    fovy = 2 * math.atan(math.tan(fovx / 2) * H / W)
    cams = []
    for i in range(n_img):
        c2w = np.eye(4)
        c2w[2, 3] = EGO_SPEED * ts[i]
        w2c = np.linalg.inv(c2w)
        cams.append(make_camera(
            R=w2c[:3, :3].T, T=w2c[:3, 3], K=None, width=W, height=H,
            fovx=fovx, fovy=fovy, ego_pose=c2w.astype(np.float32),
            timestamp=float(ts[i]), frame=i, image_id=i, device=dev))
    tape = {"frames": build_tape_from_cameras(cams, upsample_rate=5),
            "image_freq": 10, "dynamic_freq": 50}

    # a tight probe across the trajectory: every capacity-linear stage
    # (binning sort, tails, pair gather, blend grid) pays the slack
    means, opac, colors, scales, quats = args
    sizes = []
    with torch.no_grad():
        for c in cams[::8] + [cams[-1]]:
            fs = primitive_fields(means, opac, camera=c, colors=colors,
                                  scales=scales, rotations=quats,
                                  tile_x=TILE_X, tile_y=TILE_Y)
            sizes.append(suggest_binning_sizes(fs, width=W, height=H,
                                               slack=1.05, quantum=8192))
    capacity = max(s.capacity for s in sizes)
    tail_cap = max(s.tail_cap for s in sizes)
    big_cap = max(s.big_cap for s in sizes)
    emit_k = min(s.emit_k for s in sizes)
    bg = torch.zeros(3, device=dev)

    @torch.no_grad()
    def render_rgb(camera, m, op, c, s, r):
        return rasterize(m, op, colors=c, scales=s, rotations=r,
                         camera=camera, bg_color=bg, capacity=capacity,
                         tile_x=TILE_X, tile_y=TILE_Y, tail_cap=tail_cap,
                         big_cap=big_cap, emit_k=emit_k, device=dev).color

    spec = spec_yolov5()
    params = init_params(spec, seed=seed, device=dev)
    step, gain, pad = make_fused_step(render_rgb, spec, params, (H, W),
                                      size=SIZE, k=K,
                                      classes=VEHICLE_CLASSES)
    return dict(cams=cams, tape=tape, args=args, H=H, W=W,
                capacity=capacity, render_rgb=render_rgb, step=step,
                gain=gain, pad=pad, spec=spec, params=params)


def launch_counts() -> dict:
    """The kernel wrappers' launch counters: kernel B (and C), kernel A."""
    from gaussianrpg_tpu_torch.ops import blend, scan

    return {"blend_fwd": blend.launches, "cummax": scan.launches,
            "blend_bwd": blend.bwd_launches}


def measure(s: dict, sim_time: float = 10.0):
    """The measured closed loop over `setup`'s scene and its device-time
    decomposition: (the JSON record, the LoopResult). The record's
    `launches` are the kernels' launches in the loop alone, without the
    warm-up frames and the timing runs."""
    from gaussianrpg_tpu_torch.sim.detector import normalized_boxes
    from gaussianrpg_tpu_torch.sim.loop import run_closed_loop
    from gaussianrpg_tpu_torch.sim.pipeline import finish_detections
    from gaussianrpg_tpu_torch.tools._timing import (PEAK_FP32_PER_S,
                                                     cycling, device_ms_each,
                                                     smi_line)

    step, args, H, W = s["step"], s["args"], s["H"], s["W"]
    host_times, frame_times = [], []

    def perceive(camera):
        t00 = time.perf_counter()
        cand = step(camera, *args)
        t1 = time.perf_counter()
        det = finish_detections(cand, s["gain"], s["pad"], (H, W),
                                conf_thres=CONF_THRES)
        out = normalized_boxes(det, H, W)
        t2 = time.perf_counter()
        host_times.append(t2 - t1)
        frame_times.append(t2 - t00)
        return out

    # warm-up (cuDNN's plans, the caching allocator), outside the loop
    perceive(s["cams"][0])
    perceive(s["cams"][1])

    # a virtual CIPV parked 150 m ahead: still > 60 m at the end
    gt = {i: (150.0, 0.0, 0.0) for i in range(len(s["tape"]["frames"]))}
    v2c = np.array([[0., -1., 0., 0.], [0., 0., -1., 0.],
                    [1., 0., 0., 0.], [0., 0., 0., 1.]])
    before = launch_counts()
    res = run_closed_loop(
        s["tape"], None, None, s["cams"][0], gt, brake_distance=15.0,
        collision_threshold=5.0, simulation_time=sim_time,
        ranger_extrinsic=v2c, perceive_fn=perceive)
    launches = {k: n - before[k] for k, n in launch_counts().items()}

    # device times: the render alone and the fused step, one call at a
    # time on each of ten cameras (medians)
    cams = [(c, *args) for c in s["cams"][1:11]]
    render_ms = device_ms_each(cycling(s["render_rgb"], cams))
    fused_ms = device_ms_each(cycling(step.device_step, cams))
    flops = yolo_flops(s["spec"], *SIZE)
    ft = np.asarray(frame_times[2:]) * 1e3
    seq_ms = float(np.median(ft))
    rec = {
        "metric": "closed-loop render->YOLOv5s->AEB->dynamics rate on one "
                  "card (frozen bench scene, 1066x1600, fused inline "
                  "perception, sequential: brake feeds next pose)",
        "loop_hz": 1e3 / seq_ms,
        "unit": "Hz",
        "vs_baseline": 1e3 / seq_ms / 10.0,     # the 10 Hz camera rate
        "vs_reference_3090_inline": 1e3 / seq_ms / 6.0,
        "frames": res.frames_rendered,
        "verdict": res.verdict,
        "render_ms": render_ms,
        "yolo_ms": fused_ms - render_ms,
        "fused_device_ms": fused_ms,
        "host_nms_aeb_ms": float(np.mean(host_times[2:]) * 1e3),
        "sequential_frame_ms": seq_ms,
        "frame_ms_p10_p90_max": [float(np.percentile(ft, 10)),
                                 float(np.percentile(ft, 90)),
                                 float(ft.max())],
        "loop_hz_wallclock": res.frames_rendered / max(res.wall_time, 1e-9),
        "loop_hz_pipelined": 1e3 / fused_ms,
        "yolo_gflop": flops / 1e9,
        "yolo_bound_ms": flops / PEAK_FP32_PER_S * 1e3,
        "capacity": s["capacity"],
        "launches": launches,
        "device": torch.cuda.get_device_name(),
        "nvidia_smi": smi_line(),
        "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                 "cudnn": torch.backends.cudnn.allow_tf32},
        "timer": "frame: host clock around perceive_fn (render, YOLO, "
                 "top-K, copy, NMS); render/fused: device time, median "
                 "of single calls (tools/_timing.device_ms_each)",
        "note": "YOLOv5s runs random-initialized (init_params seed 0; the "
                "FLOPs are the real graph's). Sequential loop: each frame "
                "waits for its candidates before the next dynamics tick.",
    }
    return rec, res


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--sim-time", type=float, default=10.0,
                   help="seconds of simulation (10 Hz imaging)")
    p.add_argument("--seed", type=int, default=0, help="YOLO weights seed")
    a = p.parse_args(argv)
    t0 = time.perf_counter()
    s = setup(a.sim_time, a.seed)
    setup_s = time.perf_counter() - t0
    rec, _ = measure(s, a.sim_time)
    print(json.dumps(dict(rec, setup_s=setup_s)))


if __name__ == "__main__":
    main()
