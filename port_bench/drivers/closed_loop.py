"""Closed-loop cells: the port's AEB simulator (`sim.loop.run_closed_loop`)
with fused inline perception (`sim.pipeline.make_fused_step` over
`ops.rasterize.rasterize` and YOLOv5), episode after episode.

The workload file gives the ego's speed, the image and dynamics rates,
the episode length, a virtual vehicle ahead, the brake and collision
distances, the ego's lateral starts (one episode each), the number of
frames the check compares and the traced stretch. A run:

1. makes the scene and the YOLOv5 weights from the seed on the device,
   sets the Detect head on the reference's image of the view where the
   ego will stop so that it finds the configuration's number of objects
   there (`inputs.calibrate_detect`; the peak-memory counter is reset
   after this reference frame), draws
   the order of the lateral starts, the compared frames and the traced
   stretch from the seed, builds each start's cameras and tape, sizes the
   pair capacity over every camera, and runs one whole episode as warm-up
   (set-up ends at the window's first frame);
2. runs whole cycles of the episodes until `seconds` are within half a
   cycle, so every run drives the same frames: `loop_frame_ms` is the
   window over the frames rendered in it, `loop_frame_p95_ms` the 95th
   percentile of the times from one frame's start to the next's. The
   objects that NMS keeps are ranged on the ground plane and the AEB
   brakes for the nearest in its lane; once it brakes, the ego stops;
3. with `trace`, one more episode in which a stretch of frames drawn from
   the seed is profiled, the render callable and the fused step each
   inside a `record_function` range;
4. reads the peak memory, frees the program's state, and checks the
   window against the plain reference: every episode's verdict and frame
   count, and for the last episode of each start every frame's
   detection count and brake command as `reference.aeb.replay` works
   them out from the frame's candidates; on the sampled frames of the
   last episode, the rendered image and the top-K candidates, at the
   camera poses the replay gives.
"""
from __future__ import annotations

import contextlib
import math
import sys
import time

import numpy as np
import torch

from .. import compare, inputs, trace as tr
from ..reference import aeb, raster, yolo as ref_yolo

RENDER, STEP = "port_bench.render", "port_bench.step"


class _State:
    """What the loop's callbacks share with the harness."""

    def __init__(self, samples):
        self.frame = 0
        self.starts = []
        self.samples = set(samples)
        self.images = {}
        self.cands = []              # this episode's candidates, by frame
        self.on_frame = None
        self.tracing = False         # ranges around render and step


def _cameras(wl, offset):
    """c2w poses of one episode's planned frames (camera at the ego's
    start offset, driving along +z)."""
    n = int(round(wl["episode_s"] * wl["image_hz"])) + 1
    poses = []
    for k in range(n):
        c2w = np.eye(4)
        c2w[0, 3] = offset
        c2w[2, 3] = wl["ego_speed_mps"] * k / wl["image_hz"]
        poses.append(c2w)
    return poses


def _ranges(on, name):
    """A `record_function` range while tracing, else nothing."""
    if on:
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


# vehicle frame of the ranger: forward +z_cam, left -x_cam, up -y_cam
V2C = np.array([[0., -1., 0., 0.], [0., 0., -1., 0.],
                [1., 0., 0., 0.], [0., 0., 0., 1.]])


class ClosedLoop:
    def __init__(self, cfg, wl, seed, device):
        self.cfg, self.wl = cfg, wl
        self.seed, self.dev = seed, torch.device(device)

    # -- set-up ---------------------------------------------------------
    def setup(self):
        from gaussianrpg_tpu_torch.ops import blend
        from gaussianrpg_tpu_torch.ops import rasterize as R
        from gaussianrpg_tpu_torch.render.camera import make_camera
        from gaussianrpg_tpu_torch.sim.pipeline import make_fused_step
        from gaussianrpg_tpu_torch.sim.tape import build_tape_from_cameras
        from gaussianrpg_tpu_torch.sim.yolo import YoloV5, spec_yolov5

        cfg, wl, dev = self.cfg, self.wl, self.dev
        sc, yc = cfg["scene"], cfg["yolo"]
        self.blend = blend
        gen, rng = inputs.generators(self.seed, dev)
        self.scene = inputs.frozen_scene(sc, gen, dev)
        weights = inputs.yolo_weights(yc, gen, dev)
        # every run drives the same episodes, one per lateral start, in an
        # order drawn from the seed: the start moves the facades nearer or
        # farther, and with it the frame's work
        order = rng.permutation(len(wl["lateral_offsets_m"]))
        self.offsets = [float(wl["lateral_offsets_m"][i]) for i in order]
        n = int(round(wl["episode_s"] * wl["image_hz"])) + 1
        self.samples = sorted(set(rng.choice(n - 1, wl["samples"] - 1,
                                             replace=False).tolist())
                              | {n - 1})
        tw = wl["trace"]
        self.stretch = int(rng.integers(tw["warmup_frames"],
                                        n - tw["frames"]))
        self.W, self.H = sc["width"], sc["height"]
        self.lays = ref_yolo.layers(yc["depth_multiple"],
                                    yc["width_multiple"], yc["num_classes"])
        self.plans = {off: _cameras(wl, off) for off in self.offsets}
        self.rate = int(round(wl["dynamics_hz"] / wl["image_hz"]))
        with torch.no_grad():
            img = self.reference_frame(self.stop_pose(self.offsets[0]))
            boxed, _, _ = ref_yolo.letterbox(img, tuple(yc["input_hw"]))
            raw = ref_yolo.predict(self.lays, weights, boxed,
                                   yc["num_classes"], raw=True)
            self.weights = inputs.calibrate_detect(weights, raw, yc)
        del img, boxed, raw, weights
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

        fovx = math.radians(sc["fovx_deg"])
        fovy = 2 * math.atan(math.tan(fovx / 2) * self.H / self.W)
        self.tapes, self.templates, cams = {}, {}, []
        for off in self.offsets:
            oc = []
            for k, c2w in enumerate(self.plans[off]):
                w2c = np.linalg.inv(c2w)
                oc.append(make_camera(
                    R=w2c[:3, :3].T, T=w2c[:3, 3], K=None, width=self.W,
                    height=self.H, fovx=fovx, fovy=fovy,
                    ego_pose=c2w.astype(np.float32),
                    timestamp=k / wl["image_hz"], frame=k, image_id=k,
                    device=dev))
            self.templates[off] = oc[0]
            self.tapes[off] = {"frames": build_tape_from_cameras(oc,
                                                                 self.rate),
                               "image_freq": wl["image_hz"],
                               "dynamic_freq": wl["dynamics_hz"]}
            cams += oc
        self.gt = {i: (wl["cipv_ahead_m"], 0.0, 0.0)
                   for i in range(len(self.tapes[self.offsets[0]]["frames"]))}

        s = self.scene
        args = (s["means"], s["opacities"], s["colors"], s["scales"],
                s["quats"])
        tx, ty = sc["tile_x"], sc["tile_y"]
        sizes = []
        with torch.no_grad():
            for c in cams:
                fs = R.primitive_fields(s["means"], s["opacities"], camera=c,
                                        colors=s["colors"],
                                        scales=s["scales"],
                                        rotations=s["quats"], tile_x=tx,
                                        tile_y=ty)
                sizes.append(R.suggest_binning_sizes(
                    fs, width=self.W, height=self.H,
                    slack=wl["capacity_slack"], quantum=8192))
        cap = max(z.capacity for z in sizes)
        tail = max(z.tail_cap or 0 for z in sizes) or None
        big = max(z.big_cap or 0 for z in sizes) or None
        emit = min((z.emit_k for z in sizes if z.emit_k), default=None)
        bg = torch.zeros(3, device=dev)
        st = self.st = _State(self.samples)

        @torch.no_grad()
        def render_rgb(camera, m, op, c, sc_, r):
            with _ranges(st.tracing, RENDER):
                out = R.rasterize(m, op, colors=c, scales=sc_, rotations=r,
                                  camera=camera, bg_color=bg, capacity=cap,
                                  tile_x=tx, tile_y=ty, tail_cap=tail,
                                  big_cap=big, emit_k=emit, device=dev)
            if st.frame - 1 in st.samples:
                st.images[st.frame - 1] = out.color
            return out.color

        spec = spec_yolov5(yc["num_classes"], yc["depth_multiple"],
                           yc["width_multiple"])
        with torch.device(dev):
            model = YoloV5(spec)
        _load_yolo(model, spec, self.weights)
        self.model = model.eval()
        step, gain, pad = make_fused_step(
            render_rgb, spec, self.model, (self.H, self.W),
            size=tuple(yc["input_hw"]), k=yc["top_k"],
            classes=tuple(yc["classes"]))
        self.step, self.args = step, args
        device_step = step.device_step

        def ranged_device_step(camera, *a):
            with _ranges(st.tracing, STEP):
                return device_step(camera, *a)

        step.device_step = ranged_device_step
        self.gain, self.pad = gain, pad
        self.episode(self.offsets[0])     # warm-up: every shape, allocator

    def episode(self, offset):
        from gaussianrpg_tpu_torch.sim.detector import normalized_boxes
        from gaussianrpg_tpu_torch.sim.loop import run_closed_loop
        from gaussianrpg_tpu_torch.sim.pipeline import finish_detections

        st, yc, wl = self.st, self.cfg["yolo"], self.wl
        st.frame = 0
        st.cands = []

        def perceive(camera):
            k = st.frame
            st.frame += 1
            st.starts.append(time.perf_counter())
            if st.on_frame is not None:
                st.on_frame(k)
            cand = self.step(camera, *self.args)
            st.cands.append(cand.copy())
            det = finish_detections(cand, self.gain, self.pad,
                                    (self.H, self.W),
                                    conf_thres=yc["conf_thres"],
                                    iou_thres=yc["iou_thres"])
            return normalized_boxes(det, self.H, self.W)

        return run_closed_loop(
            self.tapes[offset], None, None, self.templates[offset], self.gt,
            brake_distance=wl["brake_distance_m"],
            collision_threshold=wl["collision_threshold_m"],
            simulation_time=wl["episode_s"], cam_height=wl["cam_height_m"],
            ranger_extrinsic=V2C, perceive_fn=perceive)

    # -- the measured window --------------------------------------------
    def window(self, seconds: float) -> dict:
        """Whole cycles of the episodes (one per lateral start) until
        `seconds` are within half a cycle."""
        st = self.st
        st.starts = []
        self.episodes, self.last = [], {}
        t0 = time.perf_counter()
        while True:
            c0 = time.perf_counter()
            for off in self.offsets:
                res = self.episode(off)
                self.episodes.append((off, res.verdict, res.frames_rendered,
                                      res.log))
                self.last[off] = (res.log, st.cands)
            t1 = time.perf_counter()
            if t1 - t0 >= seconds - 0.5 * (t1 - c0):
                break
        gaps = np.diff(np.asarray(st.starts + [t1])) * 1e3
        return dict(loop_frame_ms=(t1 - t0) * 1e3 / len(st.starts),
                    loop_frame_p95_ms=float(np.percentile(gaps, 95)))

    # -- the traced stretch ---------------------------------------------
    def traced(self) -> dict:
        from torch.profiler import ProfilerActivity, profile, schedule

        st, tw = self.st, self.wl["trace"]
        a, n_act = self.stretch, tw["frames"]
        w = tw["warmup_frames"]
        mark = {}
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=a - w, warmup=w, active=n_act,
                                       repeat=1)) as prof:
            def on_frame(k):
                if k == a + n_act:
                    mark["t1"] = time.perf_counter()
                    mark["b1"] = self.blend.launches
                if k >= 1:
                    prof.step()
                if k == a:
                    mark["t0"] = time.perf_counter()
                    mark["b0"] = self.blend.launches

            st.on_frame, st.tracing = on_frame, True
            kept, st.samples = st.samples, set()   # the window's samples stay
            self.episode(self.offsets[0])
            st.on_frame, st.tracing, st.samples = None, False, kept
        torch.cuda.synchronize()
        summary = tr.summarize(tr.export_events(prof), (RENDER, STEP))
        print(f"port_bench: traced frames {a}-{a + n_act - 1}: "
              f"{tr.kernel_us(summary, 'blend_fwd')[1]} records of kernel B "
              f"for {mark['b1'] - mark['b0']} launches, "
              f"{summary['n_device']} device records; launches inside "
              + ", ".join(f"{n}: {len(ids)} in {k} ranges" for n, (ids, k)
                          in summary["ranges"].items()), file=sys.stderr)
        return dict(summary=summary, window_s=mark["t1"] - mark["t0"],
                    frames=n_act, blend_launches=mark["b1"] - mark["b0"],
                    render=RENDER, step=STEP,
                    stretch=[(self.offsets[0], k)
                             for k in range(a, a + n_act)])

    def release(self):
        """Drop the program's state before the reference runs."""
        self.step = self.model = None

    # -- the check ------------------------------------------------------
    def reference_frame(self, c2w, count=False, field_dtype=None):
        sc, s = self.cfg["scene"], self.scene
        cam = raster.pinhole_camera(c2w, math.radians(sc["fovx_deg"]),
                                    self.W, self.H, self.dev)
        return raster.render(
            s["means"], s["scales"], s["quats"], s["opacities"], s["colors"],
            cam, tile_x=sc["tile_x"], tile_y=sc["tile_y"],
            bg=torch.zeros(3, device=self.dev), count=count,
            field_dtype=field_dtype)

    def replay(self, offset, cands) -> aeb.Episode:
        """The reference's episode from one start on these candidates."""
        wl, yc, sc = self.wl, self.cfg["yolo"], self.cfg["scene"]
        plan = self.plans[offset]
        # a tape holds each camera's pose and time as float32
        positions = [np.float32(np.linalg.inv(c)[:3, 3]).astype(np.float64)
                     for c in plan]
        times = [float(np.float32(k / wl["image_hz"]))
                 for k in range(len(plan))]
        cam = raster.pinhole_camera(plan[0], math.radians(sc["fovx_deg"]),
                                    self.W, self.H, "cpu")
        K = np.array([[cam.fx, 0, self.W / 2], [0, cam.fy, self.H / 2],
                      [0, 0, 1]], np.float32)
        gain, _, pad = ref_yolo.letterbox_geometry((self.H, self.W),
                                                   yc["input_hw"])
        return aeb.replay(
            cands, positions=positions, times=times, rate=self.rate,
            dynamics_hz=wl["dynamics_hz"], episode_s=wl["episode_s"],
            ahead_m=wl["cipv_ahead_m"], ego_x_m=offset,
            brake_distance=wl["brake_distance_m"],
            collision_m=wl["collision_threshold_m"],
            conf_thres=yc["conf_thres"], iou_thres=yc["iou_thres"],
            gain=gain, pad=pad, hw=(self.H, self.W), K=K, v2c=V2C,
            cam_height=wl["cam_height_m"])

    def stop_pose(self, offset) -> np.ndarray:
        """c2w of the view where the ego stops when the AEB brakes from
        frame 1 on for an object straight ahead at the image's bottom
        edge (about 7 m away), as the replay works it out."""
        yc = self.cfg["yolo"]
        h, w = yc["input_hw"]
        cand = np.zeros((yc["top_k"], 6), np.float32)
        cand[0] = (w / 2, h - h / 16, w / 16, h / 8, 1.0, yc["classes"][0])
        ep = self.replay(offset, [cand] * len(self.plans[offset]))
        c2w = np.eye(4)
        c2w[:3, 3] = -ep.frames[-1].position
        return c2w

    def replays(self) -> dict:
        if getattr(self, "_replays", None) is None:
            self._replays = {off: self.replay(off, cands)
                             for off, (_, cands) in self.last.items()}
        return self._replays

    def reference_outputs(self, field_dtype=None) -> dict:
        """The plain reference's images, predictions and candidates of the
        sampled frames of the window's last episode, at the camera poses
        of its replay; `field_dtype` gives the control's form."""
        frames = self.replays()[self.episodes[-1][0]].frames
        images = {}
        with torch.no_grad():
            for k in self.samples:
                c2w = np.eye(4)
                c2w[:3, 3] = -frames[k].position
                images[k] = self.reference_frame(c2w,
                                                 field_dtype=field_dtype)
        return dict(images=images, **self.reference_perception(images))

    def reference_perception(self, images: dict) -> dict:
        """The reference's YOLOv5 predictions and top-K candidates of
        `images`."""
        yc = self.cfg["yolo"]
        preds, cands = {}, {}
        with torch.no_grad():
            for k, img in images.items():
                boxed, _, _ = ref_yolo.letterbox(img, tuple(yc["input_hw"]))
                preds[k] = ref_yolo.predict(self.lays, self.weights, boxed,
                                            yc["num_classes"])
                cands[k] = ref_yolo.top_candidates(preds[k], yc["top_k"],
                                                   yc["classes"])
        return dict(preds=preds, cands=cands)

    def program_outputs(self) -> dict:
        """The program's images and candidates of those frames."""
        cands = self.last[self.episodes[-1][0]][1]
        return dict(images=self.st.images,
                    cands={k: cands[k] for k in self.samples
                           if k < len(cands)})

    def numbers(self, out: dict, ref: dict) -> dict:
        """The compared numbers of `out` (the program's outputs, or the
        control's) against the reference."""
        yc = self.cfg["yolo"]
        nums = compare.image_gaps(out["images"], ref["images"])
        nums.update(compare.candidate_gaps(out["cands"], ref["cands"],
                                           ref["preds"], yc["classes"]))
        return nums

    def decisions(self) -> int:
        """Mismatches of the loop's decisions against the replay: each
        episode's verdict and frame count, and for the last episode of
        each start each frame's detection count and brake command (a
        missing or extra frame counts once)."""
        reps = self.replays()
        bad = sum(1 for off, verdict, n, _ in self.episodes
                  if verdict != reps[off].verdict
                  or n != len(reps[off].frames))
        for off, (log, _) in self.last.items():
            ref = reps[off].frames
            bad += abs(len(log) - len(ref))
            bad += sum(1 for e, r in zip(log, ref)
                       if e["n_det"] != r.n_det or e["brake"] != r.brake)
        return bad

    def check(self):
        """(compared numbers, frames attempted, decisions failed)."""
        logs = [e for *_, log in self.episodes for e in log]
        dets = [e["n_det"] for e in logs]
        print(f"port_bench: NMS kept {np.mean(dets):.2f} detections a frame "
              f"({min(dets)}-{max(dets)}); the AEB braked on "
              f"{sum(1 for e in logs if e['brake'] != 0.0)} of {len(logs)} "
              "frames", file=sys.stderr)
        nums = self.numbers(self.program_outputs(), self.reference_outputs())
        nums["decision_mismatches"] = self.decisions()
        frames = sum(n for _, _, n, _ in self.episodes)
        return nums, frames, nums["decision_mismatches"]

    def counts(self, frames) -> list:
        """The reference's blend counts on `frames` ((offset, frame)) of
        the traced episode, which replays the first start."""
        reps = self.replays()
        out = []
        with torch.no_grad():
            for o, k in frames:
                c2w = np.eye(4)
                c2w[:3, 3] = -reps[o].frames[k].position
                out.append(self.reference_frame(c2w, count=True)[1])
        return out


def _load_yolo(model, spec, weights):
    """The benchmark's weights into the port's graph, conv by conv in the
    reference's order."""
    it = iter(weights)

    def put(conv):
        w, b = next(it)
        with torch.no_grad():
            conv.weight.copy_(w)
            conv.bias.copy_(b)

    for lay, mod in zip(spec, model.layers):
        kind = lay["kind"]
        if kind == "conv":
            put(mod.conv)
        elif kind in ("c3", "sppf"):
            for name in ("cv1", "cv2", "cv3"):
                if hasattr(mod, name):
                    put(getattr(mod, name).conv)
            for bm in getattr(mod, "m", ()):
                put(bm.cv1.conv)
                put(bm.cv2.conv)
        elif kind == "detect":
            for conv in mod.m:
                put(conv)
    if next(it, None) is not None:
        raise ValueError("more weights than the graph has convs")


Cell = ClosedLoop
