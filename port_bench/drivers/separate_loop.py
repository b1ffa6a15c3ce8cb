"""The separate-perception cell: the frozen cell's scene and traffic
(`closed_loop.py`), perceived as the reference's default ROS2 graph does
it, where a separate object-detector node perceives the simulator's
published rgb8 front image. A frame makes the calls the two nodes make,
without rclpy: the render's float32 [3, H, W] image goes to the host;
the simulator node's `ros2.simulator.rgb8_bytes` turns it into the
message's bytes; the detector node's `ros2.object_detector.decode_rgb8`
reads them back from an object with the message's `data`, `height` and
`width`, and `sim.detector.YoloDetector` (its checkpoint the cell's
seeded weights file) letterboxes it on the host, runs YOLOv5s on the
card and keeps what NMS keeps on the host. Ranging, the AEB and the
dynamics are `sim.loop.run_closed_loop`'s.

A run draws what the frozen cell draws from the seed, in the same order
(so one seed gives both cells the same scene, weights, starts and
frames), sets the Detect head the same way, writes the weights as a
YOLOv5 checkpoint under the checkout's `build/`, builds the detector on
it, sizes the pair capacity over every camera and runs the first second
of one episode as warm-up; then the window as the frozen cell's; with
`trace`, a stretch of one more episode under the profiler, the render
inside a `record_function` range as in the frozen cell, whose program
spans give the hand-off's host time (`ros2.rgb8`, `ros2.decode`) and the
detector's device time (`detector.yolo`). The check is the frozen cell's, except
that the reference's YOLOv5s runs on the program's own image after the
hand-off (`reference.perceived.rgb8_round_trip` of the rendered image,
letterboxed on the host), and that the decisions are replayed from the
detections NMS kept; on the sampled frames NMS itself is replayed on the
program's predictions (a frame whose detections differ counts as one
decision mismatch). The images are held to `reference/raster.py`.

Needs a program whose `sim.yolo.YoloDetector` has `predict`: without it
the set-up stops at once.
"""
from __future__ import annotations

import math
import os
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from .. import inputs, spans as sp, trace as tr
from ..reference import perceived, raster, street
from ..reference import yolo as ref_yolo
from .closed_loop import RENDER, V2C, ClosedLoop, _cameras, _ranges, _State
from .street_yolo_loop import write_checkpoint

HANDOFF = ("ros2.rgb8", "ros2.decode")
WEIGHTS = "build/port_bench/frozen600k_yolov5s.pt"   # one file a process
DETECTOR = "detector.yolo"


def handoff_readings(events: list) -> tuple:
    """({span: (host us, count)} of the hand-off's and the detector's
    spans, the hand-off's host us, the device us launched inside
    `detector.yolo`) of a trace's events; None where a span is absent."""
    host = sp.span_host_us(events, HANDOFF + (DETECTOR,))
    handoff = sum(host[n][0] for n in HANDOFF) \
        if all(host[n][1] for n in HANDOFF) else None
    yolo_us = sp.span_device_us(events, (DETECTOR,))[DETECTOR] \
        if host[DETECTOR][1] else None
    return host, handoff, yolo_us


class SeparateLoop(ClosedLoop):
    # -- set-up ---------------------------------------------------------
    def setup(self):
        from gaussianrpg_tpu_torch.ops import blend
        from gaussianrpg_tpu_torch.ops import rasterize as R
        from gaussianrpg_tpu_torch.render.camera import make_camera
        from gaussianrpg_tpu_torch.ros2.object_detector import decode_rgb8
        from gaussianrpg_tpu_torch.ros2.simulator import rgb8_bytes
        from gaussianrpg_tpu_torch.sim import yolo as port_yolo
        from gaussianrpg_tpu_torch.sim.detector import YoloDetector
        from gaussianrpg_tpu_torch.sim.tape import build_tape_from_cameras

        if not hasattr(port_yolo.YoloDetector, "predict"):
            raise RuntimeError("sim.yolo.YoloDetector has no predict")
        cfg, wl, dev = self.cfg, self.wl, self.dev
        sc, yc = cfg["scene"], cfg["yolo"]
        self.blend = blend
        gen, rng = inputs.generators(self.seed, dev)
        self.scene = inputs.frozen_scene(sc, gen, dev)
        weights = inputs.yolo_weights(yc, gen, dev)
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
        path = write_checkpoint(yc, self.weights, WEIGHTS)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        try:
            det = YoloDetector(weights_path=path, size=tuple(yc["input_hw"]),
                               conf_thres=yc["conf_thres"],
                               iou_thres=yc["iou_thres"], device=dev)
            det._ensure()
        finally:
            os.remove(path)

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
        st.preds = {}

        @torch.no_grad()
        def render_fn(camera):
            # the simulator node's render; the image crosses to the host
            k = st.frame
            st.frame += 1
            st.starts.append(time.perf_counter())
            if st.on_frame is not None:
                st.on_frame(k)
            with _ranges(st.tracing, RENDER):
                out = R.rasterize(s["means"], s["opacities"],
                                  colors=s["colors"], scales=s["scales"],
                                  rotations=s["quats"], camera=camera,
                                  bg_color=bg, capacity=cap, tile_x=tx,
                                  tile_y=ty, tail_cap=tail, big_cap=big,
                                  emit_k=emit, device=dev)
            img = out.color.cpu().numpy()
            if k in st.samples:
                st.images[k] = torch.from_numpy(img)
            return img

        inner = det._det
        predict = inner.predict

        def recorded_predict(image):
            pred, gain, pad = predict(image)
            if st.frame - 1 in st.samples:
                st.preds[st.frame - 1] = pred
            return pred, gain, pad

        inner.predict = recorded_predict

        class Detector:
            """The simulator node's message and the detector node."""

            def detect(self, img, cam):
                msg = SimpleNamespace(data=rgb8_bytes(img),
                                      height=img.shape[1],
                                      width=img.shape[2])
                boxes = det.detect(decode_rgb8(msg), cam)
                st.cands.append(boxes)
                return boxes

        self.render_fn, self.detector = render_fn, Detector()
        self.gain, _, self.pad = ref_yolo.letterbox_geometry(
            (self.H, self.W), yc["input_hw"])
        self.model = det
        # warm-up: every shape, the allocator, the render's graph; the
        # frames all have one shape, so a second of the episode does
        self.episode(self.offsets[0], seconds=1.0)

    def episode(self, offset, seconds=None):
        from gaussianrpg_tpu_torch.sim.loop import run_closed_loop

        st, wl = self.st, self.wl
        st.frame = 0
        st.cands = []                # this episode's boxes, by frame
        return run_closed_loop(
            self.tapes[offset], self.render_fn, self.detector,
            self.templates[offset], self.gt,
            brake_distance=wl["brake_distance_m"],
            collision_threshold=wl["collision_threshold_m"],
            simulation_time=seconds or wl["episode_s"],
            cam_height=wl["cam_height_m"], ranger_extrinsic=V2C)

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
                if k >= 1:
                    prof.step()
                if k == a:
                    mark["t0"] = time.perf_counter()

            st.on_frame, st.tracing = on_frame, True
            kept, st.samples = st.samples, set()   # the window's samples stay
            self.episode(self.offsets[0])
            st.on_frame, st.tracing, st.samples = None, False, kept
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
        events = tr.export_events(prof)
        summary = tr.summarize(events, (RENDER,))
        host, handoff, yolo_us = handoff_readings(events)
        print(f"port_bench: traced frames {a}-{a + n_act - 1}: host ms a "
              "frame " + ", ".join(f"{k}: {v * 1e-3 / n_act:.3f} ({c})"
                                   for k, (v, c) in host.items())
              + f"; detector device ms a frame "
              f"{(yolo_us or 0.0) * 1e-3 / n_act:.3f}; "
              f"{summary['n_device']} device records", file=sys.stderr)
        return dict(summary=summary, window_s=mark["t1"] - mark["t0"],
                    frames=n_act, handoff_us=handoff, detector_us=yolo_us,
                    render=RENDER, stretch=[(self.offsets[0], k)
                             for k in range(a, a + n_act)])

    def release(self):
        """Drop the program's detector before the reference runs."""
        self.model = self.detector = self.render_fn = None

    def counts(self, frames) -> list:
        """No metric of this cell reads the blend's counts."""
        return []

    # -- the check ------------------------------------------------------
    def replay_boxes(self, offset, boxes) -> "street.aeb.Episode":
        """The reference's episode from one start on the boxes the
        program's detector kept for each frame: the frozen cell's
        planned poses, its vehicle at a fixed gap ahead and its ranger."""
        wl, sc = self.wl, self.cfg["scene"]
        plan = self.plans[offset]
        positions = [np.float32(np.linalg.inv(c)[:3, 3]).astype(np.float64)
                     for c in plan]
        times = [float(np.float32(k / wl["image_hz"]))
                 for k in range(len(plan))]
        cam = raster.pinhole_camera(plan[0], math.radians(sc["fovx_deg"]),
                                    self.W, self.H, "cpu")
        K = np.array([[cam.fx, 0, self.W / 2], [0, cam.fy, self.H / 2],
                      [0, 0, 1]], np.float32)
        return street.replay(
            lambda k, pos: boxes[k] if k < len(boxes) else [],
            positions=positions, times=times, rate=self.rate,
            dynamics_hz=wl["dynamics_hz"], episode_s=wl["episode_s"],
            gap_at=lambda k, pos: wl["cipv_ahead_m"] + offset + pos[2],
            brake_distance=wl["brake_distance_m"],
            collision_m=wl["collision_threshold_m"], K=K, v2c=V2C,
            hw=(self.H, self.W), cam_height=wl["cam_height_m"])

    def replays(self) -> dict:
        if getattr(self, "_replays", None) is None:
            self._replays = {off: self.replay_boxes(off, boxes)
                             for off, (_, boxes) in self.last.items()}
        return self._replays

    def reference_perception(self, images: dict, tf32: bool = False,
                             dtype: torch.dtype | None = None) -> dict:
        """The reference's YOLOv5s predictions and top-K candidates of the
        program's `images` after the rgb8 hand-off, letterboxed on the
        host."""
        preds, cands = {}, {}
        for k, img in images.items():
            preds[k], cands[k] = perceived.perceive(
                self.lays, self.weights, perceived.rgb8_round_trip(img),
                self.cfg["yolo"], host=True, tf32=tf32, dtype=dtype)
        return dict(preds=preds, cands=cands)

    def reference_outputs(self, field_dtype=None, tf32: bool = False,
                          dtype: torch.dtype | None = None) -> dict:
        """The reference's images of the sampled frames of the window's
        last episode, at the camera poses of its replay, and its
        perception of the program's images of those frames."""
        frames = self.replays()[self.episodes[-1][0]].frames
        images = {}
        with torch.no_grad():
            for k in self.samples:
                if k < len(frames):
                    c2w = np.eye(4)
                    c2w[:3, 3] = -frames[k].position
                    images[k] = self.reference_frame(
                        c2w, field_dtype=field_dtype)
        mine = {k: self.st.images[k] for k in images}
        return dict(images=images, **self.reference_perception(
            mine, tf32=tf32, dtype=dtype))

    def program_outputs(self) -> dict:
        """The program's images and the top-K candidates of its
        predictions on those frames."""
        yc = self.cfg["yolo"]
        cands = {}
        for k, pred in self.st.preds.items():
            if k in self.st.images:
                cands[k] = ref_yolo.top_candidates(
                    torch.from_numpy(pred), yc["top_k"],
                    yc["classes"]).numpy()
        return dict(images=self.st.images, cands=cands)

    def nms_mismatches(self) -> int:
        """Sampled frames of the window's last episode whose kept boxes
        differ from what the reference's NMS keeps of the program's own
        predictions there (by count, or by more than 1e-6 of the image)."""
        boxes = self.last[self.episodes[-1][0]][1]
        yc, bad = self.cfg["yolo"], 0
        for k, pred in self.st.preds.items():
            if k >= len(boxes):
                continue
            want = perceived.detections(torch.from_numpy(pred), yc,
                                        self.gain, self.pad,
                                        (self.H, self.W))
            got = boxes[k]
            bad += int(len(got) != len(want) or (len(want) > 0 and float(
                np.abs(np.asarray(got, np.float64)
                       - np.asarray(want, np.float64)).max()) > 1e-6))
        return bad

    def check(self):
        """(compared numbers, frames attempted, decisions failed)."""
        nums, frames, _ = super().check()
        nums["decision_mismatches"] += self.nms_mismatches()
        return nums, frames, nums["decision_mismatches"]


Cell = SeparateLoop
