"""The street cell with YOLOv5s: GaussianRPG's own loop on the port, the
Street Gaussians composite scene perceived by YOLOv5s on the card through
`apps.simulate.loop_setup`'s fused branch, the one its users take when
they give `sim.yolov5_weights_path`.

The traffic is the street cell's (`street_loop.py`): the ego's speed, the
lead's gap and speed, the episode length, one episode per lateral start,
the ranger's height, the compared frames and the traced stretch. A run:

1. draws the street cell's scene from the seed (`street_inputs.draw`),
   then YOLOv5s's weights (`inputs.yolo_weights`), and the starts'
   order, the compared frames and the traced stretch as that cell does;
   sets the Detect head on the reference's image of the view where the
   first start's episode ends when the AEB brakes from its first frame
   (`inputs.calibrate_detect`); writes the weights as a YOLOv5 checkpoint
   under the checkout's `build/`, names it `sim.yolov5_weights_path` and
   calls `loop_setup`, which reads it and returns its fused
   `perceive_fn` (`sim.pipeline.FusedPerception`); stops if the
   configuration's `yolo` block asks for an input size, top K, classes
   or thresholds other than those `loop_setup` applies, since the
   reference follows the block; runs one whole episode as warm-up;
2. runs whole cycles of the episodes until `seconds` are within half a
   cycle (`loop_frame_ms`, `loop_frame_p95_ms` as in the street cell);
3. with `trace`, profiles a stretch of one more episode of the first
   start: the fused step's device work and the render inside it, each
   in a `record_function` range as in the frozen cell; the program's
   spans (`pipeline.render`, which holds `scene.compose`,
   `scene.rasterize` and `scene.sky`; the perception
   spans `pipeline.letterbox`, `pipeline.yolo`, `pipeline.topk`; the
   host's `pipeline.fetch`, `pipeline.nms`, `pipeline.regrow`), the
   kernel records and the program's counters (the street cell's, and
   `pipeline.regrows`);
4. frees the program's loop and graph, and checks the window against the
   plain reference (`reference/street.py`, `reference/perceived.py`):
   every episode's verdict and frame count; for the last episode of each
   start every frame's detection count and brake command, as the
   reference's replay works them out from that frame's candidates; on
   the sampled frames of the window's last episode, the composite image
   and the top-K candidates of the reference's YOLOv5s on its own image,
   at the camera poses the replay gives.

Needs a program whose `loop_setup` returns a `FusedPerception`: without
one the set-up stops at once.
"""
from __future__ import annotations

import contextlib
import inspect
import os
import sys
import time

import numpy as np
import torch

from .. import compare, inputs, spans as sp, street_inputs as si
from .. import trace as tr
from ..core import ROOT
from ..reference import perceived, street
from ..reference import yolo as ref_yolo
from . import street_loop
from .closed_loop import RENDER, STEP, _ranges
from .street_loop import SCATTER, StreetLoop, _delta, _State

SPANS = ("pipeline.render", "pipeline.letterbox", "pipeline.yolo",
         "pipeline.topk", "pipeline.fetch", "pipeline.nms",
         "pipeline.regrow", "scene.compose", "scene.rasterize", "scene.sky")


def loop_setup_applies(pf) -> dict:
    """What `loop_setup`'s fused branch applies of a `yolo` block: the
    fused step's input size, top K and classes, and the thresholds of
    the host tail it calls with its defaults."""
    from gaussianrpg_tpu_torch.sim.pipeline import finish_detections

    tail = inspect.signature(finish_detections).parameters
    return dict(input_hw=list(pf.step.size), top_k=pf.step.k,
                classes=[int(c) for c in pf.step.classes],
                conf_thres=tail["conf_thres"].default,
                iou_thres=tail["iou_thres"].default)


def _counters() -> dict:
    """The street cell's counters and the fused branch's regrows."""
    from gaussianrpg_tpu_torch.sim import pipeline

    return dict(street_loop._counters(), regrows=pipeline.regrows)


def yolo_checkpoint(spec, weights: list) -> dict:
    """A YOLOv5 state dict in the published key layout whose batch-norm
    fold (`sim.yolo.load_torch_checkpoint`, eps 1e-3) gives `weights`
    (the reference's convs, in `conv_shapes` order): each conv's weight
    and bias as they are, behind a batch norm of scale 1, mean 0 and
    variance 1 - eps (exactly 1 with eps added, in float32)."""
    eps = np.float32(1e-3)
    var = np.float32(1) - eps
    assert var + eps == np.float32(1)
    it = iter(weights)
    sd = {}

    def convbn(prefix):
        w, b = (t.detach().float().cpu() for t in next(it))
        sd[f"{prefix}.conv.weight"] = w
        sd[f"{prefix}.bn.weight"] = torch.ones_like(b)
        sd[f"{prefix}.bn.bias"] = b
        sd[f"{prefix}.bn.running_mean"] = torch.zeros_like(b)
        sd[f"{prefix}.bn.running_var"] = torch.full_like(b, float(var))

    for i, lay in enumerate(spec):
        base = f"model.{i}"
        if lay["kind"] == "conv":
            convbn(base)
        elif lay["kind"] == "c3":
            for name in ("cv1", "cv2", "cv3"):
                convbn(f"{base}.{name}")
            for j in range(lay["n"]):
                convbn(f"{base}.m.{j}.cv1")
                convbn(f"{base}.m.{j}.cv2")
        elif lay["kind"] == "sppf":
            convbn(f"{base}.cv1")
            convbn(f"{base}.cv2")
        elif lay["kind"] == "detect":
            for j in range(3):
                w, b = (t.detach().float().cpu() for t in next(it))
                sd[f"{base}.m.{j}.weight"] = w
                sd[f"{base}.m.{j}.bias"] = b
    if next(it, None) is not None:
        raise ValueError("more weights than the graph has convs")
    return sd


def write_checkpoint(yc: dict, weights: list, rel_path: str) -> str:
    """The weights as a YOLOv5 checkpoint of `yc`'s graph at `rel_path`
    under the checkout, with this process's id before the suffix (one
    file a process); its path."""
    from gaussianrpg_tpu_torch.sim.yolo import spec_yolov5

    spec = spec_yolov5(yc["num_classes"], yc["depth_multiple"],
                       yc["width_multiple"])
    stem, ext = os.path.splitext(rel_path)
    path = ROOT / f"{stem}_{os.getpid()}{ext}"
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(yolo_checkpoint(spec, weights), path)
    return str(path)


def span_readings(events: list) -> tuple:
    """(device us launched inside each of `SPANS`, of binning's scatter
    inside `scene.rasterize`) of a trace's events."""
    ids = sp.span_ids(events, SPANS)
    by_corr = sp._device_by_corr(events)
    scatter = tr.union_us(
        (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
        for e in events if e.get("cat") in tr.DEVICE_CATS
        and SCATTER in e.get("name", "")
        and tr._corr(e) in ids["scene.rasterize"])
    return {n: sp.device_us(by_corr, v) for n, v in ids.items()}, scatter


class StreetYoloLoop(StreetLoop):
    # -- set-up ---------------------------------------------------------
    def setup(self):
        from gaussianrpg_tpu_torch.apps.simulate import loop_setup
        from gaussianrpg_tpu_torch.config.config import (DEFAULT_CONFIG,
                                                         CfgNode, merge)
        from gaussianrpg_tpu_torch.sim.pipeline import FusedPerception
        from gaussianrpg_tpu_torch.sim.tape import build_tape_from_cameras

        cfg, wl, dev = self.cfg, self.wl, self.dev
        sim, yc = cfg["config"]["sim"], cfg["yolo"]
        gen, rng = inputs.generators(self.seed, dev)
        self.scene = si.draw(cfg, wl, gen, dev)
        weights = inputs.yolo_weights(yc, gen, dev)
        models, meta, arrays = si.scene_models(self.scene, cfg, dev)
        order = rng.permutation(len(wl["lateral_offsets_m"]))
        self.offsets = [float(wl["lateral_offsets_m"][i]) for i in order]
        hz = si.image_hz(cfg)
        n = int(round(wl["episode_s"] * hz)) + 1
        self.samples = sorted(set(rng.choice(n - 1, wl["samples"] - 1,
                                             replace=False).tolist())
                              | {n - 1})
        tw = wl["trace"]
        self.stretch = int(rng.integers(tw["warmup_frames"],
                                        n - tw["frames"]))
        self.rate = int(round(sim["dynamic_freq"] / sim["image_freq"]))
        self.tapes, cams = {}, []
        for off in self.offsets:
            oc = si.episode_cameras(cfg, wl, off, dev)
            self.tapes[off] = {"frames": build_tape_from_cameras(oc,
                                                                 self.rate),
                               "image_freq": sim["image_freq"],
                               "dynamic_freq": sim["dynamic_freq"]}
            cams += oc
        self.gt = si.lead_tracklets(cfg, wl)
        H, W = cfg["scene"]["height"], cfg["scene"]["width"]
        self.gain, _, self.pad = ref_yolo.letterbox_geometry(
            (H, W), yc["input_hw"])
        self.lays = ref_yolo.layers(yc["depth_multiple"],
                                    yc["width_multiple"], yc["num_classes"])
        with torch.no_grad():
            img = street.frame(self.scene, self.stop_view(self.offsets[0]),
                               self.meta())
            boxed, _, _ = ref_yolo.letterbox(img, tuple(yc["input_hw"]))
            raw = ref_yolo.predict(self.lays, weights, boxed,
                                   yc["num_classes"], raw=True)
            self.weights = inputs.calibrate_detect(weights, raw, yc)
        del img, boxed, raw, weights
        path = write_checkpoint(yc, self.weights, cfg["yolov5_weights_path"])
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

        pcfg = merge(CfgNode.from_dict(DEFAULT_CONFIG), cfg["config"])
        pcfg.sim.yolov5_weights_path = path
        try:
            with contextlib.redirect_stdout(sys.stderr):
                self.loop = loop_setup(models, meta, arrays, cams,
                                       self.tapes[self.offsets[0]], pcfg,
                                       device=dev)
        finally:
            os.remove(path)
        pf = self.loop["perceive_fn"]
        if not isinstance(pf, FusedPerception):
            raise RuntimeError("loop_setup did not take its fused branch")
        differ = {k: (yc[k], v) for k, v in loop_setup_applies(pf).items()
                  if yc[k] != v}
        if differ:
            raise ValueError(
                "the yolo block differs from what loop_setup applies "
                "(configured, applied): " + ", ".join(
                    f"{k} {a!r}, {b!r}" for k, (a, b) in differ.items()))
        # `st.boxes` holds each frame's candidates here
        st = self.st = _State(self.samples)
        st.tracing = False
        render_rgb, device_step = pf.step.render_rgb, pf.step.device_step

        def sampled_render(camera, *a):
            with _ranges(st.tracing, RENDER):
                rgb = render_rgb(camera, *a)
            if st.frame - 1 in st.samples:
                st.images[st.frame - 1] = rgb
            return rgb

        def ranged_device_step(camera, *a):
            with _ranges(st.tracing, STEP):
                return device_step(camera, *a)

        pf.step.render_rgb = sampled_render
        pf.step.device_step = ranged_device_step

        def perceive(cam):
            k = st.frame
            st.frame += 1
            st.starts.append(time.perf_counter())
            if st.on_frame is not None:
                st.on_frame(k)
            boxes = pf(cam)
            st.boxes.append(pf.candidates)
            return boxes

        self.perceive = perceive
        self.episode(self.offsets[0])     # warm-up: every shape, the graph

    def stop_view(self, offset) -> street.View:
        """The reference's view of the frame where a start's episode ends
        when the AEB brakes from its first frame on, for an object
        straight ahead at the image's bottom edge."""
        box = (0.5, 1.0 - 1.0 / 16, 1.0 / 16, 1.0 / 8)
        ep = self._replay(offset, lambda k, pos: [box])
        return self.view(offset, len(ep.frames) - 1, ep.frames[-1].position)

    def episode(self, offset):
        from gaussianrpg_tpu_torch.sim.loop import run_closed_loop

        st, wl, lp = self.st, self.wl, self.loop
        sim = self.cfg["config"]["sim"]
        st.frame = 0
        st.boxes = []
        with contextlib.redirect_stdout(sys.stderr):
            return run_closed_loop(
                self.tapes[offset], None, None, lp["camera_template"],
                self.gt, brake_distance=sim["brake_distance"],
                collision_threshold=sim["collision_threshold"],
                simulation_time=wl["episode_s"],
                cam_height=wl["cam_height_m"],
                ranger_extrinsic=lp["ranger_extrinsic"],
                perceive_fn=self.perceive)

    # -- the measured window --------------------------------------------
    def window(self, seconds: float) -> dict:
        """The street cell's window, and the frames rendered again in it."""
        from gaussianrpg_tpu_torch.sim import pipeline

        r0 = pipeline.regrows
        out = super().window(seconds)
        self.window_counts["regrows"] = pipeline.regrows - r0
        print(f"port_bench: regrows in the window "
              f"{self.window_counts['regrows']}", file=sys.stderr)
        return out

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
                    mark["t1"], mark["c1"] = time.perf_counter(), _counters()
                if k >= 1:
                    prof.step()
                if k == a:
                    mark["t0"], mark["c0"] = time.perf_counter(), _counters()

            st.on_frame, st.tracing = on_frame, True
            kept, st.samples = st.samples, set()   # the window's samples stay
            self.episode(self.offsets[0])
            st.on_frame, st.tracing, st.samples = None, False, kept
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
        events = tr.export_events(prof)
        summary = tr.summarize(events, (RENDER, STEP))
        span_us, scatter = span_readings(events)
        counts = _delta(mark["c1"], mark["c0"])
        print(f"port_bench: traced frames {a}-{a + n_act - 1}: counters "
              f"{counts}; device ms a frame "
              + ", ".join(f"{k}: {v * 1e-3 / n_act:.3f}"
                          for k, v in span_us.items())
              + f", scatter: {scatter * 1e-3 / n_act:.3f}; "
              f"{summary['n_device']} device records; launches inside "
              + ", ".join(f"{n}: {len(ids)} in {k} ranges" for n, (ids, k)
                          in summary["ranges"].items()), file=sys.stderr)
        return dict(summary=summary, window_s=mark["t1"] - mark["t0"],
                    frames=n_act, counters=counts, span_us=span_us,
                    scatter_us=scatter, render=RENDER, step=STEP,
                    stretch=[(self.offsets[0], k)
                             for k in range(a, a + n_act)])

    def release(self):
        """Drop the program's loop and render graph before the reference
        runs (the scene's tensors stay: the reference reads them)."""
        from gaussianrpg_tpu_torch.ops import raster_graph

        self.loop = self.perceive = None
        raster_graph.release()

    # -- the reference --------------------------------------------------
    def _replay(self, offset, boxes_at) -> "street.aeb.Episode":
        """The reference's episode from one start on `boxes_at(k, pos)`."""
        wl, sc = self.wl, self.cfg["scene"]
        sim = self.cfg["config"]["sim"]
        poses = si.camera_poses(self.cfg, wl, offset)
        positions = [np.float32(np.linalg.inv(c2w)[:3, 3]).astype(np.float64)
                     for c2w, _, _ in poses]
        times = [float(np.float32(t)) for _, _, t in poses]
        lead = next(v for v in self.cfg["vehicles"] if v["role"] == "lead")

        def gap_at(k, pos):
            t = poses[min(k, len(poses) - 1)][2]
            return si.vehicle_track(lead, wl, t)[0] + pos[2]

        c2v = si.cam_to_vehicle(sc["ground"]["y"])
        return street.replay(
            boxes_at, positions=positions, times=times, rate=self.rate,
            dynamics_hz=sim["dynamic_freq"], episode_s=wl["episode_s"],
            gap_at=gap_at, brake_distance=sim["brake_distance"],
            collision_m=sim["collision_threshold"],
            K=si.intrinsics(sc).astype(np.float64), v2c=np.linalg.inv(c2v),
            hw=(sc["height"], sc["width"]), cam_height=wl["cam_height_m"])

    def replay(self, offset) -> "street.aeb.Episode":
        """The reference's episode from one start on the candidates the
        program produced for each frame of that start's last episode."""
        cands = self.last[offset][1]
        sc, yc = self.cfg["scene"], self.cfg["yolo"]
        hw = (sc["height"], sc["width"])

        def boxes_at(k, pos):
            if k >= len(cands):
                return []
            return perceived.boxes(cands[k], yc, self.gain, self.pad, hw)

        return self._replay(offset, boxes_at)

    def reference_outputs(self, form: street.Form = street.Form(),
                          tf32: bool = False,
                          dtype: torch.dtype | None = None) -> dict:
        """The reference's images, predictions and candidates of the
        sampled frames of the window's last episode, at the camera poses
        of its replay; `form`, `tf32` and `dtype` give a control's."""
        off = self.episodes[-1][0]
        frames = self.replays()[off].frames
        meta = self.meta()
        images = {}
        with torch.no_grad():
            for k in self.samples:
                if k < len(frames):
                    v = self.view(off, k, frames[k].position)
                    images[k] = street.frame(self.scene, v, meta, form)
        return dict(images=images, **self.reference_perception(
            images, tf32=tf32, dtype=dtype))

    def reference_perception(self, images: dict, tf32: bool = False,
                             dtype: torch.dtype | None = None) -> dict:
        """The reference's YOLOv5s predictions and top-K candidates of
        `images`."""
        preds, cands = {}, {}
        for k, img in images.items():
            preds[k], cands[k] = perceived.perceive(
                self.lays, self.weights, img, self.cfg["yolo"], tf32=tf32,
                dtype=dtype)
        return dict(preds=preds, cands=cands)

    def program_outputs(self) -> dict:
        cands = self.last[self.episodes[-1][0]][1]
        return dict(images=self.st.images,
                    cands={k: cands[k] for k in self.samples
                           if k < len(cands)})

    def numbers(self, out: dict, ref: dict) -> dict:
        """The compared numbers of `out` (the program's outputs, or a
        control's) against the reference."""
        nums = compare.image_gaps(out["images"], ref["images"])
        nums.update(compare.candidate_gaps(out["cands"], ref["cands"],
                                           ref["preds"],
                                           self.cfg["yolo"]["classes"]))
        return nums


Cell = StreetYoloLoop
