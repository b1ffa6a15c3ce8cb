"""The street cell: the port's AEB simulator (`sim.loop.run_closed_loop`)
on the Street Gaussians composite scene, through the same set-up as
`apps.simulate` (`apps.simulate.loop_setup`: the capacity probe,
`render_scene` under `render_until_fit` with the image copied to the
host, the box-projection detector, the ranging extrinsic), episode after
episode.

The workload file gives the ego's speed, the lead's gap and speed, the
episode length, the ego's lateral starts (one episode each), the
ranger's camera height, the number of compared frames and the traced
stretch; the configuration gives the scene and the published keys
(`config`: render, sim). A run:

1. draws the scene on the device from the seed (`street_inputs.draw`),
   the order of the lateral starts, the compared frames and the traced
   stretch, builds each start's cameras and tape, calls `loop_setup`
   with every start's cameras (the probe samples four) and runs one
   whole episode as warm-up (set-up ends at the window's first frame);
2. runs whole cycles of the episodes until `seconds` are within half a
   cycle: `loop_frame_ms` is the window over the frames rendered in it,
   `loop_frame_p95_ms` the 95th percentile of the times from one
   frame's start to the next's;
3. with `trace`, one more episode of the first start in which a stretch
   of frames drawn from the seed is profiled: the program's spans
   (`scene.compose`, `scene.rasterize`, `scene.sky`, `scene.fetch`,
   `detector.boxes`), the kernel records, and the program's counters
   (`blend.launches`, `scan.launches`, `scan.elements`,
   `scene_graph.compose_counts`, `rasterize.graph_counts`);
4. frees the program's loop and graph, and checks the window against the
   plain reference (`reference/street.py`): every episode's verdict and
   frame count, and for the last episode of each start every frame's
   box count and brake command, as the reference's own replay works them
   out from its own boxes; every box of the window's last episode; the
   composite images of its sampled frames, at the replay's camera poses.
"""
from __future__ import annotations

import contextlib
import math
import sys
import time

import numpy as np
import torch

from .. import compare, inputs, spans as sp, street_inputs as si
from .. import trace as tr
from ..reference import street

SPANS = ("scene.compose", "scene.rasterize", "scene.sky", "scene.fetch",
         "detector.boxes")
SCATTER = "scatter_gather_elementwise"     # binning's scatter_reduce


class _State:
    """What the loop's callbacks share with the harness."""

    def __init__(self, samples):
        self.frame = 0
        self.starts = []
        self.samples = set(samples)
        self.images = {}
        self.boxes = []              # this episode's boxes, by frame
        self.on_frame = None


def _counters() -> dict:
    """The program's counters: kernel B's and A's launches, A's elements,
    the scene graph's compose counts, the render graph's routes."""
    from gaussianrpg_tpu_torch.models import scene_graph
    from gaussianrpg_tpu_torch.ops import blend, rasterize, scan

    return dict(blend=blend.launches, cummax=scan.launches,
                cummax_elements=scan.elements,
                compose=dict(scene_graph.compose_counts),
                graph=dict(rasterize.graph_counts))


def _delta(b: dict, a: dict) -> dict:
    return {k: (_delta(b[k], a[k]) if isinstance(b[k], dict)
                else b[k] - a[k]) for k in b}


class StreetLoop:
    def __init__(self, cfg, wl, seed, device):
        self.cfg, self.wl = cfg, wl
        self.seed, self.dev = seed, torch.device(device)

    # -- set-up ---------------------------------------------------------
    def setup(self):
        from gaussianrpg_tpu_torch.apps.simulate import loop_setup
        from gaussianrpg_tpu_torch.config.config import (DEFAULT_CONFIG,
                                                         CfgNode, merge)
        from gaussianrpg_tpu_torch.sim.tape import build_tape_from_cameras

        cfg, wl, dev = self.cfg, self.wl, self.dev
        sim = cfg["config"]["sim"]
        gen, rng = inputs.generators(self.seed, dev)
        self.scene = si.draw(cfg, wl, gen, dev)
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
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

        pcfg = merge(CfgNode.from_dict(DEFAULT_CONFIG), cfg["config"])
        with contextlib.redirect_stdout(sys.stderr):
            self.loop = loop_setup(models, meta, arrays, cams,
                                   self.tapes[self.offsets[0]], pcfg,
                                   device=dev)
        st = self.st = _State(self.samples)
        render = self.loop["render_fn"]

        def render_fn(cam):
            k = st.frame
            st.frame += 1
            st.starts.append(time.perf_counter())
            if st.on_frame is not None:
                st.on_frame(k)
            img = render(cam)
            if k in st.samples:
                st.images[k] = torch.from_numpy(img)
            return img

        det = self.loop["detector"]
        detect = det.detect

        def recorded_detect(img, cam):
            boxes = detect(img, cam)
            st.boxes.append(boxes)
            return boxes

        det.detect = recorded_detect
        self.render_fn = render_fn
        self.episode(self.offsets[0])     # warm-up: every shape, the graph

    def episode(self, offset):
        from gaussianrpg_tpu_torch.sim.loop import run_closed_loop

        st, wl, lp = self.st, self.wl, self.loop
        sim = self.cfg["config"]["sim"]
        st.frame = 0
        st.boxes = []
        with contextlib.redirect_stdout(sys.stderr):
            return run_closed_loop(
                self.tapes[offset], self.render_fn, lp["detector"],
                lp["camera_template"], self.gt,
                brake_distance=sim["brake_distance"],
                collision_threshold=sim["collision_threshold"],
                simulation_time=wl["episode_s"],
                cam_height=wl["cam_height_m"],
                ranger_extrinsic=lp["ranger_extrinsic"],
                perceive_fn=lp["perceive_fn"])

    # -- the measured window --------------------------------------------
    def window(self, seconds: float) -> dict:
        """Whole cycles of the episodes (one per lateral start) until
        `seconds` are within half a cycle."""
        st = self.st
        st.starts = []
        self.episodes, self.last = [], {}
        c_0 = _counters()
        t0 = time.perf_counter()
        while True:
            c0 = time.perf_counter()
            for off in self.offsets:
                res = self.episode(off)
                self.episodes.append((off, res.verdict, res.frames_rendered,
                                      res.log))
                self.last[off] = (res.log, st.boxes)
            t1 = time.perf_counter()
            if t1 - t0 >= seconds - 0.5 * (t1 - c0):
                break
        self.window_counts = _delta(_counters(), c_0)
        print(f"port_bench: window of {len(st.starts)} frames; render "
              f"graph {self.window_counts['graph']}; compose "
              f"{self.window_counts['compose']}", file=sys.stderr)
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
                    mark["t1"], mark["c1"] = time.perf_counter(), _counters()
                if k >= 1:
                    prof.step()
                if k == a:
                    mark["t0"], mark["c0"] = time.perf_counter(), _counters()

            st.on_frame = on_frame
            kept, st.samples = st.samples, set()   # the window's samples stay
            self.episode(self.offsets[0])
            st.on_frame, st.samples = None, kept
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
        events = tr.export_events(prof)
        summary = tr.summarize(events)
        ids = sp.span_ids(events, SPANS)
        scatter = tr.union_us(
            (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
            for e in events if e.get("cat") in tr.DEVICE_CATS
            and SCATTER in e.get("name", "")
            and tr._corr(e) in ids["scene.rasterize"])
        span_us = sp.span_device_us(events, SPANS)
        counts = _delta(mark["c1"], mark["c0"])
        print(f"port_bench: traced frames {a}-{a + n_act - 1}: counters "
              f"{counts}; device ms a frame "
              + ", ".join(f"{k}: {v * 1e-3 / n_act:.3f}"
                          for k, v in span_us.items())
              + f", scatter: {scatter * 1e-3 / n_act:.3f}; "
              f"{summary['n_device']} device records", file=sys.stderr)
        return dict(summary=summary, window_s=mark["t1"] - mark["t0"],
                    frames=n_act, counters=counts, span_us=span_us,
                    scatter_us=scatter,
                    stretch=[(self.offsets[0], k)
                             for k in range(a, a + n_act)])

    def release(self):
        """Drop the program's loop and render graph before the reference
        runs (the scene's tensors stay: the reference reads them)."""
        from gaussianrpg_tpu_torch.ops import raster_graph

        self.loop = self.render_fn = None
        raster_graph.release()

    # -- the reference --------------------------------------------------
    def meta(self) -> dict:
        sc, c = self.cfg["scene"], self.cfg["config"]
        g = c["model"]["gaussian"]
        return dict(width=sc["width"], height=sc["height"],
                    K=si.intrinsics(sc), tile_x=c["render"]["tile_x"],
                    tile_y=c["render"]["tile_y"], sh_degree=g["sh_degree"],
                    fourier_scale=g["fourier_scale"])

    def view(self, offset, k, position) -> street.View:
        """The reference's view of frame `k` of a start's episode, the
        camera's world->camera translation at `position`."""
        c2w, ego, t = si.camera_poses(self.cfg, self.wl, offset)[k]
        return street.View(R=c2w[:3, :3], T=np.asarray(position, np.float64),
                           ego=ego.astype(np.float32).astype(np.float64),
                           t=float(np.float32(t)),
                           frame=si.frames(self.cfg)[0] + k)

    def replay(self, offset) -> "street.aeb.Episode":
        """The reference's episode from one start, on its own boxes."""
        wl, sc = self.wl, self.cfg["scene"]
        sim = self.cfg["config"]["sim"]
        poses = si.camera_poses(self.cfg, wl, offset)
        # a tape holds each camera's pose and time as float32
        positions = [np.float32(np.linalg.inv(c2w)[:3, 3]).astype(np.float64)
                     for c2w, _, _ in poses]
        times = [float(np.float32(t)) for _, _, t in poses]
        meta = self.meta()
        lead = next(v for v in self.cfg["vehicles"] if v["role"] == "lead")

        def gap_at(k, pos):
            t = poses[min(k, len(poses) - 1)][2]
            return si.vehicle_track(lead, wl, t)[0] + pos[2]

        def boxes_at(k, pos):
            return street.boxes(self.scene, self.view(offset, k, pos), meta)

        c2v = si.cam_to_vehicle(sc["ground"]["y"])
        return street.replay(
            boxes_at, positions=positions, times=times, rate=self.rate,
            dynamics_hz=sim["dynamic_freq"], episode_s=wl["episode_s"],
            gap_at=gap_at, brake_distance=sim["brake_distance"],
            collision_m=sim["collision_threshold"],
            K=meta["K"].astype(np.float64), v2c=np.linalg.inv(c2v),
            hw=(sc["height"], sc["width"]), cam_height=wl["cam_height_m"])

    def replays(self) -> dict:
        if getattr(self, "_replays", None) is None:
            self._replays = {off: self.replay(off) for off in self.last}
        return self._replays

    def reference_outputs(self, form: street.Form = street.Form()) -> dict:
        """The reference's images of the sampled frames and boxes of every
        frame of the window's last episode, at the camera poses of its
        replay; `form` gives a control's."""
        off = self.episodes[-1][0]
        frames = self.replays()[off].frames
        meta = self.meta()
        views = [self.view(off, k, f.position) for k, f in enumerate(frames)]
        with torch.no_grad():
            images = {k: street.frame(self.scene, views[k], meta, form)
                      for k in self.samples if k < len(views)}
            boxes = [street.boxes(self.scene, v, meta, form.field_dtype)
                     for v in views]
        return dict(images=images, boxes=boxes)

    def program_outputs(self) -> dict:
        return dict(images=self.st.images,
                    boxes=self.last[self.episodes[-1][0]][1])

    def numbers(self, out: dict, ref: dict) -> dict:
        """The compared numbers of `out` (the program's outputs, or a
        control's) against the reference."""
        nums = compare.image_gaps(out["images"], ref["images"])
        nums["box_gap_px"] = box_gap(out["boxes"], ref["boxes"],
                                     self.cfg["scene"]["width"],
                                     self.cfg["scene"]["height"])
        return nums

    def decisions(self) -> int:
        """Mismatches of the loop's decisions against the replay: each
        episode's verdict and frame count, and for the last episode of
        each start each frame's box count and brake command (a missing
        or extra frame counts once)."""
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
        brakes = [k for k, e in enumerate(self.episodes[-1][3])
                  if e["brake"] != 0.0]
        print(f"port_bench: {np.mean(dets):.2f} boxes a frame "
              f"({min(dets)}-{max(dets)}); the last episode braked first "
              f"at frame {brakes[0] if brakes else None}; verdicts "
              f"{sorted(set(v for _, v, _, _ in self.episodes))}",
              file=sys.stderr)
        nums = self.numbers(self.program_outputs(), self.reference_outputs())
        nums["decision_mismatches"] = self.decisions()
        frames = sum(n for _, _, n, _ in self.episodes)
        return nums, frames, nums["decision_mismatches"]

    def counts(self, frames) -> list:
        """The reference's blend counts on `frames` ((offset, frame)) of
        the traced episode, which replays the first start."""
        reps, meta = self.replays(), self.meta()
        with torch.no_grad():
            return [street.frame(self.scene,
                                 self.view(o, k, reps[o].frames[k].position),
                                 meta, count=True)[1] for o, k in frames]


def box_gap(program: list, reference: list, width: int,
            height: int) -> float:
    """The widest gap, in pixels, of any box edge measure (cx, cy, w, h)
    over the frames both have; inf where a frame's counts differ."""
    gap = 0.0
    scale = np.array([width, height, width, height], np.float64)
    for p, r in zip(program, reference):
        if len(p) != len(r):
            return math.inf
        if p:
            d = np.abs(np.asarray(p, np.float64) - np.asarray(r)) * scale
            gap = max(gap, float(d.max()))
    return gap


Cell = StreetLoop
