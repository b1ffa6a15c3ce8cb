"""Headless closed-loop simulator: tape -> render -> perception -> AEB ->
car dynamics, at 50 Hz dynamics / 10 Hz imaging.

Counterpart of `gaussianrpg_tpu/sim/loop.py`: the render_fn + detector
path, and the fused path where one `perceive_fn` renders and detects
(sim/pipeline.py).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np

from ..render.camera import Camera, make_camera
from ..utils.spans import span
from .nodes import (AebController, CarDynamics, Evaluation, GroundPlaneRanger,
                    GroundTruth)


@dataclass
class LoopResult:
    verdict: str
    ticks: int
    frames_rendered: int
    min_gt_distance: float
    wall_time: float
    fps: float
    log: List[dict] = field(default_factory=list)
    frame_seconds: List[float] = field(default_factory=list)


def run_closed_loop(
    tape: dict,
    render_fn: Optional[Callable[[Camera], np.ndarray]],
    detector,
    camera_template: Camera,
    gt_tracklets: dict,
    *,
    start_frame: int = 0,
    brake_distance: float = 15.0,
    collision_threshold: float = 5.5,
    simulation_time: float = 15.0,
    cam_height: float = 2.115,
    ranger_extrinsic: np.ndarray | None = None,
    max_ticks: int | None = None,
    perceive_fn: Optional[Callable[[Camera], List[np.ndarray]]] = None,
) -> LoopResult:
    """Run the loop until a verdict or max_ticks. render_fn: Camera ->
    [3, H, W] host image (it must finish the frame before returning, so
    `frame_seconds` holds whole-frame host times); detector:
    sim.detector's protocol.

    perceive_fn (optional): Camera -> normalized (cx, cy, w, h) boxes,
    replacing render_fn + detector.detect: the fused inline-perception
    path (sim/pipeline.py). render_fn and detector may then be None, and
    `frame_seconds` times perceive_fn (render, perception and the copy of
    the candidates to the host).

    Under a profiler each frame records the spans `loop.tick` (each of
    its dynamics ticks), `loop.camera`, `loop.perceive` (perceive_fn, or
    render_fn and the detector), `loop.range` and `loop.aeb`
    (utils/spans.py)."""
    dyn = CarDynamics(tape=tape)
    images = ImageTicks(tape, camera_template)
    aeb = AebController(brake_distance=brake_distance)
    gt = GroundTruth(tape=tape, tracklets=gt_tracklets,
                     start_frame=start_frame, sync_iter_times=images.sync)
    ev = Evaluation(simulation_time=simulation_time,
                    collision_threshold=collision_threshold,
                    start_time=tape["frames"][0]["timestamp"])
    ext = (ranger_extrinsic if ranger_extrinsic is not None
           else np.linalg.inv(camera_template.extrinsic.cpu().numpy()))
    ranger = GroundPlaneRanger(
        K=camera_template.K.cpu().numpy(), extrinsic=np.asarray(ext),
        width=camera_template.width, height=camera_template.height,
        cam_height=cam_height)

    ticks = 0
    min_gt = float("inf")
    log, frame_seconds = [], []
    t_wall0 = time.time()
    max_ticks = max_ticks or int(
        (simulation_time + 2.0) * tape.get("dynamic_freq", 50))

    while ev.verdict is None and ticks < max_ticks:
        with span("loop.tick"):
            pose = dyn.tick()
            idx = dyn.idx - 1
            cam_z = pose["position"][2]
            aeb.on_pose(cam_z, dyn.timestamp)
            d = gt.distance(idx, cam_z)
            if d is not None:
                min_gt = min(min_gt, d)
                ev.on_distance(d, dyn.timestamp)

        cam = None if ev.verdict is not None else images.camera(
            idx, pose, dyn.timestamp)
        if cam is not None:
            with span("loop.perceive"):
                t0 = time.perf_counter()
                if perceive_fn is not None:
                    bboxes = perceive_fn(cam)
                    frame_seconds.append(time.perf_counter() - t0)
                else:
                    img = np.asarray(render_fn(cam))
                    frame_seconds.append(time.perf_counter() - t0)
                    bboxes = detector.detect(img, cam)
            with span("loop.range"):
                objects = [ranger.distance(b) for b in bboxes]
                objects = [(rng_, lat) for rng_, lat in objects if rng_ > 0]
            with span("loop.aeb"):
                brake = aeb.on_objects(objects)
                dyn.on_control(brake)
                log.append(dict(tick=idx, t=dyn.timestamp, gt_dist=d,
                                n_det=len(bboxes), brake=brake,
                                velocity=dyn.forward_velocity))
        ticks += 1

    render_time = sum(frame_seconds)
    return LoopResult(
        verdict=ev.verdict or "timeout",
        ticks=ticks,
        frames_rendered=len(frame_seconds),
        min_gt_distance=min_gt,
        wall_time=time.time() - t_wall0,
        fps=len(frame_seconds) / max(render_time, 1e-9),
        log=log,
        frame_seconds=frame_seconds,
    )


class ImageTicks:
    """The imaging schedule of a tape: every `sync`-th dynamics tick
    (dynamic_freq / image_freq, 50 / 10 Hz) shows an image, of the
    scene's image frame `frame0 + idx // sync`, `frame0` being the
    template's (read once: it is a tensor on the template's device)."""

    def __init__(self, tape: dict, template: Camera):
        self.sync = int(round(tape.get("dynamic_freq", 50)
                              / tape.get("image_freq", 10)))
        self.template = template
        self.frame0 = int(template.frame)

    def camera(self, idx: int, pose: dict,
               timestamp: float) -> Camera | None:
        """The camera to render at dynamics tick `idx` (its tape pose and
        timestamp), or None on a tick without an image. Under a profiler
        it records the span `loop.camera`."""
        if idx % self.sync:
            return None
        with span("loop.camera"):
            return _camera_from_pose(self.template, pose,
                                     self.frame0 + idx // self.sync,
                                     timestamp)


def _camera_from_pose(template: Camera, pose: dict, frame: int,
                      timestamp: float) -> Camera:
    """The template camera rebuilt at a tape pose (same K/resolution, tape
    R/T, tape ego pose moving the other actors). `frame` is the scene's
    image frame the tick shows, the template's frame plus the image
    periods since the tape's start (`frame0 + idx // sync_iters`): the
    actors' Fourier colour term runs on image frames
    (`models/scene_graph.compose`), not on the tape's dynamics ticks."""
    return make_camera(
        R=np.asarray(pose["rotation_matrix"]),
        T=np.asarray(pose["position"]),
        K=template.K.cpu().numpy(), width=template.width,
        height=template.height,
        ego_pose=np.asarray(pose["ego_pose"], np.float32),
        extrinsic=template.extrinsic.cpu().numpy(),
        timestamp=float(timestamp), frame=frame,
        image_id=int(template.image_id), cam_id=template.cam_id,
        meta=template.meta, device=template.device,
    )
