"""Fused inline perception: render -> letterbox -> YOLOv5 -> top-K
prefilter on the card, with one copy to the host a frame.

Counterpart of `gaussianrpg_tpu/sim/pipeline.py`. The frame never leaves
the device: the letterbox is an antialiased bilinear resize and a pad, YOLO
is the graph of sim/yolo.py, and a top-K confidence prefilter shrinks what
the host reads from the full [A, 5 + nc] prediction (~5 MB at 384x640) to
[K, 6] candidates (~6 KB). That copy is the frame's one sync; the host then
runs greedy NMS over <= K boxes and the AEB/dynamics arithmetic. The loop
is sequential (this frame's brake moves the next frame's camera), so its
rate is 1 / (device time + the copy's round trip).

`FusedPerception` is the loop's perceive_fn on such a step
(`apps.simulate.loop_setup`): the host tail, and a frame rendered again
at a grown pair capacity when its render overflowed (counter `regrows`,
span `pipeline.regrow`).
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from ..utils.spans import span
from .detector import normalized_boxes
from .yolo import (COCO_VEHICLE_PERSON, forward as yolo_forward,
                   letterbox_geometry, letterbox_tensor, nms_boxes,
                   scale_coords, xywh_to_xyxy)

# frames whose device step ran again because the render's pair capacity
# overflowed (`FusedPerception`)
regrows = 0


def letterbox_device(img_chw: torch.Tensor, out_hw: tuple[int, int],
                     color: float = 0.447):
    """[3, H, W] on any device -> ([nh, nw, 3], gain, (px, py)) on the
    same device: the frame clamped to [0, 1], as the JAX pipeline clamps
    it, then yolo.letterbox_tensor. gain and pad are python numbers for
    the host-side scale_coords."""
    return letterbox_tensor(img_chw.clamp(0.0, 1.0), out_hw, color)


def topk_candidates(pred: torch.Tensor, k: int,
                    classes: Sequence[int] | None = COCO_VEHICLE_PERSON):
    """Device prefilter: pred [A, 5+nc] -> [K, 6] (xywh, conf, cls) by
    descending obj*cls confidence.

    The class semantics are the unfused path's (yolo.non_max_suppression):
    argmax and max over ALL classes first, then a box whose best class is
    outside `classes` gets conf 0 (the host threshold drops it). A max over
    the selected classes only would keep a box whose best class is, say,
    'traffic light' but whose car score clears the threshold: a box the
    unfused detector rejects. Ties (the conf-0 rows) may come out in
    another order than `jax.lax.top_k` gives them. `classes` may be a
    tensor of class ids on pred's device; a sequence is copied there,
    which waits for the stream."""
    conf_all = pred[:, 5:] * pred[:, 4:5]
    cls = torch.argmax(conf_all, dim=1)
    conf = conf_all.amax(dim=1)
    if classes is not None:
        allowed = torch.isin(cls, torch.as_tensor(
            classes, dtype=cls.dtype, device=cls.device))
        conf = torch.where(allowed, conf, torch.zeros_like(conf))
    top_conf, top_i = torch.topk(conf, k)
    return torch.cat([pred[top_i, :4], top_conf[:, None],
                      cls[top_i, None].to(pred.dtype)], dim=1)


class FusedStep:
    """One inline-perception frame. `device_step(camera, *scene_args)`
    renders, letterboxes, predicts and takes the top K on the device,
    returning the [K, 6] candidates there; calling the step does the same
    and copies them to the host (numpy), the frame's one sync. Under a
    profiler the stages record the spans `pipeline.render`,
    `pipeline.letterbox`, `pipeline.yolo`, `pipeline.topk` and, around
    the copy and the host's wait for it, `pipeline.fetch`."""

    def __init__(self, render_rgb, spec, params, size, k, classes,
                 predict_fn):
        self.render_rgb = render_rgb
        self.spec = spec
        self.params = params
        self.size = size
        self.k = k
        self.classes = classes
        self.predict_fn = predict_fn

    @torch.no_grad()
    def device_step(self, camera, *scene_args) -> torch.Tensor:
        with span("pipeline.render"):
            img = self.render_rgb(camera, *scene_args)
        with span("pipeline.letterbox"):
            boxed, _, _ = letterbox_device(img, self.size)
        with span("pipeline.yolo"):
            pred = self.predict_fn(self.spec, self.params, boxed[None])[0]
        with span("pipeline.topk"):
            if self.classes is not None \
                    and not torch.is_tensor(self.classes):
                # once: the copy to the card waits for the stream
                self.classes = torch.tensor(list(self.classes),
                                            device=pred.device)
            return topk_candidates(pred, self.k, self.classes)

    def __call__(self, camera, *scene_args) -> np.ndarray:
        cand = self.device_step(camera, *scene_args)
        with span("pipeline.fetch"):
            return cand.cpu().numpy()


def make_fused_step(render_rgb: Callable[..., torch.Tensor], spec, params,
                    image_hw: tuple[int, int], size: tuple[int, int] =
                    (384, 640), k: int = 256,
                    classes: Sequence[int] | None = COCO_VEHICLE_PERSON,
                    predict_fn: Callable[..., torch.Tensor] | None = None):
    """(step, gain, pad): step(camera, *scene_args) -> [K, 6] host
    candidates (see FusedStep). `render_rgb(camera, *scene_args)` returns
    a [3, H, W] image on the device of `params`.

    `predict_fn(spec, params, imgs [B, h, w, 3]) -> [B, A, 5+nc]` defaults
    to the YOLOv5 graph (sim/yolo.forward). A deterministic predictor may
    stand in at the same contract point: everything downstream (top-K
    prefilter, host NMS, unletterbox) is the production path either way,
    which is how a braking event is driven through the fused pipeline
    without YOLO weights."""
    gain, _, pad = letterbox_geometry(image_hw, size)
    step = FusedStep(render_rgb, spec, params, size, k, classes,
                     predict_fn or yolo_forward)
    return step, gain, pad


def finish_detections(cand: np.ndarray, gain: float, pad: tuple,
                      orig_hw: tuple, conf_thres: float = 0.25,
                      iou_thres: float = 0.45,
                      max_det: int = 300) -> np.ndarray:
    """Host tail: [K, 6] candidates -> [M, 6] (xyxy in original image
    pixels, conf, cls) after threshold + NMS + unletterbox (the span
    `pipeline.nms`)."""
    with span("pipeline.nms"):
        cand = np.asarray(cand)
        cand = cand[cand[:, 4] > conf_thres]
        if cand.shape[0] == 0:
            return np.zeros((0, 6), np.float32)
        det = nms_boxes(xywh_to_xyxy(cand), cand[:, 4], cand[:, 5],
                        iou_thres, max_det)
        if det.shape[0]:
            det[:, :4] = scale_coords(det[:, :4], gain, pad, orig_hw)
        return det


class FusedPerception:
    """The closed loop's `perceive_fn` on a fused step whose render can
    overflow its pair capacity: camera -> normalized (cx, cy, w, h) boxes
    after the host tail (`finish_detections`, `normalized_boxes`).

    Perception never reads a render whose pairs overflowed. Once the
    frame's candidates are on the host (the stream is then idle),
    `overflowed()` reads the render's flag, one small copy; while it is
    set, `grow()` enlarges the render's capacity and the frame's device
    step runs again inside the span `pipeline.regrow`, each time counted
    in `regrows`. `candidates` holds the last frame's [K, 6] host
    candidates, those the boxes came from."""

    def __init__(self, step, gain, pad, image_hw, overflowed, grow):
        self.step = step
        self.gain, self.pad = gain, pad
        self.image_hw = image_hw
        self.overflowed, self.grow = overflowed, grow
        self.candidates = None

    def __call__(self, camera) -> list:
        global regrows
        cand = self.step(camera)
        while self.overflowed():
            self.grow()
            regrows += 1
            with span("pipeline.regrow"):
                cand = self.step(camera)
        self.candidates = cand
        det = finish_detections(cand, self.gain, self.pad, self.image_hw)
        return normalized_boxes(det, *self.image_hw)
