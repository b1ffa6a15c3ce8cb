"""Perception for the closed loop: detectors that emit YOLO-style
normalized (cx, cy, w, h) boxes; ranging stays in sim/nodes.py.

Counterpart of `gaussianrpg_tpu/sim/detector.py`:
  * BoxProjectionDetector projects the tracked actors' 3D boxes into the
    camera (ground-truth geometry, optional noise);
  * YoloDetector runs the YOLOv5 graph of sim/yolo.py (the JAX package's
    `JaxYoloDetector`), randomly initialized or from a checkpoint;
  * TorchHubYoloDetector runs the model of an external YOLOv5 checkout
    (its `attempt_load`, letterbox, NMS and `scale_coords`) on its weights.
All satisfy the `Detector` protocol the loop is written against.
"""
from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import List, Optional, Protocol, runtime_checkable

import numpy as np
import torch

from ..models.actor_pose import object_poses
from ..ops.math3d import quaternion_to_matrix
from ..utils.device import resolve_device
from ..utils.spans import span


@runtime_checkable
class Detector(Protocol):
    def detect(self, image_chw: np.ndarray, camera) -> List[np.ndarray]:
        """image [3, H, W] in [0, 1] -> list of (cx, cy, w, h) normalized
        boxes of detected vehicles and pedestrians."""
        ...


@dataclass
class BoxProjectionDetector:
    arrays: "object"          # SceneArrays
    actor_pose: "object"      # ActorPose
    noise_px: float = 0.0
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)

    def detect(self, image_chw, camera) -> List[np.ndarray]:
        """The boxes of the alive actors' projected 3D boxes (span
        `detector.boxes` under a profiler)."""
        with span("detector.boxes"):
            return self._detect(camera)

    def _detect(self, camera) -> List[np.ndarray]:
        H, W = camera.height, camera.width
        ts = float(camera.timestamp)
        with torch.no_grad():
            trans, quats = object_poses(self.actor_pose, ts)
            rmats = quaternion_to_matrix(quats).cpu().numpy()
        trans = trans.cpu().numpy()
        ego = camera.ego_pose.cpu().numpy()
        V = camera.viewmatrix.cpu().numpy()
        K = camera.K.cpu().numpy()
        bbox_dims = self.arrays.actor_bbox.cpu().numpy()
        starts = self.arrays.actor_start_ts.cpu().numpy()
        ends = self.arrays.actor_end_ts.cpu().numpy()
        bboxes = []
        for o in range(trans.shape[0]):
            if not (starts[o] <= ts <= ends[o]):
                continue
            t_w = ego[:3, :3] @ trans[o] + ego[:3, 3]
            r_w = ego[:3, :3] @ rmats[o]
            l, w, h = bbox_dims[o]
            corners = np.array(
                [[sx * l / 2, sy * w / 2, sz * h / 2]
                 for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)])
            pts_c = (corners @ r_w.T + t_w) @ V[:3, :3].T + V[:3, 3]
            if np.all(pts_c[:, 2] <= 0.2):
                continue
            pts_c = pts_c[pts_c[:, 2] > 0.2]
            uv = pts_c @ K.T
            uv = uv[:, :2] / uv[:, 2:3]
            u0, v0 = uv.min(axis=0)
            u1, v1 = uv.max(axis=0)
            u0, u1 = np.clip([u0, u1], 0, W)
            v0, v1 = np.clip([v0, v1], 0, H)
            if (u1 - u0) < 4 or (v1 - v0) < 4:
                continue
            if self.noise_px > 0:
                jitter = self._rng.normal(0, self.noise_px, 4)
                u0, v0, u1, v1 = (u0 + jitter[0], v0 + jitter[1],
                                  u1 + jitter[2], v1 + jitter[3])
            bboxes.append(np.array([
                (u0 + u1) / 2 / W, (v0 + v1) / 2 / H,
                (u1 - u0) / W, (v1 - v0) / H]))
        return bboxes


VEHICLE_CLASSES = (0, 1, 2, 3, 5, 7)  # COCO person, bicycle, car, ..., truck

# the top-level packages of a YOLOv5 checkout that TorchHubYoloDetector
# imports; it owns these names in sys.modules
CHECKOUT_PACKAGES = ("models", "utils")


@dataclass
class TorchHubYoloDetector:
    """YOLOv5 through a local checkout of its repository at `repo_path`
    (`models.experimental.attempt_load`, `utils.augmentations.letterbox`,
    `utils.general.non_max_suppression` / `scale_coords`) with the weights
    at `weights_path`, on `device` (CUDA unless given). Counterpart of the
    JAX package's `TorchHubYoloDetector` (`gaussianrpg_tpu/sim/detector.py:
    103-152`): the same letterbox, NMS, `scale_coords` and class filter.

    It owns the names `models` and `utils` (and their submodules) in
    `sys.modules`: on the first `detect` it drops whatever held them, puts
    `repo_path` first on `sys.path` while it imports the checkout, then
    restores `sys.path`. The checkout's modules stay loaded (the model's
    pickled classes live there); nothing else is left changed."""

    repo_path: str
    weights_path: str
    img_size: int = 640
    conf_thres: float = 0.25
    iou_thres: float = 0.45
    device: Optional[str] = None
    _model: Optional[object] = None
    _fns: Optional[tuple] = None
    _dev: Optional[torch.device] = None

    def _ensure(self):
        if self._model is not None:
            return
        dev = resolve_device(self.device)
        for name in [n for n in sys.modules
                     if n.split(".")[0] in CHECKOUT_PACKAGES]:
            del sys.modules[name]
        saved = list(sys.path)
        sys.path.insert(0, self.repo_path)
        try:
            from models.experimental import attempt_load
            from utils.augmentations import letterbox
            from utils.general import non_max_suppression, scale_coords
            model = attempt_load(self.weights_path, map_location=dev)
        finally:
            sys.path[:] = saved
        self._fns = (letterbox, non_max_suppression, scale_coords)
        self._model = model.to(dev).eval()
        self._dev = dev

    def detect(self, image_chw, camera) -> List[np.ndarray]:
        self._ensure()
        letterbox, non_max_suppression, scale_coords = self._fns
        H, W = image_chw.shape[1:]
        img = (np.clip(image_chw, 0, 1) * 255).astype(np.uint8)
        img = img.transpose(1, 2, 0)
        lb = letterbox(img, self.img_size, stride=32, auto=False)[0]
        x = torch.from_numpy(lb.transpose(2, 0, 1)[None].copy()).to(
            self._dev).float() / 255.0
        with torch.no_grad():
            pred = self._model(x)[0]
        det = non_max_suppression(pred, self.conf_thres, self.iou_thres)[0]
        if det is None or not len(det):
            return []
        det[:, :4] = scale_coords(x.shape[2:], det[:, :4], (H, W, 3)).round()
        return normalized_boxes([row for row in det.tolist()
                                 if int(row[5]) in VEHICLE_CLASSES], H, W)


@dataclass
class YoloDetector:
    """YOLOv5 perception (sim/yolo.py) on `device` (CUDA unless given),
    from `weights_path` (a YOLOv5 checkpoint) or randomly initialized.
    `detect` records the span `detector.yolo` under a profiler."""

    weights_path: Optional[str] = None
    size: tuple = (384, 640)
    conf_thres: float = 0.25
    iou_thres: float = 0.45
    device: Optional[str] = None
    _det: Optional[object] = None

    def _ensure(self):
        if self._det is None:
            from . import yolo
            kw = dict(size=self.size, conf_thres=self.conf_thres,
                      iou_thres=self.iou_thres, classes=VEHICLE_CLASSES,
                      device=self.device)
            self._det = (yolo.YoloDetector.from_checkpoint(
                self.weights_path, **kw) if self.weights_path
                else yolo.YoloDetector(**kw))

    def detect(self, image_chw, camera) -> List[np.ndarray]:
        self._ensure()
        with span("detector.yolo"):
            H, W = image_chw.shape[1:]
            det = self._det(np.clip(image_chw, 0, 1).transpose(1, 2, 0))
            return normalized_boxes(det, H, W)


def normalized_boxes(det: np.ndarray, H: int, W: int) -> List[np.ndarray]:
    """[M, 6] detections (xyxy in image pixels, conf, cls) -> the loop's
    normalized (cx, cy, w, h) boxes."""
    return [np.array([(x0 + x1) / 2 / W, (y0 + y1) / 2 / H,
                      (x1 - x0) / W, (y1 - y0) / H])
            for x0, y0, x1, y1, conf, cls in det]
