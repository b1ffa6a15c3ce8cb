"""Perception for the closed loop: detectors that emit YOLO-style
normalized (cx, cy, w, h) boxes; ranging stays in sim/nodes.py.

Counterpart of `gaussianrpg_tpu/sim/detector.py`:
  * BoxProjectionDetector projects the tracked actors' 3D boxes into the
    camera (ground-truth geometry, optional noise);
  * YoloDetector runs the YOLOv5 graph of sim/yolo.py (the JAX package's
    `JaxYoloDetector`), randomly initialized or from a checkpoint.
Both satisfy the `Detector` protocol the loop is written against. The JAX
package's `TorchHubYoloDetector` needs an external YOLOv5 checkout and
weights and has no counterpart here.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Protocol, runtime_checkable

import numpy as np
import torch

from ..models.actor_pose import object_poses
from ..ops.math3d import quaternion_to_matrix


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


@dataclass
class YoloDetector:
    """YOLOv5 perception (sim/yolo.py) on `device` (CUDA unless given),
    from `weights_path` (a YOLOv5 checkpoint) or randomly initialized."""

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
        H, W = image_chw.shape[1:]
        det = self._det(np.clip(image_chw, 0, 1).transpose(1, 2, 0))
        return normalized_boxes(det, H, W)


def normalized_boxes(det: np.ndarray, H: int, W: int) -> List[np.ndarray]:
    """[M, 6] detections (xyxy in image pixels, conf, cls) -> the loop's
    normalized (cx, cy, w, h) boxes."""
    return [np.array([(x0 + x1) / 2 / W, (y0 + y1) / 2 / H,
                      (x1 - x0) / W, (y1 - y0) / H])
            for x0, y0, x1, y1, conf, cls in det]
