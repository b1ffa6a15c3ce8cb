"""YOLOv5s perception of a rendered frame, composed plainly from this
folder's parts, for the cells where YOLOv5s perceives the frame the
reference renders:

- the fused path (`loop_street600k_yolo`, on `street.frame`'s composite):
  `perceive` letterboxes the image on its own device (`yolo.letterbox`),
  runs `yolo.predict` and keeps the top K rows (`yolo.top_candidates`);
  `boxes` keeps what greedy NMS keeps of a frame's candidates above the
  confidence threshold (`aeb.nms`) and maps them into the image
  (`aeb.to_image`): what `aeb.replay` does with a frame's candidates;
- the separate path (`loop_frozen600k_separate`, the ROS2 graph's
  simulator and object-detector nodes): `rgb8_round_trip` is the image
  as the detector node decodes it from the simulator's 8-bit message,
  and `perceive(..., host=True)` letterboxes it on the host, where the
  program's detector letterboxes, before the same YOLOv5s; `detections`
  keeps what NMS keeps of every prediction row, as that detector does.

Departures from the published mathematics (YOLOv5 v6.0 `detect.py`,
`utils/augmentations.letterbox`, `utils/general.non_max_suppression`):
- the letterbox resizes the float image by antialiased bilinear
  resampling to a fixed 384 x 640 and pads with 0.447, where the
  published one resizes the 8-bit image with OpenCV's bilinear
  interpolation (no antialiasing) and pads to the next multiple of the
  stride with 114 / 255;
- the fused path keeps the top K rows before NMS (the published NMS takes
  up to 30,000 rows above the threshold);
- NMS is greedy in float32 numpy, classes kept apart by shifting their
  boxes by 7680 (the published: torchvision's `batched_nms`, offsets of
  4096); the class is the best of all 80, and a row whose best class is
  not kept is dropped (the published `classes=` filter does the same);
- the weights are drawn from the seed and folded (no batch norm), the
  Detect head calibrated (`inputs.calibrate_detect`).

Plain PyTorch and numpy, TF32 off unless `tf32` asks for it (a control);
nothing here knows the port.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from . import aeb, yolo


@contextlib.contextmanager
def precision(tf32: bool):
    """Matmuls and cuDNN convolutions with TF32 on or off."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def perceive(lays, weights, image: torch.Tensor, yc: dict,
             host: bool = False, tf32: bool = False,
             dtype: torch.dtype | None = None):
    """(predictions [A, 5 + nc], top-K candidates [K, 6]) of a [3, H, W]
    image. The letterbox runs on the image's device, or on the host with
    `host`; YOLOv5 on the weights' device, in `dtype` (weights and
    activations; a control) when given."""
    dev = weights[0][0].device
    src = image.cpu() if host else image
    with torch.no_grad(), precision(tf32):
        boxed, _, _ = yolo.letterbox(src, tuple(yc["input_hw"]))
        boxed = boxed.to(dev)
        if dtype is not None:
            weights = [(w.to(dtype), b.to(dtype)) for w, b in weights]
            boxed = boxed.to(dtype)
        pred = yolo.predict(lays, weights, boxed,
                            yc["num_classes"]).float()
        cand = yolo.top_candidates(pred, yc["top_k"], yc["classes"])
    return pred, cand


def boxes(cand: np.ndarray, yc: dict, gain: float, pad: tuple,
          hw: tuple) -> list:
    """Normalised (cx, cy, w, h) boxes NMS keeps of one frame's [K, 6]
    candidates (letterboxed pixels), in the rendered image."""
    det = aeb.nms(cand, yc["conf_thres"], yc["iou_thres"])
    return aeb.to_image(det, gain, pad, hw)


def detections(pred: torch.Tensor, yc: dict, gain: float, pad: tuple,
               hw: tuple) -> list:
    """The boxes NMS keeps of every prediction row of a frame (no top-K),
    as the separate path's detector keeps them."""
    rows = yolo.top_candidates(pred, pred.shape[0], yc["classes"])
    return boxes(rows.cpu().numpy(), yc, gain, pad, hw)


def rgb8_round_trip(image: torch.Tensor) -> torch.Tensor:
    """[3, H, W] float in [0, 1] -> the same image after the ROS2 hand-off:
    clamped, scaled by 255 and truncated to 8 bits, then divided by 255
    (in double, as numpy divides) and stored as float32."""
    u8 = (image.float().clamp(0.0, 1.0) * 255).to(torch.uint8)
    return (u8.double() / 255.0).float()
