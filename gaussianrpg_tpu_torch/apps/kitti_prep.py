"""KITTI-STEP annotation prep (reference `script/kitti/`):

  * dynamic masks  — white where NOT a movable class (person..bicycle),
    matching `generate_dynamic_mask.py:56-89` (label ids 11-18 masked)
  * semantic color maps — label id -> cityscapes-style RGB
    (`generate_semantic_mask.py:13-62`, vectorized; the reference loops
    pixels and, notably, never writes the result — this one does)
  * sky masks — KITTI-STEP label 10 is 'sky', so the mask is exact
    (the reference reuses the GroundingDINO+SAM waymo path instead)

KITTI-STEP encodes the semantic label in the R channel of the annotation
PNG. Usage:
    python -m gaussianrpg_tpu_torch.apps.kitti_prep dynamic|semantic|sky \
        --annotation-path A --output-path B

Counterpart of `gaussianrpg_tpu/apps/kitti_prep.py`: the annotations are
read and the masks written through `data/image_io` (no Pillow); the
pixels equal the JAX app's.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from ..data.image_io import read_image, write_png

# KITTI-STEP label table (`generate_dynamic_mask.py:12-33`)
MOVABLE_LABELS = np.array([11, 12, 13, 14, 15, 16, 17, 18], np.uint8)
SKY_LABEL = 10

SEMANTIC_COLORMAP = np.zeros((256, 3), np.uint8)
for _i, _c in {
    0: (128, 64, 128), 1: (244, 35, 232), 2: (70, 70, 70),
    3: (102, 102, 156), 4: (190, 153, 153), 5: (153, 153, 153),
    6: (250, 170, 30), 7: (220, 220, 0), 8: (107, 142, 35),
    9: (152, 251, 152), 10: (70, 130, 180), 11: (220, 20, 60),
    12: (255, 0, 0), 13: (0, 0, 142), 14: (0, 0, 70),
    15: (0, 60, 100), 16: (0, 80, 100), 17: (0, 0, 230),
    18: (119, 11, 32), 255: (0, 0, 0),
}.items():
    SEMANTIC_COLORMAP[_i] = _c


def _iter_annotations(annotation_path: str):
    for root, _, files in os.walk(annotation_path):
        for f in sorted(files):
            if f.endswith(".png"):
                full = os.path.join(root, f)
                yield full, os.path.relpath(full, annotation_path)


def _labels(path: str) -> np.ndarray:
    img = read_image(path)
    return img[..., 0] if img.ndim == 3 else img


def _save(out_path: str, arr: np.ndarray):
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    write_png(out_path, arr)


def generate_dynamic_masks(annotation_path: str, output_path: str,
                           log=print) -> int:
    n = 0
    for full, rel in _iter_annotations(annotation_path):
        label = _labels(full)
        static = ~np.isin(label, MOVABLE_LABELS)
        _save(os.path.join(output_path, rel),
              (static * 255).astype(np.uint8))
        n += 1
        log(rel)
    return n


def generate_semantic_maps(annotation_path: str, output_path: str,
                           log=print) -> int:
    n = 0
    for full, rel in _iter_annotations(annotation_path):
        label = _labels(full)
        _save(os.path.join(output_path, rel), SEMANTIC_COLORMAP[label])
        n += 1
        log(rel)
    return n


def generate_sky_masks(annotation_path: str, output_path: str,
                       log=print) -> int:
    n = 0
    for full, rel in _iter_annotations(annotation_path):
        label = _labels(full)
        _save(os.path.join(output_path, rel),
              ((label == SKY_LABEL) * 255).astype(np.uint8))
        n += 1
        log(rel)
    return n


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("mode", choices=["dynamic", "semantic", "sky"])
    p.add_argument("--annotation-path", required=True)
    p.add_argument("--output-path", required=True)
    args = p.parse_args(argv)
    fn = {"dynamic": generate_dynamic_masks,
          "semantic": generate_semantic_maps,
          "sky": generate_sky_masks}[args.mode]
    n = fn(args.annotation_path, args.output_path)
    print(f"wrote {n} masks")


if __name__ == "__main__":
    main()
