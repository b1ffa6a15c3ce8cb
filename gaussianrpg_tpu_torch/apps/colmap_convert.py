"""Stock COLMAP convert pipeline for generic (non-Waymo) captures.

Equivalent of the reference's `script/convert.py` (the MipNeRF-360-style
shell converter): feature extraction -> exhaustive matching -> mapper ->
image undistortion into ideal pinhole intrinsics, producing the
`sparse/0` + `images/` layout that `data/colmap.py` ingests. Differences
from the reference: subprocess with error propagation instead of
`os.system` string concatenation, and the optional multi-scale resize
uses PIL instead of an external imagemagick binary.

The COLMAP binary is an external dependency (same posture as the
reference and `apps/colmap_triangulate.py`).

Counterpart of `gaussianrpg_tpu/apps/colmap_convert.py`: the same COLMAP
command sequence; the downscales without Pillow (`resize_images`).
"""
from __future__ import annotations

import argparse
import os
import shutil
import subprocess

from ..data.image_io import read_image, resize_lanczos, write_jpeg, \
    write_png


def _run(cmd: list[str]) -> None:
    print("+ " + " ".join(cmd), flush=True)
    subprocess.run(cmd, check=True)


def convert(
    source_path: str,
    colmap_executable: str = "colmap",
    camera: str = "OPENCV",
    use_gpu: bool = True,
    skip_matching: bool = False,
    resize: bool = False,
) -> None:
    """`source_path/input/*.jpg|png` -> COLMAP sparse model + undistorted
    `images/` (reference `script/convert.py:31-88` command sequence)."""
    src = source_path.rstrip("/")
    gpu = "1" if use_gpu else "0"

    if not skip_matching:
        os.makedirs(os.path.join(src, "distorted", "sparse"), exist_ok=True)
        _run([colmap_executable, "feature_extractor",
              "--database_path", os.path.join(src, "distorted", "database.db"),
              "--image_path", os.path.join(src, "input"),
              "--ImageReader.single_camera", "1",
              "--ImageReader.camera_model", camera,
              "--SiftExtraction.use_gpu", gpu])
        _run([colmap_executable, "exhaustive_matcher",
              "--database_path", os.path.join(src, "distorted", "database.db"),
              "--SiftMatching.use_gpu", gpu])
        # tightened BA tolerance, as in the reference (speeds up the
        # global bundle-adjustment steps)
        _run([colmap_executable, "mapper",
              "--database_path", os.path.join(src, "distorted", "database.db"),
              "--image_path", os.path.join(src, "input"),
              "--output_path", os.path.join(src, "distorted", "sparse"),
              "--Mapper.ba_global_function_tolerance=0.000001"])

    _run([colmap_executable, "image_undistorter",
          "--image_path", os.path.join(src, "input"),
          "--input_path", os.path.join(src, "distorted", "sparse", "0"),
          "--output_path", src,
          "--output_type", "COLMAP"])

    # undistorter writes the model directly under sparse/; the loaders
    # expect sparse/0/ (reference `convert.py:81-89`)
    sparse = os.path.join(src, "sparse")
    os.makedirs(os.path.join(sparse, "0"), exist_ok=True)
    for name in os.listdir(sparse):
        if name != "0":
            shutil.move(os.path.join(sparse, name),
                        os.path.join(sparse, "0", name))

    if resize:
        resize_images(src)


def resize_images(source_path: str,
                  factors: tuple[int, ...] = (2, 4, 8)) -> None:
    """`images/` -> `images_{f}/` downscales (reference uses imagemagick
    mogrify 50/25/12.5%; Pillow's LANCZOS in the JAX app, `resize_lanczos`
    here), each written in its name's format: PNG, or JPEG at Pillow's
    defaults (quality 75, 4:2:0) through the port's encoder."""
    img_dir = os.path.join(source_path, "images")
    for f in factors:
        os.makedirs(os.path.join(source_path, f"images_{f}"), exist_ok=True)
    for name in sorted(os.listdir(img_dir)):
        im = read_image(os.path.join(img_dir, name))
        h, w = im.shape[:2]
        for f in factors:
            small = resize_lanczos(im, (max(w // f, 1), max(h // f, 1)))
            out = os.path.join(source_path, f"images_{f}", name)
            if name.lower().endswith((".jpg", ".jpeg")):
                write_jpeg(out, small)
            else:
                write_png(out, small)


def main(argv=None):
    p = argparse.ArgumentParser("colmap convert (stock 3DGS layout)")
    p.add_argument("--source_path", "-s", required=True)
    p.add_argument("--camera", default="OPENCV")
    p.add_argument("--colmap_executable", default="colmap")
    p.add_argument("--no_gpu", action="store_true")
    p.add_argument("--skip_matching", action="store_true")
    p.add_argument("--resize", action="store_true")
    a = p.parse_args(argv)
    convert(a.source_path, colmap_executable=a.colmap_executable,
            camera=a.camera, use_gpu=not a.no_gpu,
            skip_matching=a.skip_matching, resize=a.resize)


if __name__ == "__main__":
    main()
