"""Known-pose COLMAP triangulation for Waymo scenes.

Equivalent of `script/waymo/colmap_waymo_full.py:26-298`: stages the
training images per camera, writes a COLMAP "created" model with the
known camera poses (images.txt / cameras.txt, SIMPLE_PINHOLE), runs
feature extraction masked by the dynamic masks, exhaustive matching and
`point_triangulator`, optionally a rig bundle adjustment. The resulting
sparse points seed the background Gaussians (read back through
`data/colmap.py`).

The COLMAP binary is an external dependency (exactly as in the
reference); everything that doesn't invoke it (model/rig-config
generation) is pure and unit-testable.

Counterpart of `gaussianrpg_tpu/apps/colmap_triangulate.py`: the port's
`WaymoScene` and `matrix_to_quaternion`; masks and image sizes through
`data/image_io` (no Pillow).
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sqlite3
import subprocess

import numpy as np
import torch

from ..data.image_io import image_hw, read_grey, write_png
from ..ops.math3d import matrix_to_quaternion  # (w, x, y, z)


def _quaternion(rot: np.ndarray) -> np.ndarray:
    """(w, x, y, z) of a rotation matrix, in float32 as the JAX app."""
    return matrix_to_quaternion(
        torch.from_numpy(rot.astype(np.float32))).numpy()


def write_known_pose_model(model_dir: str, images: list, cameras: dict):
    """COLMAP text model with fixed poses.

    images: list of dicts {id, name ('cam_{c}/{frame}.png'), c2w [4,4],
    cam}; cameras: {cam_id: {K [3,3], width, height}}.
    """
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, "images.txt"), "w") as f:
        for im in images:
            w2c = np.linalg.inv(np.asarray(im["c2w"], np.float64))
            qw, qx, qy, qz = _quaternion(w2c[:3, :3])
            tx, ty, tz = w2c[:3, 3]
            f.write(f"{im['id']} {qw} {qx} {qy} {qz} {tx} {ty} {tz} "
                    f"{im['cam']} {im['name']}\n\n")
    with open(os.path.join(model_dir, "cameras.txt"), "w") as f:
        for cam_id, info in sorted(cameras.items()):
            K = np.asarray(info["K"])
            f.write(f"{cam_id} SIMPLE_PINHOLE {info['width']} "
                    f"{info['height']} {K[0, 0]} {K[0, 2]} {K[1, 2]}\n")
    open(os.path.join(model_dir, "points3D.txt"), "w").close()


def write_rig_config(path: str, extrinsics: dict, ref_cam: int):
    """Rig config (camera-from-rig transforms relative to ref_cam) for
    `colmap rig_bundle_adjuster`."""
    rig = {"ref_camera_id": ref_cam, "cameras": []}
    ref = np.asarray(extrinsics[ref_cam], np.float64)
    for cam_id, ext in sorted(extrinsics.items()):
        rel = np.linalg.inv(np.asarray(ext, np.float64)) @ ref
        qw, qx, qy, qz = _quaternion(rel[:3, :3])
        rig["cameras"].append({
            "camera_id": cam_id,
            "image_prefix": f"cam_{cam_id}",
            "cam_from_rig_rotation": [float(qw), float(qx), float(qy),
                                      float(qz)],
            "cam_from_rig_translation": [float(x) for x in rel[:3, 3]],
        })
    with open(path, "w") as f:
        json.dump([rig], f, indent=4)


def _run(cmd: list):
    print("$", " ".join(cmd), flush=True)
    subprocess.run(cmd, check=True)


def run_triangulation(source_path: str, work_dir: str,
                      cameras=(0,), test_every: int | None = None,
                      rig_ba: bool = False):
    """Full pipeline over a converted Waymo scene directory."""
    if shutil.which("colmap") is None:
        raise RuntimeError(
            "colmap binary not found on PATH (external dependency, "
            "same as the reference)")
    from ..data.waymo import WaymoScene, get_val_frames

    scene = WaymoScene(source_path, cameras=tuple(cameras),
                       load_images=False)
    colmap_dir = os.path.join(work_dir, "colmap")
    train_dir = os.path.join(colmap_dir, "train_imgs")
    mask_dir = os.path.join(colmap_dir, "mask")

    train_frames = set(range(scene.num_frames))
    if test_every:
        val = set(get_val_frames(scene.num_frames, test_every, None))
        train_frames -= val

    images, cam_infos = [], {}
    img_id = 1
    for cam in cameras:
        os.makedirs(os.path.join(train_dir, f"cam_{cam}"), exist_ok=True)
        os.makedirs(os.path.join(mask_dir, f"cam_{cam}"), exist_ok=True)
    for fi in range(scene.num_frames):
        if fi not in train_frames:
            continue
        frame = scene.start_frame + fi
        for cam in cameras:
            src = scene.image_path(frame, cam)
            name = f"cam_{cam}/{frame:06d}.png"
            dst = os.path.join(train_dir, name)
            if not os.path.exists(dst):
                shutil.copyfile(src, dst)
            dmask = os.path.join(source_path, "dynamic_mask",
                                 f"{frame:06d}_{cam}.png")
            if os.path.exists(dmask):
                m = read_grey(dmask)
                write_png(os.path.join(mask_dir, f"{name}.png"), 255 - m)
            images.append({"id": img_id, "name": name,
                           "c2w": scene.camera_to_world(frame, cam),
                           "cam": cam})
            img_id += 1
            if cam not in cam_infos:
                K = scene.intrinsics[cam]
                h, w = image_hw(src)
                cam_infos[cam] = {"K": K, "width": w, "height": h}

    db = os.path.join(colmap_dir, "database.db")
    _run(["colmap", "feature_extractor",
          "--ImageReader.mask_path", mask_dir,
          "--ImageReader.camera_model", "SIMPLE_PINHOLE",
          "--ImageReader.single_camera_per_folder", "1",
          "--database_path", db, "--image_path", train_dir])

    # align our image ids with the database's
    conn = sqlite3.connect(db)
    rows = conn.execute("SELECT image_id, name, camera_id FROM images"
                        ).fetchall()
    by_name = {name: (iid, cid) for iid, name, cid in rows}
    for im in images:
        im["id"], db_cam = by_name[im["name"]]
    for cam, info in cam_infos.items():
        _, cid = by_name[f"cam_{cam}/{scene.start_frame:06d}.png"]
        K = np.asarray(info["K"], np.float64)
        params = np.array([K[0, 0], K[0, 2], K[1, 2]], np.float64)
        conn.execute("UPDATE cameras SET params = ? WHERE camera_id = ?",
                     (params.tobytes(), cid))
    conn.commit()
    conn.close()

    model_dir = os.path.join(colmap_dir, "created", "sparse", "model")
    write_known_pose_model(model_dir, images, cam_infos)
    rig_path = os.path.join(colmap_dir, "cam_rigid_config.json")
    write_rig_config(rig_path,
                     {c: scene.extrinsics[c] for c in cameras},
                     ref_cam=cameras[0])

    _run(["colmap", "exhaustive_matcher", "--database_path", db])
    tri_dir = os.path.join(colmap_dir, "triangulated", "sparse", "model")
    os.makedirs(tri_dir, exist_ok=True)
    _run(["colmap", "point_triangulator",
          "--database_path", db, "--image_path", train_dir,
          "--input_path", model_dir, "--output_path", tri_dir,
          "--Mapper.ba_refine_focal_length", "0",
          "--Mapper.ba_refine_principal_point", "0",
          "--Mapper.max_extra_param", "0",
          "--clear_points", "0",
          "--Mapper.ba_global_max_num_iterations", "30",
          "--Mapper.filter_max_reproj_error", "4",
          "--Mapper.filter_min_tri_angle", "0.5",
          "--Mapper.tri_min_angle", "0.5",
          "--Mapper.tri_ignore_two_view_tracks", "1",
          "--Mapper.tri_complete_max_reproj_error", "4",
          "--Mapper.tri_continue_max_angle_error", "4"])
    if rig_ba:
        _run(["colmap", "rig_bundle_adjuster",
              "--input_path", tri_dir, "--output_path", tri_dir,
              "--rig_config_path", rig_path,
              "--estimate_rig_relative_poses", "0",
              "--RigBundleAdjustment.refine_relative_poses", "1",
              "--BundleAdjustment.max_num_iterations", "50",
              "--BundleAdjustment.refine_focal_length", "0",
              "--BundleAdjustment.refine_principal_point", "0",
              "--BundleAdjustment.refine_extra_params", "0"])
    return tri_dir


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--source_path", required=True)
    ap.add_argument("--work_dir", required=True)
    ap.add_argument("--cameras", type=int, nargs="+", default=[0])
    ap.add_argument("--test_every", type=int, default=None)
    ap.add_argument("--rig_ba", action="store_true")
    args = ap.parse_args(argv)
    out = run_triangulation(args.source_path, args.work_dir,
                            tuple(args.cameras), args.test_every,
                            args.rig_ba)
    print(f"triangulated model -> {out}")


if __name__ == "__main__":
    main()
