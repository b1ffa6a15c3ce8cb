"""Waymo Open Dataset TFRecord -> training-scene converter.

TPU-framework equivalent of `script/waymo/waymo_converter.py:97-523`:
extracts ego/camera poses, calibration, images, LiDAR pointclouds, object
tracks, and dynamic masks into the directory layout the Waymo reader
(data/waymo.py) consumes:

    {out}/ego_pose/{frame:06d}.txt, {frame:06d}_{cam}.txt
    {out}/intrinsics/{cam}.txt      (fx fy cx cy k1 k2 p1 p2 k3)
    {out}/extrinsics/{cam}.txt      (4x4 OpenCV-cam -> vehicle)
    {out}/images/{frame:06d}_{cam}.jpg   (raw sensor JPEG bytes)
    {out}/pointcloud.npz            (per-frame vehicle-frame points +
                                     camera projections)
    {out}/timestamps.json
    {out}/track/track_info.txt, track_camera_vis.json, track_ids.json
    {out}/dynamic_mask/{frame:06d}_{cam}.png  (moving-object masks)

Differences from the reference: one pass over the file instead of six
(each `process` re-read the TFRecord there), the native C++ TFRecord
reader + hand-rolled proto decoding instead of TensorFlow-less generated
protobuf, and images stored as the original JPEG bytes (lossless w.r.t.
the source; the reference re-encoded to PNG via cv2).

Counterpart of `gaussianrpg_tpu/apps/waymo_converter.py`, the same code on
the port's own copies of the proto decoder, the native reader and the box
utilities; the files it writes are byte-equal to the JAX converter's
(`pointcloud.npz` holds equal arrays). Runs on the host only.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..data import waymo_proto as wp
from ..data.image_io import write_png
from ..data.native import TFRecordFile
from ..utils.boxes import box_corners_vehicle, get_bound_2d_mask, \
    project_points

# [forward, left, up] (Waymo camera frame) -> [right, down, forward]
# (OpenCV); reference waymo_converter.py:42-50
OPENCV2CAMERA = np.array([
    [0.0, 0.0, 1.0, 0.0],
    [-1.0, 0.0, 0.0, 0.0],
    [0.0, -1.0, 0.0, 0.0],
    [0.0, 0.0, 0.0, 1.0],
])

ALL_PROCESSES = ("pose", "calib", "image", "lidar", "track", "dynamic_mask")


def _K_from_intrinsic(intr) -> np.ndarray:
    fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]])


def _opencv_extrinsic(calib) -> np.ndarray:
    cam2vehicle = np.array(calib.extrinsic.transform).reshape(4, 4)
    return cam2vehicle @ OPENCV2CAMERA


def write_gray_png(path: str, img: np.ndarray):
    """8-bit grayscale PNG (no row filter, zlib level 6: the JAX
    converter's bytes)."""
    write_png(path, np.ascontiguousarray(img, np.uint8), 6)


def _project_box_visibility(corners_vehicle, calib):
    """valid-any / valid-all of box-corner projections into one camera
    (reference project_label_to_image:61-76)."""
    K = _K_from_intrinsic(calib.intrinsic)
    w2c = np.linalg.inv(_opencv_extrinsic(calib))
    _, valid = project_points(corners_vehicle, K, w2c,
                              int(calib.height), int(calib.width))
    return valid.any(), valid.all()


def convert_sequence(tfrecord_path: str, out_dir: str,
                     processes=ALL_PROCESSES,
                     start: int | None = None, end: int | None = None,
                     log=print) -> dict:
    """Convert one sequence; returns summary counts."""
    os.makedirs(out_dir, exist_ok=True)
    tf = TFRecordFile(tfrecord_path)
    n_frames = len(tf)
    start = start or 0
    end = n_frames - 1 if end is None else end

    for sub in ("ego_pose", "intrinsics", "extrinsics", "images",
                "track", "dynamic_mask"):
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)

    timestamps: dict = {"FRAME": {}}
    for name in wp.CAMERA_NAMES.values():
        timestamps[name] = {}
    pts_3d_all: dict = {}
    pts_2d_all: dict = {}
    object_ids: dict = {}
    bbox_visible: dict = {}
    track_rows = ["frame_id track_id object_class alpha box_height "
                  "box_width box_length box_center_x box_center_y "
                  "box_center_z box_heading speed"]
    calib_written = False

    for frame_id in range(start, end + 1):
        frame = wp.parse_frame(tf.record(frame_id))
        fkey = f"{frame_id:06d}"

        if "pose" in processes:
            pose = np.array(frame.pose.transform).reshape(4, 4)
            np.savetxt(os.path.join(out_dir, "ego_pose", f"{fkey}.txt"),
                       pose)
            timestamps["FRAME"][fkey] = frame.timestamp_micros / 1e6
            for img in frame.images:
                cam_name = wp.CAMERA_NAMES[img.name]
                timestamps[cam_name][fkey] = img.pose_timestamp
                cam_pose = np.array(img.pose.transform).reshape(4, 4)
                np.savetxt(
                    os.path.join(out_dir, "ego_pose",
                                 f"{fkey}_{img.name - 1}.txt"), cam_pose)

        if "calib" in processes and not calib_written:
            for calib in frame.context.camera_calibrations:
                cam = calib.name - 1
                np.savetxt(os.path.join(out_dir, "extrinsics",
                                        f"{cam}.txt"),
                           _opencv_extrinsic(calib))
                np.savetxt(os.path.join(out_dir, "intrinsics",
                                        f"{cam}.txt"),
                           np.asarray(calib.intrinsic))
            calib_written = True

        if "image" in processes:
            for img in frame.images:
                path = os.path.join(out_dir, "images",
                                    f"{fkey}_{img.name - 1}.jpg")
                with open(path, "wb") as f:
                    f.write(img.image)

        if "lidar" in processes:
            pts_3d, pts_2d = [], []
            for laser in frame.lasers:
                ri1 = laser.ri_return1
                if not ri1.range_image_compressed:
                    continue
                calib = wp.get_by_name(frame.context.laser_calibrations,
                                       laser.name)
                ri = wp.decode_matrix_float(ri1.range_image_compressed)
                pts, _ = wp.range_image_to_pointcloud(ri, calib)
                pts_3d.append(pts.astype(np.float32))
                cp = wp.decode_matrix_int32(
                    ri1.camera_projection_compressed)
                cp = cp[ri[:, :, 0] > 0]
                cp[:, 0] -= 1
                cp[:, 3] -= 1
                pts_2d.append(cp.astype(np.int16))
            pts_3d_all[frame_id] = np.concatenate(pts_3d, axis=0)
            pts_2d_all[frame_id] = np.concatenate(pts_2d, axis=0)

        if "track" in processes or "dynamic_mask" in processes:
            masks = {}
            if "dynamic_mask" in processes:
                for calib in frame.context.camera_calibrations:
                    masks[calib.name] = np.zeros(
                        (int(calib.height), int(calib.width)), bool)

            for label in frame.laser_labels:
                box = label.box
                dims = (box.length, box.width, box.height)
                corners = box_corners_vehicle(
                    (box.center_x, box.center_y, box.center_z), dims,
                    box.heading)
                speed = float(np.hypot(label.metadata.speed_x,
                                       label.metadata.speed_y))

                if "track" in processes:
                    if label.id not in object_ids:
                        object_ids[label.id] = len(object_ids)
                    lid = object_ids[label.id]
                    vis = []
                    for calib in frame.context.camera_calibrations:
                        any_v, _ = _project_box_visibility(corners, calib)
                        if any_v:
                            vis.append(calib.name - 1)
                    bbox_visible.setdefault(lid, {})[frame_id] = sorted(vis)
                    cls = wp.LABEL_CLASS.get(label.type, "misc")
                    track_rows.append(
                        f"{frame_id} {lid} {cls} -10 {box.height} "
                        f"{box.width} {box.length} {box.center_x} "
                        f"{box.center_y} {box.center_z} {box.heading} "
                        f"{speed}")

                if "dynamic_mask" in processes and speed >= 1.0:
                    # moving-object threshold 1 m/s (EmerNeRF convention,
                    # reference waymo_converter.py:481-484)
                    for calib in frame.context.camera_calibrations:
                        any_v, _ = _project_box_visibility(corners, calib)
                        if any_v:
                            K = _K_from_intrinsic(calib.intrinsic)
                            w2c = np.linalg.inv(_opencv_extrinsic(calib))
                            masks[calib.name] |= get_bound_2d_mask(
                                corners, K, w2c, int(calib.height),
                                int(calib.width))

            if "dynamic_mask" in processes:
                for cam_name, mask in masks.items():
                    write_gray_png(
                        os.path.join(out_dir, "dynamic_mask",
                                     f"{fkey}_{cam_name - 1}.png"),
                        mask.astype(np.uint8) * 255)

        if frame_id % 20 == 0:
            log(f"  frame {frame_id}/{end}")

    if "pose" in processes:
        with open(os.path.join(out_dir, "timestamps.json"), "w") as f:
            json.dump(timestamps, f, indent=1)
    if "lidar" in processes:
        np.savez_compressed(os.path.join(out_dir, "pointcloud.npz"),
                            pointcloud=pts_3d_all,
                            camera_projection=pts_2d_all)
    if "track" in processes:
        with open(os.path.join(out_dir, "track", "track_info.txt"),
                  "w") as f:
            f.write("\n".join(track_rows) + "\n")
        with open(os.path.join(out_dir, "track",
                               "track_camera_vis.json"), "w") as f:
            json.dump(bbox_visible, f, indent=1)
        with open(os.path.join(out_dir, "track", "track_ids.json"),
                  "w") as f:
            json.dump(object_ids, f, indent=2)

    tf.close()
    return {"frames": end - start + 1, "objects": len(object_ids)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--tfrecord", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--process_list", nargs="+", default=list(ALL_PROCESSES))
    ap.add_argument("--start_idx", type=int, default=None)
    ap.add_argument("--end_idx", type=int, default=None)
    args = ap.parse_args(argv)
    summary = convert_sequence(args.tfrecord, args.out,
                               tuple(args.process_list),
                               args.start_idx, args.end_idx)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
