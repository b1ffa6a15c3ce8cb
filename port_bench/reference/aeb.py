"""The closed loop's decisions, replayed plainly: the ego's dynamics at the
dynamics rate, the detections that NMS keeps from each frame's top-K
candidates, their flat-ground ranges, and the tiered AEB brake, as the
simulator's ROS2 graph defines them (the AEB controller, the object
detector's ground-plane ranging, the simulator's brake integration and
the evaluation's verdict; SURVEY.md section 3.3). Numpy and `math` only.

`replay` takes the candidates a program produced for each rendered frame
and works out, frame by frame, what the loop should have decided from
them and where the camera should have been. It never reads the
program's decisions.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np

MAX_WH = 7680.0          # class offset of per-class NMS (Ultralytics)
CIPV_LAT_M = 1.2         # in-lane half width of the AEB controller


class Frame(NamedTuple):
    n_det: int                   # detections NMS keeps
    brake: float                 # brake command, m/s^2
    position: np.ndarray         # world->camera translation (tape form)


class Episode(NamedTuple):
    verdict: str
    frames: list                 # [Frame] of every rendered frame


def nms(cand: np.ndarray, conf_thres: float, iou_thres: float,
        max_det: int = 300) -> np.ndarray:
    """Greedy per-class NMS of [K, 6] (cx, cy, w, h, conf, cls) rows above
    `conf_thres` -> [M, 6] (x0, y0, x1, y1, conf, cls), float32, most
    confident first. Classes are kept apart by shifting each class's
    boxes by MAX_WH."""
    c = np.asarray(cand, np.float32)
    c = c[c[:, 4] > conf_thres]
    c = c[np.argsort(-c[:, 4], kind="stable")]
    xyxy = np.concatenate([c[:, :2] - c[:, 2:4] / 2,
                           c[:, :2] + c[:, 2:4] / 2], 1)
    s = xyxy + (c[:, 5].astype(np.float32) * np.float32(MAX_WH))[:, None]
    area = (s[:, 2] - s[:, 0]) * (s[:, 3] - s[:, 1])
    kept, alive = [], np.ones(len(c), bool)
    for i in range(len(c)):
        if not alive[i]:
            continue
        kept.append(i)
        if len(kept) == max_det:
            break
        j = np.arange(i + 1, len(c))
        w = np.maximum(np.minimum(s[i, 2], s[j, 2])
                       - np.maximum(s[i, 0], s[j, 0]), 0)
        h = np.maximum(np.minimum(s[i, 3], s[j, 3])
                       - np.maximum(s[i, 1], s[j, 1]), 0)
        inter = w * h
        iou = inter / (area[i] + area[j] - inter + 1e-9)
        alive[j[iou > iou_thres]] = False
    k = np.asarray(kept, int)
    return np.concatenate([xyxy[k], c[k, 4:6]], 1) if len(k) \
        else np.zeros((0, 6), np.float32)


def to_image(det: np.ndarray, gain: float, pad: tuple, hw: tuple):
    """Letterboxed xyxy -> normalized (cx, cy, w, h) in the rendered
    image, clipped to it."""
    b = det[:, :4].astype(np.float32)
    b[:, [0, 2]] = np.clip((b[:, [0, 2]] - pad[0]) / gain, 0, hw[1])
    b[:, [1, 3]] = np.clip((b[:, [1, 3]] - pad[1]) / gain, 0, hw[0])
    H, W = hw
    return [((x0 + x1) / 2 / W, (y0 + y1) / 2 / H, (x1 - x0) / W,
             (y1 - y0) / H) for x0, y0, x1, y1 in b]


def ground_range(box, K: np.ndarray, v2c: np.ndarray, hw: tuple,
                 cam_height: float):
    """(range, lateral) of a box's bottom centre on flat ground below a
    camera `cam_height` up; (0, 0) where the bottom is at or above the
    horizon or behind the vehicle. `v2c` maps vehicle to camera."""
    H, W = hw
    u, v1 = box[0] * W, box[1] * H + box[3] * H / 2
    angle = math.atan((v1 - H / 2) / K[1, 1])
    if angle <= 0:
        return 0.0, 0.0
    depth = (cam_height / math.sin(angle)) * math.cos(angle)
    cam = np.linalg.inv(K) @ (depth * np.array([u, v1, 1.0]))
    veh = np.linalg.inv(v2c) @ np.append(cam, 1.0)
    if veh[0] <= 0:
        return 0.0, 0.0
    return float(math.hypot(veh[0], veh[1])), float(-veh[1])


def brake_command(cipv: float, speed: float, brake_distance: float):
    """The tiered command for the in-path vehicle at `cipv` metres."""
    if cipv < brake_distance:
        if speed > 2:
            return -13.5
        if speed > 1:
            return -10.0
        if speed > 0.001:
            return -8.0
    return 0.0


def replay(cands: list, *, positions: list, times: list, rate: int,
           dynamics_hz: float, episode_s: float, ahead_m: float,
           ego_x_m: float, brake_distance: float, collision_m: float,
           conf_thres: float, iou_thres: float, gain: float, pad: tuple,
           hw: tuple, K: np.ndarray, v2c: np.ndarray,
           cam_height: float) -> Episode:
    """The episode the loop should run on these candidates. `positions`
    and `times` are the rendered frames' planned world->camera
    translations and timestamps, interpolated linearly to the dynamics
    rate; once the AEB brakes, the ego moves along the camera's -z at the
    speed the commands leave it. A virtual vehicle stays `ahead_m` ahead
    of the planned ego pose, whose x is `ego_x_m`: the gap to it is
    ahead_m + ego_x_m - the distance the camera has travelled."""
    dt = 1.0 / dynamics_hz
    ticks_pos, ticks_t = [], []
    for k in range(len(positions) - 1):
        p0, p1 = np.asarray(positions[k]), np.asarray(positions[k + 1])
        for j in range(rate):
            ticks_pos.append(p0 + j * ((p1 - p0) / rate))
            ticks_t.append(times[k] + j * ((times[k + 1] - times[k]) / rate))
    ticks_pos.append(np.asarray(positions[-1]))
    ticks_t.append(times[-1])
    n = len(ticks_pos)

    last, speed, cmd, braking = ticks_pos[0], 0.0, 0.0, False
    z_prev, t_prev, lon_speed, cipv = None, None, 0.0, math.inf
    frames, verdict, i = [], None, 0
    while verdict is None and i < int((episode_s + 2.0) * dynamics_hz):
        pos = ticks_pos[min(i, n - 1)]
        t = ticks_t[i] if i < n else ticks_t[-1] + (i - n + 1) * dt
        if braking:
            v = max(speed + cmd * dt, 0.0)
            pos = last + v * dt * np.array([0.0, 0.0, -1.0])
        speed = float(np.linalg.norm(pos - last)) / dt
        last = pos
        if t_prev is not None and t - t_prev > 0:
            lon_speed = (z_prev - pos[2]) / (t - t_prev)
        z_prev, t_prev = pos[2], t
        if i % rate == 0:
            gap = ahead_m + ego_x_m + pos[2]
            if t - ticks_t[0] > episode_s:
                verdict = "success"
            elif gap < collision_m:
                verdict = "collision"
        if i % rate == 0 and verdict is None:
            k = len(frames)
            det = nms(cands[k], conf_thres, iou_thres) if k < len(cands) \
                else np.zeros((0, 6), np.float32)
            objects = [ground_range(b, K, v2c, hw, cam_height)
                       for b in to_image(det, gain, pad, hw)]
            objects = [(r, lat) for r, lat in objects if r > 0]
            lane = [r for r, lat in objects if -CIPV_LAT_M < lat < CIPV_LAT_M]
            if lane:
                cipv = min(lane)
            brake = brake_command(cipv, lon_speed, brake_distance)
            if brake != 0.0:
                braking, cmd = True, brake
            frames.append(Frame(len(det), brake, pos.copy()))
        i += 1
    return Episode(verdict or "timeout", frames)
