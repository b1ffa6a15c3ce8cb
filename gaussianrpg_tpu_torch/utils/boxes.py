"""3D box geometry + pinhole projection helpers (numpy, host-side).

Equivalents of the reference's `lib/utils/box_utils.py` (bbox_to_corner3d,
inbbox_points, get_bound_2d_mask) and `lib/utils/graphics_utils.py`
project_numpy — used by the data-prep converter and the simulator's
box-projection detector.

A copy of `gaussianrpg_tpu/utils/boxes.py`.
"""
from __future__ import annotations

import numpy as np


def bbox_to_corner3d(bbox: np.ndarray) -> np.ndarray:
    """[[xmin,ymin,zmin],[xmax,ymax,zmax]] -> 8 corners [2,2,2,3] flattened
    to [8, 3] in (x-major, y, z) binary order."""
    lo, hi = np.asarray(bbox[0]), np.asarray(bbox[1])
    corners = np.empty((2, 2, 2, 3))
    for i, x in enumerate((lo[0], hi[0])):
        for j, y in enumerate((lo[1], hi[1])):
            for k, z in enumerate((lo[2], hi[2])):
                corners[i, j, k] = (x, y, z)
    return corners.reshape(8, 3)


def box_corners_vehicle(center, dims_lwh, heading) -> np.ndarray:
    """8 corners of an upright box (center xyz, length/width/height, yaw)
    in the vehicle frame."""
    length, width, height = dims_lwh
    local = bbox_to_corner3d(np.array(
        [[-length / 2, -width / 2, -height / 2],
         [length / 2, width / 2, height / 2]]))
    c, s = np.cos(heading), np.sin(heading)
    rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    return local @ rot.T + np.asarray(center)


def inbbox_points(points: np.ndarray, corner3d: np.ndarray) -> np.ndarray:
    """Axis-aligned containment mask given [8,3] corners of an AABB."""
    lo = corner3d.min(axis=0)
    hi = corner3d.max(axis=0)
    return np.all((points >= lo) & (points <= hi), axis=-1)


def project_points(xyz: np.ndarray, K: np.ndarray, w2c: np.ndarray,
                   H: int, W: int) -> tuple[np.ndarray, np.ndarray]:
    """Pinhole projection: world/vehicle points -> pixel uv + validity
    (in front of camera and inside the image)."""
    pts = np.concatenate([xyz, np.ones_like(xyz[..., :1])], axis=-1)
    cam = pts @ w2c.T
    z = cam[..., 2]
    uvw = cam[..., :3] @ K.T
    uv = uvw[..., :2] / np.clip(uvw[..., 2:3], 1e-6, None)
    valid = (z > 0) & (uv[..., 0] >= 0) & (uv[..., 0] < W) \
        & (uv[..., 1] >= 0) & (uv[..., 1] < H)
    return uv, valid


def _fill_convex(mask: np.ndarray, pts: np.ndarray):
    """Rasterize the convex hull of 2D points into a bool mask (scanline
    over half-plane intersection; replaces cv2.fillPoly)."""
    H, W = mask.shape
    hull = _convex_hull(pts)
    if len(hull) < 3:
        return
    ys, xs = np.mgrid[0:H, 0:W]
    inside = np.ones((H, W), bool)
    n = len(hull)
    # interior lies on one consistent side of every edge; pick the side
    # from the polygon's signed area (robust to either orientation)
    area2 = sum(
        hull[i][0] * hull[(i + 1) % n][1] - hull[(i + 1) % n][0] * hull[i][1]
        for i in range(n))
    sgn = 1.0 if area2 >= 0 else -1.0
    for i in range(n):
        x0, y0 = hull[i]
        x1, y1 = hull[(i + 1) % n]
        inside &= sgn * ((x1 - x0) * (ys - y0)
                         - (y1 - y0) * (xs - x0)) >= 0
    mask |= inside


def _convex_hull(pts: np.ndarray) -> np.ndarray:
    """Andrew monotone chain, CCW in (x, y) with y down (image coords)."""
    pts = np.unique(np.asarray(pts, np.float64), axis=0)
    if len(pts) <= 2:
        return pts
    pts = pts[np.lexsort((pts[:, 1], pts[:, 0]))]

    def half(seq):
        out = []
        for p in seq:
            while len(out) >= 2:
                ax, ay = out[-1] - out[-2]
                bx, by = p - out[-2]
                if ax * by - ay * bx <= 0:
                    out.pop()
                else:
                    break
            out.append(p)
        return out

    lower = half(pts)
    upper = half(pts[::-1])
    return np.asarray(lower[:-1] + upper[:-1])


def get_bound_2d_mask(corners_3d: np.ndarray, K: np.ndarray,
                      w2c: np.ndarray, H: int, W: int) -> np.ndarray:
    """Projected-silhouette mask of a 3D box: convex hull of the corner
    projections (points behind the camera are clamped to the near plane)."""
    pts = np.concatenate(
        [corners_3d, np.ones_like(corners_3d[..., :1])], axis=-1)
    cam = pts @ w2c.T
    cam[:, 2] = np.clip(cam[:, 2], 1e-3, None)
    uvw = cam[:, :3] @ K.T
    uv = uvw[:, :2] / uvw[:, 2:3]
    mask = np.zeros((H, W), bool)
    uv = np.clip(uv, [-4 * W, -4 * H], [4 * W, 4 * H])
    _fill_convex(mask, uv)
    return mask
