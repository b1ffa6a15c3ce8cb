"""Write synthetic Waymo Open Dataset TFRecords: the input of
`apps/waymo_converter.py`, for the tests and `chip_smoke.py` (as
`utils/waymo_layout.py` writes the converter's output layout). Not an app.

  wire encoders      protobuf fields (varint, fixed64 double, bytes,
                     packed doubles / floats / varints) and the Waymo
                     `MatrixFloat` / `MatrixInt32` range-image messages (a
                     copy of `tests/test_waymo_converter.py`'s, packed
                     varints vectorised)
  message builders   camera and laser calibrations, camera images (their
                     bytes a real baseline JPEG, `data/image_io.encode_jpeg`),
                     LiDAR returns, labels, frames; `write_tfrecord`
  street LiDAR       `Laser.ranges`: the range image of a spinning LiDAR
                     whose rays end on a flat street (a rectangle of the
                     ground plane, in world coordinates) or on a box
                     (`Box`), in the converter's angle convention
                     (`data/waymo_proto.range_image_to_pointcloud`);
                     `camera_projection`: each return's first two
                     camera hits, as the dataset stores them

Field numbers follow the public dataset.proto / label.proto (Apache 2.0),
as `data/waymo_proto.py` reads them.
"""
from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass

import numpy as np

# ------------------------------------------------------------ wire encoders


def _varint(v):
    out = b""
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _tag(fno, wt):
    return _varint(fno << 3 | wt)


def f_varint(fno, v):
    return _tag(fno, 0) + _varint(v)


def f_double(fno, v):
    return _tag(fno, 1) + struct.pack("<d", v)


def f_bytes(fno, b):
    return _tag(fno, 2) + _varint(len(b)) + b


def f_msg(fno, payload):
    return f_bytes(fno, payload)


def f_packed_doubles(fno, vals):
    return f_bytes(fno, np.asarray(vals, "<f8").tobytes())


def f_packed_floats(fno, vals):
    return f_bytes(fno, np.asarray(vals, "<f4").tobytes())


def _packed_varint_bytes(vals) -> bytes:
    """Varints of uint64 values, vectorised (negative int64s as their
    ten-byte two's complement, as protobuf writes int32 fields)."""
    v = np.asarray(vals, np.int64).reshape(-1).view(np.uint64)
    if v.size == 0:
        return b""
    nbytes = np.maximum(1, (np.frexp(v.astype(np.float64))[1] + 6) // 7)
    # frexp rounds values above 2^53; count their bits exactly
    big = v >= np.uint64(1 << 53)
    if big.any():
        nbytes[big] = [-(-int(x).bit_length() // 7) for x in v[big]]
    k = np.arange(nbytes.sum()) - np.repeat(np.cumsum(nbytes) - nbytes,
                                            nbytes)
    src = np.repeat(v, nbytes)
    out = ((src >> (7 * k).astype(np.uint64)) & np.uint64(0x7F)).astype(
        np.uint8)
    more = np.ones(out.size, bool)
    more[np.cumsum(nbytes) - 1] = False
    out[more] |= 0x80
    return out.tobytes()


def f_packed_varints(fno, vals):
    return f_bytes(fno, _packed_varint_bytes(vals))


def enc_transform(mat):
    return f_packed_doubles(1, np.asarray(mat).reshape(-1))


def enc_matrix_float(arr):
    arr = np.asarray(arr, np.float32)
    shape = f_msg(2, f_packed_varints(1, arr.shape))
    return f_packed_floats(1, arr.reshape(-1)) + shape


def enc_matrix_int32(arr):
    arr = np.asarray(arr, np.int64)
    shape = f_msg(2, f_packed_varints(1, arr.shape))
    return f_packed_varints(1, arr.reshape(-1)) + shape


def write_tfrecord(path, payloads):
    """TFRecord framing with zero CRCs (the readers skip them)."""
    with open(path, "wb") as f:
        for p in payloads:
            f.write(struct.pack("<Q", len(p)))
            f.write(b"\x00" * 4)
            f.write(p)
            f.write(b"\x00" * 4)


# --------------------------------------------------------- message builders

# camera frame of the dataset (x forward, y left, z up) -> OpenCV
# (x right, y down, z forward), as `apps/waymo_converter.OPENCV2CAMERA`
OPENCV2CAMERA = np.array([[0.0, 0.0, 1.0, 0.0], [-1.0, 0.0, 0.0, 0.0],
                          [0.0, -1.0, 0.0, 0.0], [0.0, 0.0, 0.0, 1.0]])


def yaw_pose(yaw: float, xyz=(0.0, 0.0, 0.0)) -> np.ndarray:
    """4x4 rotation by `yaw` about z, then translation by `xyz`."""
    c, s = np.cos(yaw), np.sin(yaw)
    m = np.eye(4)
    m[:2, :2] = [[c, -s], [s, c]]
    m[:3, 3] = xyz
    return m


@dataclass
class Camera:
    """A camera of the rig: its dataset name (1 = FRONT .. 5 =
    SIDE_RIGHT), size, pinhole intrinsics and camera -> vehicle pose in the
    dataset's camera axes."""
    name: int
    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float
    to_vehicle: np.ndarray

    def calibration(self) -> bytes:
        return (f_varint(1, self.name)
                + f_packed_doubles(2, [self.fx, self.fy, self.cx, self.cy,
                                       0, 0, 0, 0, 0])
                + f_msg(3, enc_transform(self.to_vehicle))
                + f_varint(4, self.width) + f_varint(5, self.height))

    def opencv_to_vehicle(self) -> np.ndarray:
        return self.to_vehicle @ OPENCV2CAMERA

    def image(self, jpeg: bytes, pose, timestamp: float) -> bytes:
        return (f_varint(1, self.name) + f_bytes(2, jpeg)
                + f_msg(3, enc_transform(pose)) + f_double(5, timestamp))


@dataclass
class Box:
    """A labelled box in the vehicle frame: centre, (length, width,
    height), heading and (x, y) speed in m/s."""
    track: str
    center: tuple
    dims: tuple
    heading: float = 0.0
    speed: tuple = (0.0, 0.0)
    kind: int = 1           # label.proto Type: 1 vehicle

    def label(self) -> bytes:
        (x, y, z), (ln, w, h) = self.center, self.dims
        box = (f_double(1, x) + f_double(2, y) + f_double(3, z)
               + f_double(4, w) + f_double(5, ln) + f_double(6, h)
               + f_double(7, self.heading))
        meta = f_double(1, self.speed[0]) + f_double(2, self.speed[1])
        return (f_msg(1, box) + f_msg(2, meta) + f_varint(3, self.kind)
                + f_bytes(4, self.track.encode()))

    def hit(self, origin: np.ndarray, dirs: np.ndarray) -> np.ndarray:
        """Distance along each unit ray [..., 3] from `origin` to the box
        (slab test in the box's frame), inf where it misses."""
        c, s = np.cos(-self.heading), np.sin(-self.heading)
        rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
        o = rot @ (origin - np.asarray(self.center))
        d = dirs @ rot.T
        half = np.asarray(self.dims) / 2
        with np.errstate(divide="ignore", invalid="ignore"):
            t0 = (-half - o) / d
            t1 = (half - o) / d
        near = np.nanmax(np.minimum(t0, t1), axis=-1)
        far = np.nanmin(np.maximum(t0, t1), axis=-1)
        return np.where((far >= near) & (near > 0), near, np.inf)


@dataclass
class Laser:
    """A spinning LiDAR: its dataset name (1 = TOP .. 5 = REAR), range
    image size, beam inclinations (evenly spaced, radians) and laser ->
    vehicle pose."""
    name: int
    rows: int
    cols: int
    inclination_min: float
    inclination_max: float
    to_vehicle: np.ndarray
    max_range: float = 75.0

    def calibration(self) -> bytes:
        return (f_varint(1, self.name)
                + f_double(3, self.inclination_min)
                + f_double(4, self.inclination_max)
                + f_msg(5, enc_transform(self.to_vehicle)))

    def rays(self) -> np.ndarray:
        """Unit ray directions [rows, cols, 3] in the vehicle frame, row 0
        the highest beam (`range_image_to_pointcloud`'s convention)."""
        incl = np.linspace(self.inclination_min, self.inclination_max,
                           self.rows)[::-1]
        ext = self.to_vehicle
        az = np.linspace(np.pi, -np.pi, self.cols) - np.arctan2(ext[1, 0],
                                                                ext[0, 0])
        d = np.stack([np.cos(az)[None] * np.cos(incl)[:, None],
                      np.sin(az)[None] * np.cos(incl)[:, None],
                      np.broadcast_to(np.sin(incl)[:, None],
                                      (self.rows, self.cols))], -1)
        return d @ ext[:3, :3].T

    def ranges(self, ego_pose: np.ndarray, street, ground_z: float,
               boxes=()) -> tuple[np.ndarray, np.ndarray]:
        """(range image [rows, cols, 4] float32 (range, then zeros), the
        returns' vehicle-frame points [rows, cols, 3]): each ray ends on the
        nearest box of `boxes` or on the ground plane z = ground_z (world)
        inside `street` = (x0, x1, y0, y1) (world); no return (0) past
        max_range or where it meets neither."""
        dirs = self.rays()
        origin = self.to_vehicle[:3, 3]
        # the ego is level (its rotation only turns about z)
        dz = dirs[..., 2]
        with np.errstate(divide="ignore", invalid="ignore"):
            t = np.where(dz < 0, (ground_z - ego_pose[2, 3] - origin[2]) / dz,
                         np.inf)
        pts = origin + np.where(np.isfinite(t), t, 0.0)[..., None] * dirs
        world = pts @ ego_pose[:3, :3].T + ego_pose[:3, 3]
        x0, x1, y0, y1 = street
        on = ((world[..., 0] >= x0) & (world[..., 0] <= x1)
              & (world[..., 1] >= y0) & (world[..., 1] <= y1))
        t = np.where(on, t, np.inf)
        for box in boxes:
            t = np.minimum(t, box.hit(origin, dirs))
        t = np.where(t <= self.max_range, t, 0.0)
        ri = np.zeros((self.rows, self.cols, 4), np.float32)
        ri[..., 0] = t
        return ri, origin + t[..., None] * dirs

    def returns(self, range_image: np.ndarray,
                projection: np.ndarray) -> bytes:
        ri = (f_bytes(2, zlib.compress(enc_matrix_float(range_image)))
              + f_bytes(3, zlib.compress(enc_matrix_int32(projection))))
        return f_varint(1, self.name) + f_msg(2, ri)


def camera_projection(points: np.ndarray, hit: np.ndarray,
                      cameras) -> np.ndarray:
    """[rows, cols, 6] int32 (camera name, x, y) twice: the first two
    cameras of `cameras` whose image each return (vehicle-frame points
    [rows, cols, 3], where `hit`) falls in, 0 where none."""
    out = np.zeros(points.shape[:2] + (6,), np.int32)
    slot = np.zeros(points.shape[:2], np.int64)
    for cam in cameras:
        w2c = np.linalg.inv(cam.opencv_to_vehicle())
        p = points @ w2c[:3, :3].T + w2c[:3, 3]
        z = p[..., 2]
        with np.errstate(divide="ignore", invalid="ignore"):
            u = cam.fx * p[..., 0] / z + cam.cx
            v = cam.fy * p[..., 1] / z + cam.cy
        sel = (hit & (z > 0) & (u >= 0) & (u < cam.width) & (v >= 0)
               & (v < cam.height) & (slot < 2))
        for k in (0, 1):
            s = sel & (slot == k)
            out[s, 3 * k] = cam.name
            out[s, 3 * k + 1] = u[s].astype(np.int32)
            out[s, 3 * k + 2] = v[s].astype(np.int32)
        slot += sel
    return out


def frame(*, name: str, timestamp: float, ego_pose: np.ndarray, cameras,
          jpegs: dict, lasers, returns: dict, boxes=()) -> bytes:
    """One Frame message: the context (camera and laser calibrations),
    the ego pose, each camera's image (`jpegs` by camera name; the
    image's pose is the ego's), each laser's first return (`returns` by
    laser name: (range image, camera projection)) and the boxes' labels."""
    context = (f_bytes(1, name.encode())
               + b"".join(f_msg(2, c.calibration()) for c in cameras)
               + b"".join(f_msg(3, ln.calibration()) for ln in lasers))
    out = (f_msg(1, context) + f_varint(2, int(round(timestamp * 1e6)))
           + f_msg(3, enc_transform(ego_pose)))
    for c in cameras:
        if c.name in jpegs:
            out += f_msg(4, c.image(jpegs[c.name], ego_pose, timestamp))
    for ln in lasers:
        if ln.name in returns:
            out += f_msg(5, ln.returns(*returns[ln.name]))
    for b in boxes:
        out += f_msg(6, b.label())
    return out


def street_frame(*, name: str, timestamp: float, ego_pose: np.ndarray,
                 cameras, jpegs: dict, lasers, street, ground_z: float,
                 boxes=()) -> bytes:
    """`frame` with each laser's returns from `Laser.ranges` on the
    street and the boxes, projected into the cameras."""
    returns = {}
    for ln in lasers:
        ri, pts = ln.ranges(ego_pose, street, ground_z, boxes)
        returns[ln.name] = (ri, camera_projection(pts, ri[..., 0] > 0,
                                                  cameras))
    return frame(name=name, timestamp=timestamp, ego_pose=ego_pose,
                 cameras=cameras, jpegs=jpegs, lasers=lasers,
                 returns=returns, boxes=boxes)
