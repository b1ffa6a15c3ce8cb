"""Minimal protobuf wire-format decoder for Waymo Open Dataset frames.

The reference ships protoc-generated modules plus the google.protobuf
runtime (`submodules/simple-waymo-open-dataset-reader/dataset.proto`,
`label.proto`, used by `script/waymo/waymo_converter.py`). Here the frame
messages are decoded directly from the wire format against a declarative
schema — no generated code, no protobuf runtime, works on raw TFRecord
payloads from the native C++ reader (data/native.py).

A copy of `gaussianrpg_tpu/data/waymo_proto.py` (the port imports nothing of
the JAX package), but for packed varints (the int32 camera-projection
range images, a million values per LiDAR return), which are decoded
vectorised in numpy to the same values (`_packed_varints`).

Wire format: each field is a varint key `(field_number << 3) | wire_type`
with wire types 0=varint, 1=fixed64, 2=length-delimited, 5=fixed32.
Repeated scalars appear either packed (one length-delimited blob) or as
repeated single entries; both are handled.

Schema field numbers follow the public Waymo Open Dataset schema
(dataset.proto / label.proto, Apache 2.0).
"""
from __future__ import annotations

import struct
import zlib
from typing import Any

import numpy as np

# ---------------------------------------------------------------------------
# wire-level primitives


def _read_varint(buf: bytes, i: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[i]
        i += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, i
        shift += 7


def _packed_varints(buf) -> np.ndarray:
    """The varints of a packed repeated field, uint64 (negative int32s
    arrive as ten-byte two's complement)."""
    b = np.frombuffer(buf, np.uint8)
    if b.size == 0:
        return np.zeros(0, np.uint64)
    last = (b & 0x80) == 0
    if not last[-1]:
        raise ValueError("truncated varint")
    ends = np.nonzero(last)[0]
    starts = np.concatenate([[0], ends[:-1] + 1])
    k = np.arange(b.size) - np.repeat(starts, ends - starts + 1)
    parts = (b & 0x7F).astype(np.uint64) << (7 * k).astype(np.uint64)
    return np.bitwise_or.reduceat(parts, starts)


def iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value) triples.

    value is an int for varint/fixed32/fixed64 (raw bits for the fixed
    types) and a memoryview for length-delimited fields.
    """
    view = memoryview(buf)
    i = 0
    n = len(buf)
    while i < n:
        key, i = _read_varint(buf, i)
        fno, wt = key >> 3, key & 7
        if wt == 0:
            val, i = _read_varint(buf, i)
        elif wt == 1:
            val = int.from_bytes(view[i:i + 8], "little")
            i += 8
        elif wt == 2:
            ln, i = _read_varint(buf, i)
            val = view[i:i + ln]
            i += ln
        elif wt == 5:
            val = int.from_bytes(view[i:i + 4], "little")
            i += 4
        else:  # groups (3/4) do not occur in this schema
            raise ValueError(f"unsupported wire type {wt}")
        yield fno, wt, val


def _as_double(wt, val):
    if wt == 1:
        return struct.unpack("<d", int(val).to_bytes(8, "little"))[0]
    raise ValueError("expected fixed64 double")


def _as_float(wt, val):
    if wt == 5:
        return struct.unpack("<f", int(val).to_bytes(4, "little"))[0]
    raise ValueError("expected fixed32 float")


# ---------------------------------------------------------------------------
# declarative message decoding

class Msg:
    """Decoded message: attribute access with schema defaults."""

    def __init__(self, schema: dict, buf: bytes):
        self._schema = schema
        for name, kind, *_ in schema.values():
            if kind.startswith("r"):  # repeated
                setattr(self, name, [])
            elif kind == "msg":
                pass  # absent sub-messages default via __getattr__
            elif kind in ("bytes", "string"):
                setattr(self, name, b"" if kind == "bytes" else "")
            else:
                setattr(self, name, 0)
        for fno, wt, val in iter_fields(buf):
            spec = schema.get(fno)
            if spec is None:
                continue
            name, kind = spec[0], spec[1]
            if kind == "varint":
                setattr(self, name, val)
            elif kind == "double":
                setattr(self, name, _as_double(wt, val))
            elif kind == "float":
                setattr(self, name, _as_float(wt, val))
            elif kind == "bytes":
                setattr(self, name, bytes(val))
            elif kind == "string":
                setattr(self, name, bytes(val).decode("utf-8"))
            elif kind == "msg":
                setattr(self, name, Msg(spec[2], bytes(val)))
            elif kind == "rmsg":
                getattr(self, name).append(Msg(spec[2], bytes(val)))
            elif kind == "rdouble":
                tgt = getattr(self, name)
                if wt == 2:  # packed
                    tgt.extend(np.frombuffer(val, "<f8").tolist())
                else:
                    tgt.append(_as_double(wt, val))
            elif kind == "rfloat":
                tgt = getattr(self, name)
                if wt == 2:
                    tgt.extend(np.frombuffer(val, "<f4").tolist())
                else:
                    tgt.append(_as_float(wt, val))
            elif kind == "rint32":
                tgt = getattr(self, name)
                if wt == 2:
                    tgt.extend(_packed_varints(val).tolist())
                else:
                    tgt.append(val)
            else:
                raise ValueError(f"unknown kind {kind}")

    # default-constructed empty sub-message on access of an absent one
    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        for fname, kind, *rest in self.__dict__.get("_schema", {}).values():
            if fname == name and kind == "msg":
                return Msg(rest[0], b"")
        raise AttributeError(name)


# ---------------------------------------------------------------------------
# Waymo schemas (field numbers from the public dataset.proto / label.proto)

TRANSFORM = {1: ("transform", "rdouble")}

MATRIX_SHAPE = {1: ("dims", "rint32")}
MATRIX_FLOAT = {1: ("data", "rfloat"), 2: ("shape", "msg", MATRIX_SHAPE)}
MATRIX_INT32 = {1: ("data", "rint32"), 2: ("shape", "msg", MATRIX_SHAPE)}

CAMERA_CALIBRATION = {
    1: ("name", "varint"),
    2: ("intrinsic", "rdouble"),     # fx fy cx cy k1 k2 p1 p2 k3
    3: ("extrinsic", "msg", TRANSFORM),
    4: ("width", "varint"),
    5: ("height", "varint"),
}

LASER_CALIBRATION = {
    1: ("name", "varint"),
    2: ("beam_inclinations", "rdouble"),
    3: ("beam_inclination_min", "double"),
    4: ("beam_inclination_max", "double"),
    5: ("extrinsic", "msg", TRANSFORM),
}

CONTEXT = {
    1: ("name", "string"),
    2: ("camera_calibrations", "rmsg", CAMERA_CALIBRATION),
    3: ("laser_calibrations", "rmsg", LASER_CALIBRATION),
}

CAMERA_IMAGE = {
    1: ("name", "varint"),
    2: ("image", "bytes"),           # JPEG
    3: ("pose", "msg", TRANSFORM),
    5: ("pose_timestamp", "double"),
}

RANGE_IMAGE = {
    2: ("range_image_compressed", "bytes"),
    3: ("camera_projection_compressed", "bytes"),
    4: ("range_image_pose_compressed", "bytes"),
}

LASER = {
    1: ("name", "varint"),
    2: ("ri_return1", "msg", RANGE_IMAGE),
    3: ("ri_return2", "msg", RANGE_IMAGE),
}

LABEL_BOX = {
    1: ("center_x", "double"),
    2: ("center_y", "double"),
    3: ("center_z", "double"),
    4: ("width", "double"),
    5: ("length", "double"),
    6: ("height", "double"),
    7: ("heading", "double"),
}

LABEL_METADATA = {
    1: ("speed_x", "double"),
    2: ("speed_y", "double"),
    3: ("accel_x", "double"),
    4: ("accel_y", "double"),
}

LABEL = {
    1: ("box", "msg", LABEL_BOX),
    2: ("metadata", "msg", LABEL_METADATA),
    3: ("type", "varint"),
    4: ("id", "string"),
}

FRAME = {
    1: ("context", "msg", CONTEXT),
    2: ("timestamp_micros", "varint"),
    3: ("pose", "msg", TRANSFORM),
    4: ("images", "rmsg", CAMERA_IMAGE),
    5: ("lasers", "rmsg", LASER),
    6: ("laser_labels", "rmsg", LABEL),
}

# enum values (dataset.proto)
CAMERA_FRONT, CAMERA_FRONT_LEFT, CAMERA_FRONT_RIGHT = 1, 2, 3
CAMERA_SIDE_LEFT, CAMERA_SIDE_RIGHT = 4, 5
CAMERA_NAMES = {1: "FRONT", 2: "FRONT_LEFT", 3: "FRONT_RIGHT",
                4: "SIDE_LEFT", 5: "SIDE_RIGHT"}
LASER_NAMES = {1: "TOP", 2: "FRONT", 3: "SIDE_LEFT", 4: "SIDE_RIGHT",
               5: "REAR"}
LASER_TOP = 1
# label.proto Label.Type
TYPE_VEHICLE, TYPE_PEDESTRIAN, TYPE_SIGN, TYPE_CYCLIST = 1, 2, 3, 4
LABEL_CLASS = {1: "vehicle", 2: "pedestrian", 3: "sign", 4: "cyclist"}


def parse_frame(payload: bytes) -> Msg:
    """Decode one TFRecord payload into a Frame message."""
    return Msg(FRAME, payload)


def get_by_name(items, name):
    """First entry whose .name matches (reference `utils.get`)."""
    for it in items:
        if it.name == name:
            return it
    raise KeyError(name)


def decode_matrix_float(compressed: bytes) -> np.ndarray:
    m = Msg(MATRIX_FLOAT, zlib.decompress(compressed))
    return np.asarray(m.data, np.float32).reshape(m.shape.dims)


def decode_matrix_int32(compressed: bytes) -> np.ndarray:
    m = Msg(MATRIX_INT32, zlib.decompress(compressed))
    # varints store negative int32 as 64-bit two's complement (10 bytes);
    # fold back to signed before handing to numpy
    data = np.asarray(m.data, np.uint64).astype(np.int64)
    return data.astype(np.int32).reshape(m.shape.dims)


# ---------------------------------------------------------------------------
# range image -> vehicle-frame pointcloud (reference utils.py:262-341)


def range_image_to_pointcloud(ri: np.ndarray, calibration) -> tuple[
        np.ndarray, np.ndarray]:
    """Spherical range image [H, W, C] -> (points [M, 3] vehicle frame,
    attrs [M, C]); row 0 is the highest beam (inclinations flipped)."""
    h, w = ri.shape[:2]
    if len(calibration.beam_inclinations) > 0:
        inclination = np.asarray(calibration.beam_inclinations)
    else:
        inclination = np.linspace(calibration.beam_inclination_min,
                                  calibration.beam_inclination_max, h)
    inclination = inclination[::-1]

    extrinsic = np.array(calibration.extrinsic.transform).reshape(4, 4)
    az_correction = np.arctan2(extrinsic[1, 0], extrinsic[0, 0])
    azimuth = np.linspace(np.pi, -np.pi, w) - az_correction

    rng = ri[:, :, 0]
    cos_az, sin_az = np.cos(azimuth)[None, :], np.sin(azimuth)[None, :]
    cos_in, sin_in = np.cos(inclination)[:, None], np.sin(
        inclination)[:, None]
    x = cos_az * cos_in * rng
    y = sin_az * cos_in * rng
    z = sin_in * rng
    pts = np.stack([x, y, z, np.ones_like(z)], axis=-1) @ extrinsic.T
    mask = rng > 0
    return pts[mask][:, :3], ri[mask]
