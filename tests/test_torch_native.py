"""The port's host library (`data/native.py`, `csrc/host/`) and protobuf
decoder (`data/waymo_proto.py`) against the JAX package's
(`gaussianrpg_tpu/data/native.py`, `data/waymo_proto.py`): the same
TFRecord records, PLY arrays, decoded frames and point clouds."""
import os
import zlib

import numpy as np
import pytest

from gaussianrpg_tpu.data import native as jn
from gaussianrpg_tpu.data import waymo_proto as jwp

from gaussianrpg_tpu_torch.data import native as tn
from gaussianrpg_tpu_torch.data import waymo_proto as twp
from gaussianrpg_tpu_torch.utils import waymo_record as wr

from .test_waymo_converter import (enc_matrix_float, enc_matrix_int32,
                                   f_packed_varints, make_frame,
                                   write_tfrecord)
from .torch_parity import one_cpu_thread  # noqa: F401

needs_jax_lib = pytest.mark.skipif(jn.load_library() is None,
                                   reason="the JAX package's native library "
                                   "is unavailable")


def test_host_library_builds_into_the_kernel_directory():
    """Built by the host compiler into build/kernels, named by the hash of
    its sources; loading twice gives the same library."""
    lib = tn.load_library()
    path = tn.library_path()
    assert path.exists() and path.parent.name == "kernels"
    assert path.name.startswith("libgaussianrpg_native_")
    assert tn.load_library() is lib
    assert hasattr(lib, "grpg_jpeg_scan")


def test_failed_build_raises_with_the_compiler_output(tmp_path,
                                                      monkeypatch):
    """No fallback: a source that does not compile raises, naming the
    compiler's complaint."""
    host = tmp_path / "host"
    host.mkdir()
    (host / "broken.cc").write_text("this is not C++;\n")
    monkeypatch.setattr(tn, "HOST_SRC", host)
    monkeypatch.setenv("GRPG_TORCH_BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="host library failed.*broken"):
        tn.build()
    assert not list((tmp_path / "build").glob("*.so"))


@needs_jax_lib
@pytest.mark.parametrize("n_records", [0, 1, 5])
def test_tfrecord_records_match_jax(tmp_path, n_records):
    rng = np.random.default_rng(n_records)
    payloads = [rng.integers(0, 256, int(rng.integers(0, 3000)),
                             dtype=np.uint8).tobytes()
                for _ in range(n_records)]
    payloads += [make_frame(i) for i in range(2)]
    path = str(tmp_path / "r.tfrecord")
    write_tfrecord(path, payloads)
    a, b = jn.TFRecordFile(path), tn.TFRecordFile(path)
    assert len(a) == len(b) == len(payloads)
    assert list(a) == list(b) == payloads
    with pytest.raises(IndexError):
        b.record(len(payloads))
    a.close()
    b.close()


def test_tfrecord_missing_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        tn.TFRecordFile(str(tmp_path / "absent.tfrecord"))


def _write_ply(path, elements):
    """Binary little-endian PLY of all-float elements {name: [n, k]}."""
    head = ["ply", "format binary_little_endian 1.0"]
    for name, arr in elements.items():
        head.append(f"element {name} {arr.shape[0]}")
        head += [f"property float p{i}" for i in range(arr.shape[1])]
    head.append("end_header")
    with open(path, "wb") as f:
        f.write(("\n".join(head) + "\n").encode())
        for arr in elements.values():
            f.write(np.asarray(arr, "<f4").tobytes())


@needs_jax_lib
@pytest.mark.parametrize("element", ["", "vertex", "second"])
def test_ply_load_f32_matches_jax(tmp_path, element):
    rng = np.random.default_rng(3)
    path = str(tmp_path / "p.ply")
    _write_ply(path, {"vertex": rng.standard_normal((257, 14)),
                      "second": rng.standard_normal((31, 5))})
    a = jn.ply_load_f32(path, element)
    b = tn.ply_load_f32(path, element)
    assert b.dtype == np.float32 and b.shape == a.shape
    np.testing.assert_array_equal(a, b)


def test_ply_load_f32_rejects_non_float(tmp_path):
    path = str(tmp_path / "d.ply")
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\nelement vertex 1\n"
                b"property double x\nend_header\n" + b"\0" * 8)
    with pytest.raises(IOError, match="header"):
        tn.ply_load_f32(path)


def _fields(msg):
    """A decoded message as nested python values."""
    if isinstance(msg, list):
        return [_fields(m) for m in msg]
    if hasattr(msg, "_schema"):
        return {name: _fields(getattr(msg, name))
                for name, *_ in msg._schema.values()}
    return msg


@pytest.mark.parametrize("frame_id", [0, 3])
def test_parse_frame_matches_jax(frame_id):
    payload = make_frame(frame_id)
    assert _fields(twp.parse_frame(payload)) == _fields(
        jwp.parse_frame(payload))


def _street_payload():
    cam = wr.Camera(1, 64, 48, 50.0, 50.0, 32.0, 24.0, wr.yaw_pose(0.0))
    laser = wr.Laser(1, 16, 90, -0.3, 0.05, wr.yaw_pose(0.2, (1.4, 0, 0.5)))
    box = wr.Box("car", (9.0, 0.5, -0.7), (4.5, 2.0, 1.6), 0.1, (2.0, 0.0))
    return wr.street_frame(name="seg", timestamp=1.5, ego_pose=np.eye(4),
                           cameras=[cam], jpegs={1: b"\xff\xd8\xff\xd9"},
                           lasers=[laser], street=(2, 40, -10, 10),
                           ground_z=-1.5, boxes=[box])


@pytest.mark.parametrize("payload", ["make_frame", "street"])
def test_range_image_to_pointcloud_matches_jax(payload):
    data = make_frame(1) if payload == "make_frame" else _street_payload()
    out = []
    for wp in (jwp, twp):
        frame = wp.parse_frame(data)
        laser = frame.lasers[0]
        ri = wp.decode_matrix_float(laser.ri_return1.range_image_compressed)
        cp = wp.decode_matrix_int32(
            laser.ri_return1.camera_projection_compressed)
        pts, attrs = wp.range_image_to_pointcloud(
            ri, wp.get_by_name(frame.context.laser_calibrations,
                               laser.name))
        out.append((ri, cp, pts, attrs))
    for a, b in zip(*out):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert out[1][2].shape[0] > 0


@pytest.mark.parametrize("values", [[-5, 7], [-(2 ** 31), 2 ** 31 - 1, 0, -1],
                                    list(range(-300, 300, 7))])
def test_negative_int32_varint_matches_jax(values):
    arr = np.array([values], np.int64)
    blob = zlib.compress(enc_matrix_int32(arr))
    got = twp.decode_matrix_int32(blob)
    np.testing.assert_array_equal(got, jwp.decode_matrix_int32(blob))
    assert got.tolist() == [values]


def test_record_encoders_match_the_test_encoders():
    """`utils/waymo_record`'s vectorised packed varints write the bytes of
    the JAX tests' encoder (`tests/test_waymo_converter.py`)."""
    rng = np.random.default_rng(0)
    vals = np.concatenate([rng.integers(-2 ** 31, 2 ** 31, 500),
                           [0, 1, 127, 128, 16383, 16384, -1]])
    assert wr.f_packed_varints(1, vals) == f_packed_varints(1, vals)
    arr = rng.standard_normal((4, 5, 3))
    assert wr.enc_matrix_float(arr) == enc_matrix_float(arr)
    assert wr.enc_matrix_int32(vals.reshape(1, -1)) == enc_matrix_int32(
        vals.reshape(1, -1))


def test_street_lidar_returns_lie_on_the_street_and_boxes():
    """The fixture's LiDAR: every return's point (as the converter
    computes it) lies on the ground plane inside the street, or on a box's
    surface; its camera projections land inside the image."""
    frame = twp.parse_frame(_street_payload())
    laser = frame.lasers[0]
    ri = twp.decode_matrix_float(laser.ri_return1.range_image_compressed)
    cp = twp.decode_matrix_int32(
        laser.ri_return1.camera_projection_compressed)
    pts, _ = twp.range_image_to_pointcloud(
        ri, frame.context.laser_calibrations[0])
    ground = np.abs(pts[:, 2] + 1.5) < 1e-3
    assert ground.sum() > 100 and (~ground).sum() > 5
    assert (pts[ground, 0] >= 2 - 1e-3).all() and (
        pts[ground, 0] <= 40 + 1e-3).all()
    c, s = np.cos(-0.1), np.sin(-0.1)
    local = (pts[~ground] - [9.0, 0.5, -0.7]) @ np.array(
        [[c, -s, 0], [s, c, 0], [0, 0, 1]]).T
    assert (np.abs(local) <= np.array([2.25, 1.0, 0.8]) + 1e-3).all()
    proj = cp[ri[..., 0] > 0]
    seen = proj[:, 0] == 1
    assert seen.any() and (proj[seen, 1] < 64).all() and (
        proj[seen, 2] < 48).all() and (proj[seen, 1:3] >= 0).all()
    assert os.path.basename(tn.library_path()).endswith(".so")
