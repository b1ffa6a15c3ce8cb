"""ctypes bindings for the port's host library (`csrc/host/`).

Counterpart of `gaussianrpg_tpu/data/native.py`: the C++ TFRecord reader
(Waymo ingest) and the bulk binary-PLY f32 loader, from the port's own copy
of the JAX package's `native/gaussianrpg_native.cc`, and the entropy
decoder and inverse DCT of the port's baseline JPEG reader
(`csrc/host/jpeg_decode.cc`, called by `data/image_io.read_jpeg`).

The library is compiled with the host compiler (`c++`, or `$CXX`) at its
first use into the kernels' build directory (`ops/cuda_build.build_dir`,
`build/kernels` by default), named by a hash of its sources and flags as
the CUDA libraries are. There is no pure-Python fallback: a failed build
raises with the compiler's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

from ..ops.cuda_build import CSRC, build_dir

HOST_SRC = CSRC / "host"
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]

_LIB: Optional[ctypes.CDLL] = None


def _sources() -> list[Path]:
    return sorted(HOST_SRC.glob("*.cc"))


def library_path() -> Path:
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in _sources())
                            + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    return build_dir() / f"libgaussianrpg_native_{digest}.so"


def _compiler() -> str:
    cxx = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("no C++ compiler found (c++, g++ or $CXX) to "
                           "build the port's host library")
    return cxx


def build() -> Path:
    """Compile the host library unless it is built; returns its path."""
    target = library_path()
    if target.exists():
        return target
    target.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=target.parent)
    os.close(fd)
    cmd = [_compiler(), *CXX_FLAGS, "-o", tmp, *map(str, _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        Path(tmp).unlink(missing_ok=True)
        raise RuntimeError(f"building the host library failed "
                           f"({' '.join(cmd)}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, target)   # atomic: a concurrent build never sees half
    return target


def load_library() -> ctypes.CDLL:
    """The loaded host library, built on first use."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(str(build()))
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
    lib.tfrecord_index_open.restype = vp
    lib.tfrecord_index_open.argtypes = [ctypes.c_char_p]
    lib.tfrecord_index_count.restype = i64
    lib.tfrecord_index_count.argtypes = [vp]
    lib.tfrecord_record_length.restype = i64
    lib.tfrecord_record_length.argtypes = [vp, i64]
    lib.tfrecord_read_record.restype = i64
    lib.tfrecord_read_record.argtypes = [
        vp, ctypes.c_char_p, i64, ctypes.POINTER(ctypes.c_uint8)]
    lib.tfrecord_index_free.argtypes = [vp]
    lib.ply_load_f32.restype = ctypes.c_int
    lib.ply_load_f32.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float)]
    lib.grpg_jpeg_scan.restype = i64
    lib.grpg_jpeg_scan.argtypes = [vp, i64, i64, i32, vp, vp, vp, vp, i32,
                                   i32, i32, vp]
    _LIB = lib
    return _LIB


class TFRecordFile:
    """Indexed TFRecord reader (native framing parse; CRCs skipped like
    the reference's python reader)."""

    def __init__(self, path: str):
        self._lib = load_library()
        self._path = path.encode()
        self._h = self._lib.tfrecord_index_open(self._path)
        if not self._h:
            raise FileNotFoundError(path)

    def __len__(self) -> int:
        return int(self._lib.tfrecord_index_count(self._h))

    def record(self, i: int) -> bytes:
        n = int(self._lib.tfrecord_record_length(self._h, i))
        if n < 0:
            raise IndexError(i)
        buf = (ctypes.c_uint8 * n)()
        got = self._lib.tfrecord_read_record(self._h, self._path, i, buf)
        if got != n:
            raise IOError(f"short read on record {i}")
        return bytes(buf)

    def __iter__(self) -> Iterator[bytes]:
        for i in range(len(self)):
            yield self.record(i)

    def close(self):
        if self._h:
            self._lib.tfrecord_index_free(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


def ply_load_f32(path: str, element: str = "") -> np.ndarray:
    """Bulk-load an all-f32 binary PLY element as [count, n_props]
    (property order as in the header)."""
    lib = load_library()
    count = ctypes.c_int64()
    nprops = ctypes.c_int32()
    rc = lib.ply_load_f32(path.encode(), element.encode(),
                          ctypes.byref(count), ctypes.byref(nprops), None)
    if rc != 0:
        raise IOError(f"ply_load_f32 header parse failed rc={rc}")
    out = np.empty((count.value, nprops.value), np.float32)
    rc = lib.ply_load_f32(
        path.encode(), element.encode(), ctypes.byref(count),
        ctypes.byref(nprops),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc != 0:
        raise IOError(f"ply_load_f32 body read failed rc={rc}")
    return out
