"""Minimal PLY reader/writer (binary little-endian + ascii), numpy-only.

Replaces the reference's `plyfile` dependency for 3DGS point clouds:
`fetchPly`/`storePly` (`lib/datasets/base_readers.py`), per-model Gaussian
PLYs (`gaussian_model.py:80-155`) and the multi-element composite scene PLY
(`street_gaussian_model.py:94-117`, one `vertex_<model>` element per
sub-model).

A copy of `gaussianrpg_tpu/data/ply.py` (the port imports nothing of the
JAX package).
"""
from __future__ import annotations

import io
import os
from typing import Dict

import numpy as np

_PLY_DTYPES = {
    "char": "i1", "uchar": "u1", "short": "i2", "ushort": "u2",
    "int": "i4", "uint": "u4", "float": "f4", "double": "f8",
    "int8": "i1", "uint8": "u1", "int16": "i2", "uint16": "u2",
    "int32": "i4", "uint32": "u4", "float32": "f4", "float64": "f8",
}
_INV_DTYPES = {"i1": "char", "u1": "uchar", "i2": "short", "u2": "ushort",
               "i4": "int", "u4": "uint", "f4": "float", "f8": "double"}


def read_ply(path: str) -> Dict[str, np.ndarray]:
    """Read all elements: {element_name: structured array}."""
    with open(path, "rb") as f:
        header_lines = []
        while True:
            line = f.readline().decode("ascii").strip()
            header_lines.append(line)
            if line == "end_header":
                break
        fmt = None
        elements = []  # (name, count, [(prop, dtype)])
        for line in header_lines:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                elements.append((parts[1], int(parts[2]), []))
            elif parts[0] == "property":
                if parts[1] == "list":
                    raise NotImplementedError("list properties unsupported")
                elements[-1][2].append((parts[2], _PLY_DTYPES[parts[1]]))

        out = {}
        if fmt == "ascii":
            text = f.read().decode("ascii").split()
            pos = 0
            for name, count, props in elements:
                dt = np.dtype([(p, d) for p, d in props])
                n_val = count * len(props)
                vals = np.array(text[pos:pos + n_val])
                pos += n_val
                arr = np.zeros(count, dtype=dt)
                vals = vals.reshape(count, len(props))
                for i, (p, d) in enumerate(props):
                    arr[p] = vals[:, i].astype(d)
                out[name] = arr
        else:
            endian = "<" if "little" in fmt else ">"
            for name, count, props in elements:
                dt = np.dtype([(p, endian + d) for p, d in props])
                arr = np.frombuffer(f.read(dt.itemsize * count), dtype=dt)
                out[name] = arr
        return out


def write_ply(path: str, elements: Dict[str, np.ndarray],
              comments: list[str] | None = None):
    """Write structured arrays as binary little-endian PLY elements."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    header = io.StringIO()
    header.write("ply\nformat binary_little_endian 1.0\n")
    for c in comments or []:
        header.write(f"comment {c}\n")
    for name, arr in elements.items():
        header.write(f"element {name} {len(arr)}\n")
        for p in arr.dtype.names:
            base = arr.dtype[p].str.lstrip("<>|=")
            header.write(f"property {_INV_DTYPES[base]} {p}\n")
    header.write("end_header\n")
    with open(path, "wb") as f:
        f.write(header.getvalue().encode("ascii"))
        for arr in elements.values():
            f.write(arr.astype(
                np.dtype([(p, "<" + arr.dtype[p].str.lstrip("<>|=") )
                          for p in arr.dtype.names])).tobytes())


def fetch_pointcloud(path: str):
    """(points [N,3], colors [N,3] in 0..1, normals [N,3]) from a PLY with
    x/y/z[/red/green/blue][/nx/ny/nz]; `base_readers.fetchPly` analog."""
    elems = read_ply(path)
    v = next(iter(elems.values()))
    pts = np.stack([v["x"], v["y"], v["z"]], -1).astype(np.float32)
    names = v.dtype.names
    if "red" in names:
        cols = np.stack([v["red"], v["green"], v["blue"]], -1)
        cols = cols.astype(np.float32)
        if cols.max() > 1.0:
            cols = cols / 255.0
    else:
        cols = np.full_like(pts, 0.5)
    if "nx" in names:
        normals = np.stack([v["nx"], v["ny"], v["nz"]], -1).astype(np.float32)
    else:
        normals = np.zeros_like(pts)
    return pts, cols, normals


def store_pointcloud(path: str, points: np.ndarray, colors: np.ndarray):
    """Write an x/y/z/n*/rgb PLY (`base_readers.storePly` analog)."""
    n = points.shape[0]
    dt = np.dtype([(k, "f4") for k in
                   ("x", "y", "z", "nx", "ny", "nz")]
                  + [(k, "u1") for k in ("red", "green", "blue")])
    arr = np.zeros(n, dtype=dt)
    for i, k in enumerate(("x", "y", "z")):
        arr[k] = points[:, i]
    c255 = np.clip(colors * 255.0, 0, 255).astype(np.uint8)
    for i, k in enumerate(("red", "green", "blue")):
        arr[k] = c255[:, i]
    write_ply(path, {"vertex": arr})


def gaussian_to_struct(xyz, f_dc, f_rest, opacity, scaling, rotation,
                       semantic) -> np.ndarray:
    """Pack Gaussian params into the reference's PLY vertex layout
    (`gaussian_model.py:80-96,327-341`): f_dc/f_rest flattened
    channel-major (transpose(1,2).flatten)."""
    n = xyz.shape[0]
    f_dc_flat = np.transpose(f_dc, (0, 2, 1)).reshape(n, -1)
    f_rest_flat = np.transpose(f_rest, (0, 2, 1)).reshape(n, -1)
    fields = [("x", xyz[:, 0]), ("y", xyz[:, 1]), ("z", xyz[:, 2]),
              ("nx", np.zeros(n)), ("ny", np.zeros(n)),
              ("nz", np.zeros(n))]
    fields += [(f"f_dc_{i}", f_dc_flat[:, i])
               for i in range(f_dc_flat.shape[1])]
    fields += [(f"f_rest_{i}", f_rest_flat[:, i])
               for i in range(f_rest_flat.shape[1])]
    fields += [("opacity", opacity[:, 0])]
    fields += [(f"scale_{i}", scaling[:, i]) for i in range(scaling.shape[1])]
    fields += [(f"rot_{i}", rotation[:, i]) for i in range(rotation.shape[1])]
    fields += [(f"semantic_{i}", semantic[:, i])
               for i in range(semantic.shape[1])]
    arr = np.zeros(n, dtype=np.dtype([(k, "f4") for k, _ in fields]))
    for k, v in fields:
        arr[k] = v
    return arr


def struct_to_gaussian(v: np.ndarray, fourier_dim: int = 1):
    """Inverse of gaussian_to_struct (`gaussian_model.load_ply:104-155`)."""
    n = len(v)
    names = v.dtype.names
    xyz = np.stack([v["x"], v["y"], v["z"]], -1).astype(np.float32)
    get_seq = lambda pref: sorted(
        [p for p in names if p.startswith(pref)],
        key=lambda x: int(x.split("_")[-1]))
    dc_names = get_seq("f_dc_")
    rest_names = get_seq("f_rest_")
    f_dc = np.stack([v[p] for p in dc_names], -1).reshape(
        n, 3, -1).transpose(0, 2, 1).astype(np.float32)
    k_rest = len(rest_names) // 3
    if rest_names:
        f_rest = np.stack([v[p] for p in rest_names], -1).reshape(
            n, 3, k_rest).transpose(0, 2, 1).astype(np.float32)
    else:
        f_rest = np.zeros((n, 0, 3), np.float32)
    opacity = np.asarray(v["opacity"], np.float32)[:, None]
    scaling = np.stack([v[p] for p in get_seq("scale_")], -1).astype(
        np.float32)
    rotation = np.stack([v[p] for p in get_seq("rot_")], -1).astype(
        np.float32)
    sem_names = get_seq("semantic_")
    if sem_names:
        semantic = np.stack([v[p] for p in sem_names], -1).astype(np.float32)
    else:
        semantic = np.zeros((n, 1), np.float32)
    return dict(xyz=xyz, features_dc=f_dc, features_rest=f_rest,
                opacity=opacity, scaling=scaling, rotation=rotation,
                semantic=semantic)
