"""The port's data-preparation toolchain against the JAX package's: the
Waymo converter (every file byte-equal, `pointcloud.npz`'s arrays equal)
on a TFRecord with real JPEG bytes (`utils/waymo_record`), the LiDAR-depth
and sky-mask generators, KITTI prep, the COLMAP convert and triangulation
apps (with a stub `colmap` binary), the monocular depth and normal apps
(one seeded TorchScript model); and the whole chain (TFRecord -> converter
-> LiDAR depth -> sky mask -> train -> render -> metrics) through the port
alone, the counterpart of `tests/test_toolchain.py::test_full_toolchain_chain`.
"""
import filecmp
import json
import os
import shutil
import sqlite3
import stat
import sys

import numpy as np
import pytest
import torch

PIL = pytest.importorskip("PIL")
from PIL import Image  # noqa: E402

from gaussianrpg_tpu.apps import colmap_convert as j_colmap_convert  # noqa
from gaussianrpg_tpu.apps import colmap_triangulate as j_tri  # noqa: E402
from gaussianrpg_tpu.apps import generate_lidar_depth as j_depth  # noqa
from gaussianrpg_tpu.apps import generate_mono_depth as j_mono  # noqa
from gaussianrpg_tpu.apps import generate_mono_normal as j_normal  # noqa
from gaussianrpg_tpu.apps import generate_sky_mask as j_sky  # noqa: E402
from gaussianrpg_tpu.apps import kitti_prep as j_kitti  # noqa: E402
from gaussianrpg_tpu.apps import waymo_converter as j_conv  # noqa: E402
from gaussianrpg_tpu.data.native import load_library  # noqa: E402

from gaussianrpg_tpu_torch.apps import \
    colmap_convert as t_colmap_convert  # noqa: E402
from gaussianrpg_tpu_torch.apps import colmap_triangulate as t_tri  # noqa
from gaussianrpg_tpu_torch.apps import generate_lidar_depth as t_depth  # noqa
from gaussianrpg_tpu_torch.apps import generate_mono_depth as t_mono  # noqa
from gaussianrpg_tpu_torch.apps import generate_mono_normal as t_normal  # noqa
from gaussianrpg_tpu_torch.apps import generate_sky_mask as t_sky  # noqa
from gaussianrpg_tpu_torch.apps import kitti_prep as t_kitti  # noqa: E402
from gaussianrpg_tpu_torch.apps import waymo_converter as t_conv  # noqa
from gaussianrpg_tpu_torch.data.image_io import (decode_jpeg,  # noqa: E402
                                                 encode_jpeg, read_image)
from gaussianrpg_tpu_torch.utils import waymo_record as wr  # noqa: E402

from .torch_parity import one_cpu_thread  # noqa: F401,E402

needs_jax_lib = pytest.mark.skipif(load_library() is None,
                                   reason="the JAX package's native library "
                                   "is unavailable")
QUIET = dict(log=lambda *_: None)
CAMERA_SIZES = {1: (96, 64), 2: (96, 64), 3: (96, 64), 4: (96, 48),
                5: (96, 48)}
CAMERA_YAW = {1: 0.0, 2: np.pi / 4, 3: -np.pi / 4, 4: np.pi / 2,
              5: -np.pi / 2}


def rig(sizes=CAMERA_SIZES, fx=80.0):
    """The five cameras (the FRONT one 1.5 m ahead of the vehicle origin,
    the others turned about it) and a TOP and a FRONT LiDAR."""
    cams = [wr.Camera(n, w, h, fx, fx, w / 2, h / 2,
                      wr.yaw_pose(CAMERA_YAW[n], (1.5, 0, 0)))
            for n, (w, h) in sizes.items()]
    lasers = [wr.Laser(1, 48, 361, -0.35, 0.05,
                       wr.yaw_pose(0.0, (1.4, 0.0, 0.5))),
              wr.Laser(2, 24, 90, -1.2, 0.4,
                       wr.yaw_pose(0.0, (3.8, 0.0, -0.8)), 20.0)]
    return cams, lasers


def street_image(h, w, f, cam):
    """A sky above a road, with a per-camera hue and a frame's shift."""
    y, x = np.mgrid[0:h, 0:w]
    sky = y < h * 0.45
    img = np.stack([np.where(sky, 120 + cam * 10, 70 + (x + 3 * f) % 40),
                    np.where(sky, 170, 75 + y % 23),
                    np.where(sky, 230, 80 + cam * 5)], -1)
    return img.astype(np.uint8)


def write_record(path, n_frames=3, sizes=CAMERA_SIZES, fx=80.0,
                 cameras_with_images=(1, 2, 3, 4, 5), quality=90):
    cams, lasers = rig(sizes, fx)
    payloads = []
    for f in range(n_frames):
        boxes = [wr.Box("lead", (12.0 + 0.2 * f, 0.3, -0.7),
                        (4.5, 2.0, 1.6), 0.05, (2.0, 0.0)),
                 wr.Box("parked", (20.0 - 2.0 * f, -4.0, -0.75),
                        (4.2, 1.8, 1.5)),
                 wr.Box("walker", (9.0, 3.0 - 0.4 * f, -0.6),
                        (0.6, 0.6, 1.8), 1.0, (0.0, -1.5), kind=2)]
        jpegs = {c.name: encode_jpeg(street_image(c.height, c.width, f,
                                                  c.name), quality)
                 for c in cams if c.name in cameras_with_images}
        payloads.append(wr.street_frame(
            name="segment-synthetic", timestamp=1.6e9 + 0.1 * f,
            ego_pose=wr.yaw_pose(0.02 * f, (2.0 * f, 0.1 * f, 0.0)),
            cameras=cams, jpegs=jpegs, lasers=lasers,
            street=(2.0, 60.0, -12.0, 12.0), ground_z=-1.5, boxes=boxes))
    wr.write_tfrecord(path, payloads)
    return path


def assert_same_tree(a, b):
    """Every file under `a` is under `b` with the same bytes (npz: the same
    arrays of the same dicts)."""
    names = []
    for root, dirs, files in os.walk(a):
        for f in files:
            pa = os.path.join(root, f)
            rel = os.path.relpath(pa, a)
            pb = os.path.join(b, rel)
            names.append(rel)
            assert os.path.exists(pb), rel
            if f.endswith(".npz"):
                na = np.load(pa, allow_pickle=True)
                nb = np.load(pb, allow_pickle=True)
                assert na.files == nb.files
                for k in na.files:
                    da, db = na[k].item(), nb[k].item()
                    assert list(da) == list(db), (rel, k)
                    for key in da:
                        assert da[key].dtype == db[key].dtype
                        np.testing.assert_array_equal(da[key], db[key])
            elif f.endswith(".npy"):
                da = np.load(pa, allow_pickle=True)
                db = np.load(pb, allow_pickle=True)
                if da.dtype == object:
                    da, db = da.item(), db.item()
                    assert list(da) == list(db)
                    for key in da:
                        np.testing.assert_array_equal(da[key], db[key])
                else:
                    np.testing.assert_array_equal(da, db)
            else:
                assert filecmp.cmp(pa, pb, shallow=False), rel
    got = sorted(os.path.relpath(os.path.join(r, f), b)
                 for r, _, fs in os.walk(b) for f in fs)
    assert sorted(names) == got
    return names


@pytest.fixture(scope="module")
def record(tmp_path_factory):
    return write_record(str(tmp_path_factory.mktemp("rec") / "seg.tfrecord"))


@pytest.fixture(scope="module")
def converted(record, tmp_path_factory):
    """The record converted by both converters: (JAX dir, port dir)."""
    root = tmp_path_factory.mktemp("conv")
    j, t = str(root / "jax"), str(root / "port")
    assert j_conv.convert_sequence(record, j, **QUIET) == \
        t_conv.convert_sequence(record, t, **QUIET)
    return j, t


@needs_jax_lib
def test_converter_output_is_byte_equal(converted):
    names = assert_same_tree(*converted)
    assert sum(n.startswith("images") for n in names) == 15
    assert sum(n.startswith("dynamic_mask") for n in names) == 15
    port = converted[1]
    with open(os.path.join(port, "track", "track_info.txt")) as f:
        rows = f.read().splitlines()
    assert rows[0].startswith("frame_id track_id object_class")
    assert len(rows) == 1 + 3 * 3
    npz = np.load(os.path.join(port, "pointcloud.npz"), allow_pickle=True)
    assert all(v.shape[0] > 100 for v in npz["pointcloud"].item().values())
    masks = [read_image(os.path.join(port, "dynamic_mask", f))
             for f in sorted(os.listdir(os.path.join(port, "dynamic_mask")))]
    assert any(m.any() for m in masks)            # the moving boxes
    img = read_image(os.path.join(port, "images", "000001_3.jpg"))
    assert img.shape == (48, 96, 3)


@needs_jax_lib
@pytest.mark.parametrize("processes,start,end", [
    (["pose", "calib", "image"], 1, None),
    (["lidar", "track"], None, 1),
    (["dynamic_mask"], 2, 2)])
def test_converter_cli_subsets_are_byte_equal(record, tmp_path, processes,
                                              start, end, capsys):
    j, t = str(tmp_path / "jax"), str(tmp_path / "port")
    j_conv.convert_sequence(record, j, tuple(processes), start, end, **QUIET)
    args = ["--tfrecord", record, "--out", t, "--process_list", *processes]
    args += ["--start_idx", str(start)] if start is not None else []
    args += ["--end_idx", str(end)] if end is not None else []
    t_conv.main(args)
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["frames"] == (end if end is not None else 2) - (
        start or 0) + 1
    assert_same_tree(j, t)


@needs_jax_lib
def test_lidar_depth_and_sky_masks_match_jax(converted, tmp_path):
    dirs = []
    for src, depth, sky in ((converted[0], j_depth, j_sky),
                            (converted[1], t_depth, t_sky)):
        d = str(tmp_path / os.path.basename(src))
        shutil.copytree(src, d)
        assert depth.generate_lidar_depth(d, **QUIET) == 15
        assert sky.generate_sky_mask(d, **QUIET) == 15
        dirs.append(d)
    for sub in ("lidar_depth", "sky_mask"):
        assert_same_tree(os.path.join(dirs[0], sub),
                         os.path.join(dirs[1], sub))
    d = np.load(os.path.join(dirs[1], "lidar_depth", "000000_0.npy"),
                allow_pickle=True).item()
    assert d["mask"].shape == (64, 96) and d["mask"].sum() > 20
    assert (d["value"] > 0).all()
    sky = read_image(os.path.join(dirs[1], "sky_mask", "000000_0.png"))
    assert sky[0].all() and not sky[-1].any()


def _annotations(root):
    """KITTI-STEP annotation PNGs (label in R) in two sequences, one of
    them grey and one palette, every label of the table and a few
    others."""
    rng = np.random.default_rng(0)
    labels = np.array(list(range(19)) + [255, 30, 77], np.uint8)
    for seq, kind in (("0000", "rgb"), ("0001", "grey"), ("0001", "p")):
        os.makedirs(os.path.join(root, seq), exist_ok=True)
        lab = labels[rng.integers(0, len(labels), (37, 53))]
        if kind == "rgb":
            arr = np.stack([lab, rng.integers(0, 256, lab.shape),
                            rng.integers(0, 256, lab.shape)], -1)
            img = Image.fromarray(arr.astype(np.uint8))
        elif kind == "grey":
            img = Image.fromarray(lab)
        else:
            img = Image.fromarray(lab, "P")
            img.putpalette(list(range(256)) * 3)
        img.save(os.path.join(root, seq, f"{kind}.png"))


@pytest.mark.parametrize("mode", ["dynamic", "semantic", "sky"])
def test_kitti_prep_matches_jax(tmp_path, mode, capsys):
    ann = str(tmp_path / "ann")
    _annotations(ann)
    j_kitti.main([mode, "--annotation-path", ann, "--output-path",
                  str(tmp_path / "jax")])
    t_kitti.main([mode, "--annotation-path", ann, "--output-path",
                  str(tmp_path / "port")])
    assert capsys.readouterr().out.count("wrote 3 masks") == 2
    for rel in ("0000/rgb.png", "0001/grey.png", "0001/p.png"):
        with Image.open(tmp_path / "jax" / rel) as a, \
                Image.open(tmp_path / "port" / rel) as b:
            assert a.mode == b.mode
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _stub_colmap(tmp_path, log):
    """A `colmap` binary that logs its commands, makes the mapper's and
    the undistorter's outputs, and a feature database with one camera a
    folder."""
    stub = tmp_path / "bin" / "colmap"
    stub.parent.mkdir()
    stub.write_text(f"""#!{sys.executable}
import os, shutil, sqlite3, sys
cmd, args = sys.argv[1], sys.argv[2:]
opt = {{args[i]: args[i + 1] for i in range(len(args) - 1)
       if args[i].startswith("--")}}
with open({str(log)!r}, "a") as f:
    f.write(cmd + "\\n")
if cmd == "mapper":
    os.makedirs(os.path.join(opt["--output_path"], "0"), exist_ok=True)
if cmd == "image_undistorter":
    out = opt["--output_path"]
    os.makedirs(os.path.join(out, "sparse"), exist_ok=True)
    for n in ("cameras.bin", "images.bin", "points3D.bin"):
        open(os.path.join(out, "sparse", n), "w").close()
    shutil.copytree(opt["--image_path"], os.path.join(out, "images"))
if cmd == "feature_extractor" and "--ImageReader.mask_path" in opt:
    db = sqlite3.connect(opt["--database_path"])
    db.execute("CREATE TABLE cameras (camera_id INTEGER, params BLOB)")
    db.execute("CREATE TABLE images (image_id INTEGER, name TEXT, "
               "camera_id INTEGER)")
    root = opt["--image_path"]
    for cid, folder in enumerate(sorted(os.listdir(root)), start=1):
        db.execute("INSERT INTO cameras VALUES (?, ?)", (cid, b""))
        for name in sorted(os.listdir(os.path.join(root, folder))):
            db.execute("INSERT INTO images (image_id, name, camera_id) "
                       "VALUES ((SELECT COUNT(*) FROM images) + 1, ?, ?)",
                       (folder + "/" + name, cid))
    db.commit()
if cmd == "point_triangulator":
    os.makedirs(opt["--output_path"], exist_ok=True)
    open(os.path.join(opt["--output_path"], "points3D.txt"), "w").close()
""")
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    return stub


def test_colmap_convert_matches_jax(tmp_path):
    """The command sequence, the model under sparse/0 and the LANCZOS
    downscales, pixel for pixel: PNG, and JPEG (quality 75, 4:2:0: the
    port's encoder writes the coefficients libjpeg writes, so Pillow's
    file and the port's decode alike)."""
    rng = np.random.default_rng(1)
    stub = _stub_colmap(tmp_path, tmp_path / "calls.log")
    y, x = np.mgrid[0:44, 0:60]
    smooth = np.stack([2 * x + 40, 3 * y + 20, x + y + 60], -1)
    noise = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
    outs = []
    for name, app in (("jax", j_colmap_convert), ("port", t_colmap_convert)):
        src = tmp_path / name
        os.makedirs(src / "input")
        Image.fromarray(noise).save(str(src / "input" / "a.png"))
        Image.fromarray(smooth.astype(np.uint8)).save(
            str(src / "input" / "b.jpg"), quality=95)
        app.convert(str(src), colmap_executable=str(stub), use_gpu=False,
                    resize=True)
        outs.append(src)
    calls = (tmp_path / "calls.log").read_text().split()
    assert calls == ["feature_extractor", "exhaustive_matcher", "mapper",
                     "image_undistorter"] * 2
    for f in (2, 4, 8):
        for name in ("a.png", "b.jpg"):
            with Image.open(outs[0] / f"images_{f}" / name) as a, \
                    Image.open(outs[1] / f"images_{f}" / name) as b:
                assert a.size == b.size and a.format == b.format
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert sorted(os.listdir(outs[1] / "sparse" / "0")) == [
        "cameras.bin", "images.bin", "points3D.bin"]


@needs_jax_lib
def test_colmap_triangulate_matches_jax(converted, tmp_path, monkeypatch):
    _stub_colmap(tmp_path, tmp_path / "calls.log")
    monkeypatch.setenv("PATH", str(tmp_path / "bin") + os.pathsep
                       + os.environ["PATH"])
    models = []
    for src, app, name in ((converted[0], j_tri, "jax"),
                           (converted[1], t_tri, "port")):
        scene = str(tmp_path / f"scene_{name}")
        shutil.copytree(src, scene)
        # a colour dynamic mask, for `convert("L")`
        Image.fromarray(np.stack([read_image(os.path.join(
            scene, "dynamic_mask", "000001_1.png"))] * 3, -1)
            // np.array([1, 2, 3], np.uint8)).save(
            os.path.join(scene, "dynamic_mask", "000001_1.png"))
        work = str(tmp_path / f"work_{name}")
        out = app.run_triangulation(scene, work, cameras=(0, 1),
                                    rig_ba=True)
        assert os.path.isdir(out)
        models.append(os.path.join(work, "colmap"))
    a, b = models
    for rel in ("created/sparse/model/cameras.txt",
                "created/sparse/model/points3D.txt"):
        assert filecmp.cmp(os.path.join(a, rel), os.path.join(b, rel),
                           shallow=False)
    la = open(os.path.join(a, "created/sparse/model/images.txt")).read()
    lb = open(os.path.join(b, "created/sparse/model/images.txt")).read()
    rows_a = [r.split() for r in la.splitlines() if r]
    rows_b = [r.split() for r in lb.splitlines() if r]
    assert len(rows_a) == len(rows_b) == 6      # frames 0-2 x cams 0, 1
    for ra, rb in zip(rows_a, rows_b):
        assert (ra[0], ra[8], ra[9]) == (rb[0], rb[8], rb[9])
        np.testing.assert_allclose(np.float64(rb[1:8]), np.float64(ra[1:8]),
                                   rtol=0, atol=1e-6)
    ra = json.load(open(os.path.join(a, "cam_rigid_config.json")))
    rb = json.load(open(os.path.join(b, "cam_rigid_config.json")))
    for ca, cb in zip(ra[0]["cameras"], rb[0]["cameras"]):
        assert ca["camera_id"] == cb["camera_id"]
        np.testing.assert_allclose(cb["cam_from_rig_rotation"],
                                   ca["cam_from_rig_rotation"], atol=1e-6)
        np.testing.assert_allclose(cb["cam_from_rig_translation"],
                                   ca["cam_from_rig_translation"], atol=1e-9)
    for root, _, files in os.walk(os.path.join(a, "mask")):
        for f in files:
            pa = os.path.join(root, f)
            pb = pa.replace(a, b)
            with Image.open(pa) as ia, Image.open(pb) as ib:
                np.testing.assert_array_equal(np.asarray(ia),
                                              np.asarray(ib))
    assert len(os.listdir(os.path.join(b, "mask", "cam_1"))) == 3
    assert_same_tree(os.path.join(a, "train_imgs"),
                     os.path.join(b, "train_imgs"))
    dbs = [sqlite3.connect(os.path.join(m, "database.db")).execute(
        "SELECT camera_id, params FROM cameras ORDER BY camera_id"
    ).fetchall() for m in models]
    assert dbs[0] == dbs[1] and len(dbs[0]) == 2


class _Depth(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(3, 4, 3, padding=1)
        self.head = torch.nn.Conv2d(4, 1, 1)

    def forward(self, x):
        return torch.nn.functional.softplus(
            self.head(torch.tanh(self.conv(x))))[:, 0]


class _Normal(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(3, 3, 3, padding=1)

    def forward(self, x):
        return torch.tanh(self.conv(x))


def _torchscript(path, module):
    torch.manual_seed(0)
    torch.jit.script(module()).save(path)
    return path


@pytest.mark.parametrize("kind", ["depth", "normal"])
def test_mono_apps_match_jax(converted, tmp_path, kind):
    """One seeded TorchScript model in both apps: maps within 1e-6, their
    PNG visualisations equal; `--ignore-exists` skips the done ones."""
    weights = _torchscript(str(tmp_path / f"{kind}.ts"),
                           _Depth if kind == "depth" else _Normal)
    out_dirs = []
    for src, name in ((converted[0], "jax"), (converted[1], "port")):
        d = str(tmp_path / name)
        os.makedirs(os.path.join(d, "images"))
        for f in ("000000_0.jpg", "000002_3.jpg"):
            shutil.copy(os.path.join(src, "images", f),
                        os.path.join(d, "images", f))
        if kind == "depth":
            if name == "jax":
                n = j_mono.generate_mono_depth(d, weights, **QUIET)
            else:
                n = t_mono.generate_mono_depth(d, weights, device="cpu",
                                               **QUIET)
        else:
            app = j_normal if name == "jax" else t_normal
            kw = {} if name == "jax" else dict(device="cpu")
            n = app.generate_mono_normal(d, weights, **kw, **QUIET)
        assert n == 2
        out_dirs.append(os.path.join(d, f"mono_{kind}"))
    for f in sorted(os.listdir(out_dirs[0])):
        a, b = (os.path.join(o, f) for o in out_dirs)
        if f.endswith(".npy"):
            ga, gb = np.load(a), np.load(b)
            assert ga.shape == gb.shape and gb.dtype == np.float32
            np.testing.assert_allclose(gb, ga, rtol=0, atol=1e-6)
        else:
            with Image.open(a) as ia, Image.open(b) as ib:
                np.testing.assert_array_equal(np.asarray(ia),
                                              np.asarray(ib))
    shape = np.load(os.path.join(out_dirs[1], "000002_3.npy")).shape
    assert shape == ((48, 96) if kind == "depth" else (48, 96, 3))
    d = os.path.dirname(out_dirs[1])
    app = t_mono.generate_mono_depth if kind == "depth" else \
        t_normal.generate_mono_normal
    assert app(d, weights, ignore_exists=True, device="cpu", **QUIET) == 0


def test_mono_apps_need_cuda_unless_told_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    weights = _torchscript(str(tmp_path / "n.ts"), _Normal)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_normal.generate_mono_normal(str(tmp_path), weights, **QUIET)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_mono.generate_mono_depth(str(tmp_path), weights, **QUIET)
    with pytest.raises(RuntimeError, match="weights unavailable"):
        t_normal.generate_mono_normal(str(tmp_path), str(tmp_path / "none"),
                                      device="cpu", **QUIET)


@pytest.mark.parametrize("weights", [None, "missing.ts"])
def test_mono_depth_without_weights_raises(tmp_path, monkeypatch, weights):
    """No `--weights`, or a path that does not exist, raises before any
    download: `torch.hub` is never reached."""
    def no_hub(*a, **k):
        raise AssertionError("torch.hub reached")

    monkeypatch.setattr(torch.hub, "load", no_hub)
    path = weights and str(tmp_path / weights)
    with pytest.raises(FileNotFoundError, match="MiDaS weights"):
        t_mono.generate_mono_depth(str(tmp_path), path, device="cpu",
                                   **QUIET)
    with pytest.raises(SystemExit):
        t_mono.main([str(tmp_path), "--device", "cpu"])


CHAIN_ITERS = 12


def test_full_toolchain_chain_on_the_port(tmp_path, monkeypatch):
    """A TFRecord whose FRONT images are real JPEGs (640x480) -> the port's
    converter -> LiDAR depth and sky masks -> `apps.train` (12 steps at
    160x120) -> `apps.render` -> `apps.metrics`, every stage the port's,
    on the CPU."""
    from gaussianrpg_tpu_torch.apps import metrics as metrics_app
    from gaussianrpg_tpu_torch.apps import render as render_app
    from gaussianrpg_tpu_torch.apps import train as train_app

    monkeypatch.setattr(train_app, "_make_writer", lambda logdir: None)
    sizes = {n: (640, 480) if n == 1 else (160, 120) for n in CAMERA_SIZES}
    rec = write_record(str(tmp_path / "seq.tfrecord"), sizes=sizes,
                       fx=500.0, cameras_with_images=(1,), quality=95)
    src = str(tmp_path / "converted")
    assert t_conv.convert_sequence(rec, src, **QUIET) == {"frames": 3,
                                                          "objects": 3}
    assert t_depth.generate_lidar_depth(src, **QUIET) == 3
    assert t_sky.generate_sky_mask(src, **QUIET) == 3

    ws = str(tmp_path / "out")
    opts = ["source_path", src, "workspace", ws, "exp_name", "chain",
            "resolution", "4", "data.extent", "0",
            "data.selected_frames", "[0, 2]",
            "render.capacity", "131072", "render.save_video", "False",
            "optim.lambda_depth_lidar", "0.01",
            "optim.densify_from_iter", "2",
            "optim.densify_until_iter", "11",
            "optim.densification_interval", "6",
            "optim.opacity_reset_interval", "10",
            "optim.position_lr_max_steps", str(CHAIN_ITERS),
            "train.test_iterations", "[]",
            "train.checkpoint_iterations", f"[{CHAIN_ITERS}]",
            "train.save_iterations", f"[{CHAIN_ITERS}]"]
    dev = ["--device", "cpu"]
    state, rec_ = train_app.main(dev + ["--iterations", str(CHAIN_ITERS)]
                                 + opts)
    assert len(rec_["loss"]) == CHAIN_ITERS
    assert np.isfinite(rec_["loss"]).all()
    model_dir = os.path.join(ws, "street_gaussian", "chain")
    assert os.path.exists(os.path.join(
        model_dir, "trained_model", f"iteration_{CHAIN_ITERS}.npz"))
    assert os.path.exists(os.path.join(
        model_dir, "point_cloud", f"iteration_{CHAIN_ITERS}",
        "point_cloud.ply"))
    assert os.path.exists(os.path.join(src, "input_ply",
                                       "points3D_bkgd.ply"))

    render_app.main(dev + opts)
    eval_dir = os.path.join(model_dir, "evaluate_train")
    rgbs = sorted(f for f in os.listdir(eval_dir) if f.endswith("_rgb.png"))
    gts = sorted(f for f in os.listdir(eval_dir) if f.endswith("_gt.png"))
    assert len(rgbs) == 3 and len(gts) == 3
    im = read_image(os.path.join(eval_dir, rgbs[0]))
    assert im.shape == (120, 160, 3)
    gt = read_image(os.path.join(eval_dir, gts[0]))
    src_img = decode_jpeg(open(os.path.join(src, "images", "000000_0.jpg"),
                               "rb").read())
    assert src_img.shape == (480, 640, 3)
    assert np.abs(gt.astype(float) - src_img[::4, ::4]).mean() < 12

    metrics_app.main(dev + opts)
    with open(os.path.join(model_dir, "results_train.json")) as f:
        results = json.load(f)
    assert results["n_views"] == 3
    assert np.isfinite(results["psnr"]) and results["psnr"] > 5.0
    assert 0.0 <= results["ssim"] <= 1.0
