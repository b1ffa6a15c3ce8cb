"""The port's Blender / NeRF-synthetic reader (`data/blender.py`) against
the JAX package's (`gaussianrpg_tpu/data/blender.py`): cameras, images
composited over the background, seed points; and `read_png_rgba` against
Pillow's `Image.open(path).convert("RGBA")` on grey, grey+alpha, RGB,
RGBA and palette PNGs, with and without tRNS."""
import json
import os

import numpy as np
import pytest

PIL = pytest.importorskip("PIL")
from PIL import Image  # noqa: E402

from gaussianrpg_tpu.data.blender import \
    load_blender_scene as j_load  # noqa: E402

from gaussianrpg_tpu_torch.data.blender import \
    load_blender_scene as t_load  # noqa: E402
from gaussianrpg_tpu_torch.data.image_io import read_png_rgba  # noqa: E402

from .torch_parity import one_cpu_thread  # noqa: E402,F401


def _pil_images(rng, size=(9, 7)):
    """{name: PIL image} of every colour type, some with tRNS."""
    h, w = size
    rgba = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    rgb = rgba[..., :3].copy()
    grey = rgba[..., 0].copy()
    ims = {
        "rgba": Image.fromarray(rgba, "RGBA"),
        "rgb": Image.fromarray(rgb, "RGB"),
        "grey": Image.fromarray(grey, "L"),
        "grey_alpha": Image.fromarray(rgba[..., :2].copy(), "LA"),
    }
    pal = Image.fromarray((rgba[..., 0] % 6).astype(np.uint8), "P")
    pal.putpalette(rng.integers(0, 256, 18).tolist())
    ims["palette"] = pal
    big = Image.fromarray(rgba[..., 1].copy(), "P")
    big.putpalette(rng.integers(0, 256, 768).tolist())
    ims["palette_256"] = big
    return ims, rgb, grey


def _save_all(root, rng):
    """Write each image (and tRNS variants); returns {name: path}."""
    ims, rgb, grey = _pil_images(rng)
    paths = {}
    for name, im in ims.items():
        paths[name] = os.path.join(root, f"{name}.png")
        im.save(paths[name])
    extra = {
        "palette_trns": (ims["palette"], dict(transparency=bytes(
            [0, 128, 255, 7]))),
        "palette_one_trns": (ims["palette"], dict(transparency=2)),
        "grey_trns": (ims["grey"], dict(transparency=int(grey[0, 0]))),
        "rgb_trns": (ims["rgb"], dict(transparency=tuple(
            int(v) for v in rgb[1, 1]))),
    }
    for name, (im, kw) in extra.items():
        paths[name] = os.path.join(root, f"{name}.png")
        im.save(paths[name], **kw)
    return paths


def test_read_png_rgba_matches_pillow_convert(tmp_path):
    """Every colour type, with and without tRNS: bit for bit."""
    paths = _save_all(str(tmp_path), np.random.default_rng(0))
    for name, path in paths.items():
        with Image.open(path) as im:
            want = np.asarray(im.convert("RGBA"))
        got = read_png_rgba(path)
        assert got.dtype == np.uint8 and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    # the tRNS variants do take pixels out
    assert (read_png_rgba(paths["grey_trns"])[..., 3] == 0).any()
    assert (read_png_rgba(paths["rgb_trns"])[..., 3] == 0).any()


def _write_scene(root, kinds, size=8, test=False):
    """A Blender scene whose frame i is of colour type kinds[i] (camera
    on +z looking at the origin, an opaque square on a transparent
    ground where the type has alpha)."""
    rng = np.random.default_rng(1)
    for split in ("train", "test") if test else ("train",):
        os.makedirs(os.path.join(root, split), exist_ok=True)
        frames = []
        for i, kind in enumerate(kinds):
            c2w = np.eye(4)
            c2w[2, 3] = 4.0 + i
            c2w[0, 3] = 0.3 * i
            frames.append({"file_path": f"{split}/r_{i}",
                           "transform_matrix": c2w.tolist()})
            rgba = np.zeros((size, size, 4), np.uint8)
            rgba[2:6, 2:6] = (255, 128, 0, 255)
            rgba[6:, :, :3] = rng.integers(0, 256, (size - 6, size, 3))
            rgba[6:, :, 3] = 100
            path = os.path.join(root, f"{split}/r_{i}.png")
            if kind == "palette":
                im = Image.fromarray(rgba[..., 3] // 50, "P")
                im.putpalette([255, 0, 0, 0, 255, 0, 0, 0, 255, 9, 9, 9,
                               200, 100, 50, 1, 2, 3])
                im.save(path, transparency=bytes([0, 90, 255, 30, 255,
                                                  255]))
            else:
                mode = {"rgba": "RGBA", "rgb": "RGB", "grey": "L",
                        "grey_alpha": "LA"}[kind]
                arr = {"rgba": rgba, "rgb": rgba[..., :3],
                       "grey": rgba[..., 1],
                       "grey_alpha": rgba[..., [1, 3]]}[kind]
                Image.fromarray(np.ascontiguousarray(arr), mode).save(path)
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": 0.8, "frames": frames}, f)


KINDS = ["rgba", "rgb", "grey", "grey_alpha", "palette"]


@pytest.mark.parametrize("white", [False, True])
def test_blender_scene_matches_jax(tmp_path, white):
    """Every frame's image (each colour type, composited over black or
    white) equal to the JAX reader's; cameras equal within 1e-6; the
    random seed points equal."""
    root = str(tmp_path)
    _write_scene(root, KINDS, test=True)
    j = j_load(root, white_background=white, num_random_pts=500)
    t = t_load(root, white_background=white, num_random_pts=500,
               device="cpu")
    assert len(t.train) == len(j.train) == len(KINDS)
    assert len(t.test) == len(j.test) == len(KINDS)
    np.testing.assert_array_equal(t.points, j.points)
    np.testing.assert_array_equal(t.colors, j.colors)
    for a, b in zip(t.train + t.test, j.train + j.test):
        assert a.name == b.name and a.image_path == b.image_path
        assert a.image.dtype == np.float32
        np.testing.assert_array_equal(a.image, np.asarray(b.image))
        for k in ("viewmatrix", "projmatrix", "cam_center"):
            np.testing.assert_allclose(getattr(a.camera, k).numpy(),
                                       np.asarray(getattr(b.camera, k)),
                                       rtol=1e-6, atol=1e-6)
        assert (a.camera.width, a.camera.height) == (b.camera.width,
                                                     b.camera.height)
        assert int(a.camera.frame) == int(b.camera.frame)


def test_blender_scene_as_the_jax_test_reads_it(tmp_path):
    """tests/test_blender.py's checks: transparent pixels over black, the
    opaque square, the camera at (0, 0, 4) looking at the origin; the
    test split absent; eval_split False merges nothing."""
    root = str(tmp_path)
    _write_scene(root, ["rgba", "rgba"])
    scene = t_load(root, num_random_pts=500, device="cpu")
    assert len(scene.train) == 2 and len(scene.test) == 0
    assert scene.points.shape == (500, 3)
    assert np.all(np.abs(scene.points) <= 1.3 + 1e-6)
    fr = scene.train[0]
    assert fr.image.shape == (3, 8, 8)
    assert fr.image[:, 0, 0].max() == 0.0
    assert abs(fr.image[0, 3, 3] - 1.0) < 1e-6
    np.testing.assert_allclose(fr.camera.cam_center.numpy(), [0, 0, 4],
                               atol=1e-6)
    V = fr.camera.viewmatrix.numpy()
    np.testing.assert_allclose(V[:3, 3], [0, 0, 4], atol=1e-6)
    merged = t_load(root, eval_split=False, num_random_pts=10, device="cpu")
    assert len(merged.train) == 2 and merged.test == []


def test_blender_lazy_images_and_ply(tmp_path):
    """`load_images=False` reads sizes from the headers only; a
    `points3d.ply` with colours seeds the points, as the JAX reader."""
    from gaussianrpg_tpu_torch.data.ply import write_ply

    root = str(tmp_path)
    _write_scene(root, ["palette"])
    rng = np.random.default_rng(4)
    vert = np.zeros(20, dtype=[("x", "f4"), ("y", "f4"), ("z", "f4"),
                               ("red", "u1"), ("green", "u1"),
                               ("blue", "u1")])
    for k in ("x", "y", "z"):
        vert[k] = rng.uniform(-1, 1, 20)
    for k in ("red", "green", "blue"):
        vert[k] = rng.integers(0, 256, 20)
    write_ply(os.path.join(root, "points3d.ply"), {"vertex": vert})
    t = t_load(root, load_images=False, device="cpu")
    j = j_load(root, load_images=False)
    assert t.train[0].image is None
    assert (t.train[0].camera.width, t.train[0].camera.height) == (8, 8)
    np.testing.assert_array_equal(t.points, j.points)
    np.testing.assert_allclose(t.colors, j.colors, rtol=1e-7)
