"""The port's data layer held against the JAX package (and Pillow) on the
CPU: PLY files (mirrors of tests/test_data_io.py:12,24,93, and
byte-identical writes), the PNG codec and resizes of `data/image_io`
against Pillow, checkpoints in both directions (the JAX package's files,
leaf for leaf), the latest-checkpoint loader (tests/test_train.py:120) and
the flat PLY export."""
import numpy as np
import pytest
import torch
from PIL import Image

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from gaussianrpg_tpu.data import ply as jply  # noqa: E402
from gaussianrpg_tpu.models import scene_io as jio  # noqa: E402
from gaussianrpg_tpu.models.corrections import \
    init_color_correction as j_init_cc  # noqa: E402
from gaussianrpg_tpu.models.scene_builder import \
    init_sky_gaussians as j_init_sky  # noqa: E402
from gaussianrpg_tpu.train import trainer as jtr  # noqa: E402
from gaussianrpg_tpu.utils import synthetic as jsyn  # noqa: E402

from gaussianrpg_tpu_torch.data import image_io  # noqa: E402
from gaussianrpg_tpu_torch.data import ply as tply  # noqa: E402
from gaussianrpg_tpu_torch.models import scene_io as tio  # noqa: E402
from gaussianrpg_tpu_torch.models.convert import scene_from_tree  # noqa: E402
from gaussianrpg_tpu_torch.train import trainer as ttr  # noqa: E402
from gaussianrpg_tpu_torch.utils import synthetic as tsyn  # noqa: E402

from .test_torch_train import _flat  # noqa: E402
from .torch_parity import one_cpu_thread, tree_of  # noqa: E402,F401


# ------------------------------------------------------------------- PLY

def test_ply_roundtrip(tmp_path):
    """tests/test_data_io.py:12 for the port."""
    rng = np.random.default_rng(0)
    pts = rng.standard_normal((100, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (100, 3)).astype(np.float32)
    p = str(tmp_path / "pc.ply")
    tply.store_pointcloud(p, pts, cols)
    pts2, cols2, _ = tply.fetch_pointcloud(p)
    np.testing.assert_allclose(pts2, pts, rtol=1e-6)
    np.testing.assert_allclose(cols2, cols, atol=1 / 255.0 + 1e-6)


def _gaussian_arrays(rng, n=50):
    shapes = ((n, 3), (n, 1, 3), (n, 15, 3), (n, 1), (n, 3), (n, 4), (n, 2))
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def test_gaussian_ply_layout_roundtrip(tmp_path):
    """tests/test_data_io.py:24 for the port; the file is byte for byte the
    JAX package's, and each package reads the other's."""
    rng = np.random.default_rng(0)
    xyz, f_dc, f_rest, op, sc, rot, sem = arrs = _gaussian_arrays(rng)
    p, q = str(tmp_path / "t.ply"), str(tmp_path / "j.ply")
    tply.write_ply(p, {"vertex": tply.gaussian_to_struct(*arrs)})
    jply.write_ply(q, {"vertex": jply.gaussian_to_struct(*arrs)})
    assert open(p, "rb").read() == open(q, "rb").read()
    back = tply.struct_to_gaussian(tply.read_ply(q)["vertex"])
    for k, v in (("xyz", xyz), ("features_dc", f_dc),
                 ("features_rest", f_rest), ("rotation", rot),
                 ("semantic", sem), ("opacity", op), ("scaling", sc)):
        np.testing.assert_allclose(back[k], v, rtol=1e-6, err_msg=k)


def test_composite_ply_save(tmp_path):
    """tests/test_data_io.py:93 for the port, byte-identical to the JAX
    package's file of the same scene."""
    jm, jmeta, jarr = jsyn.make_scene(n_background=100, bkgd_capacity=128,
                                      n_actors=2, actor_capacity=64,
                                      n_frames=3)
    tm, _, _ = scene_from_tree({"models": tree_of(jm),
                                "meta": tree_of(jmeta),
                                "arrays": tree_of(jarr)}, device="cpu")
    p, q = str(tmp_path / "t.ply"), str(tmp_path / "j.ply")
    tio.save_composite_ply(p, tm)
    jio.save_composite_ply(q, jm)
    elems = tply.read_ply(p)
    assert "vertex_background" in elems
    assert "vertex_obj_000" in elems and "vertex_obj_001" in elems
    assert len(elems["vertex_background"]) == 100
    assert open(p, "rb").read() == open(q, "rb").read()


# ------------------------------------------------------------------- PNG

def _pattern(rng, h, w, c):
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([(x * 3 + y * 5 + 40 * k) % 256 for k in range(c)], -1)
    return ((base + rng.integers(0, 30, (h, w, c))) % 256).astype(np.uint8)


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P", "P16",
                                  "P4"])
def test_png_read_matches_pillow(tmp_path, mode):
    """Pillow's PNGs of every supported colour type (its adaptive row
    filters, optimize on and off; palettes of 4 and 16 colours are packed
    at 2 and 4 bits) read back as `np.asarray(Image.open(...))`."""
    rng = np.random.default_rng(1)
    for h, w in ((37, 53), (96, 128)):
        if mode.startswith("P"):
            n = {"P": 200, "P16": 16, "P4": 4}[mode]
            im = Image.fromarray(rng.integers(0, n, (h, w), dtype=np.uint8),
                                 "P")
            im.putpalette(rng.integers(0, 256, 3 * n).astype(np.uint8)
                          .tolist())
        else:
            c = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
            a = _pattern(rng, h, w, c)
            im = Image.fromarray(a[..., 0] if c == 1 else a, mode)
        for kw in ({}, {"optimize": True}):
            p = str(tmp_path / "x.png")
            im.save(p, **kw)
            with Image.open(p) as ref:
                want = np.asarray(ref)
            got = image_io.read_png(p)
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want)
            assert image_io.image_hw(p) == (h, w)


@pytest.mark.parametrize("channels", [1, 3])
def test_png_write_read_by_pillow(tmp_path, channels):
    a = _pattern(np.random.default_rng(2), 45, 61, channels)
    a = a[..., 0] if channels == 1 else a
    p = str(tmp_path / "w.png")
    image_io.write_png(p, a)
    with Image.open(p) as im:
        np.testing.assert_array_equal(np.asarray(im), a)
    np.testing.assert_array_equal(image_io.read_image(p), a)


def test_non_png_without_pillow_raises(tmp_path, monkeypatch):
    """Without Pillow, a file that is neither PNG nor JPEG (the two the
    port decodes itself) raises, naming the file."""
    import sys

    b = str(tmp_path / "x.bmp")
    Image.fromarray(_pattern(np.random.default_rng(3), 16, 16, 3)).save(b)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(image_io.ImageReadError, match="x.bmp.*PNG"):
        image_io.read_image(b)


@pytest.mark.parametrize("size,new", [((1280, 1920), (1600, 1066)),
                                      ((96, 128), (64, 48)),
                                      ((96, 128), (43, 31)),
                                      ((50, 70), (140, 100)),
                                      ((13, 17), (29, 7))])
@pytest.mark.parametrize("channels", [1, 3])
def test_resizes_match_pillow(size, new, channels):
    """`resize_bilinear` within 1/255 of Pillow's BILINEAR at every pixel
    (the same fixed-point arithmetic: measured equal), `resize_nearest`
    equal to Pillow's NEAREST: the Waymo auto-downscale 1920 -> 1600, an
    integer factor, odd factors, upscales."""
    a = _pattern(np.random.default_rng(4), *size, channels)
    a = a[..., 0] if channels == 1 else a
    im = Image.fromarray(a)
    got = image_io.resize_bilinear(a, new).astype(int)
    want = np.asarray(im.resize(new, Image.BILINEAR)).astype(int)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1
    np.testing.assert_array_equal(image_io.resize_nearest(a, new),
                                  np.asarray(im.resize(new, Image.NEAREST)))


# ------------------------------------------------------------ checkpoints

def _jax_state(with_actors=True):
    """A JAX TrainState of a composite scene (actors, tracked actor pose,
    MLP colour correction, sky Gaussians) with every leaf non-trivial, and
    its port copy (models/convert's carry-across)."""
    rng = np.random.default_rng(5)
    jm, jmeta, jarr = jsyn.make_scene(
        n_background=300, bkgd_capacity=512, n_actors=2 if with_actors else 0,
        actor_capacity=64, n_frames=4, sh_degree=1, fourier_dim=2,
        use_color_correction=with_actors, opt_track=True)
    if with_actors:
        sky, sky_aux = j_init_sky("", np.zeros(3), 10.0, 256, 1)
        jm = jm.replace(color_correction=j_init_cc(4, use_mlp=True, seed=3),
                        sky_gauss=sky, sky_gauss_aux=sky_aux)
    state = jtr.init_train_state(jm)

    def noise(x):
        if jnp.issubdtype(x.dtype, jnp.floating):
            return x + jnp.asarray(rng.standard_normal(x.shape)
                                   .astype(np.float32))
        return x
    state = state.replace(
        models=state.models.replace(
            background=jax.tree.map(noise, state.models.background)),
        adam=state.adam.replace(mu=jax.tree.map(noise, state.adam.mu),
                                nu=jax.tree.map(noise, state.adam.nu),
                                count=jnp.asarray(5, jnp.int32)),
        step=jnp.asarray(7, jnp.int32))
    tm, _, _ = scene_from_tree({"models": tree_of(state.models),
                                "meta": tree_of(jmeta),
                                "arrays": tree_of(jarr)}, device="cpu")
    return state, tm


def _path_names(path):
    return tuple(getattr(k, "name", getattr(k, "key", None)) for k in path)


@pytest.mark.parametrize("with_actors", [True, False])
def test_checkpoint_leaf_paths_match_jax(with_actors):
    """The port's list of leaf paths is jax.tree_util.tree_flatten_with_path
    of the JAX state (non-pytree fields, None sub-models and sorted dict
    keys included)."""
    jstate, tm = _jax_state(with_actors)
    flat, _ = jax.tree_util.tree_flatten_with_path(jstate)
    want = [_path_names(p) for p, _ in flat]
    assert tio.checkpoint_leaf_paths(ttr.init_train_state(tm)) == want


@pytest.mark.parametrize("with_actors", [True, False])
def test_jax_checkpoint_loads_into_port(tmp_path, with_actors):
    """A JAX `save_checkpoint` loaded by the port equals the carry-across of
    the same state exactly, leaf for leaf, in the template's dtypes."""
    jstate, tm = _jax_state(with_actors)
    p = str(tmp_path / "iteration_7.npz")
    jio.save_checkpoint(p, jstate, 7, 1)
    template = ttr.init_train_state(tm)
    state, step, sh = tio.load_checkpoint(p, template)
    assert (step, sh, state.step) == (7, 1, 7)
    a = _flat(tree_of({"models": state.models, "mu": state.adam.mu,
                       "nu": state.adam.nu, "count": state.adam.count}))
    b = _flat(tree_of({"models": jstate.models, "mu": jstate.adam.mu,
                       "nu": jstate.adam.nu, "count": jstate.adam.count}))
    ref = _flat(tree_of({"models": tm, "mu": template.adam.mu,
                         "nu": template.adam.nu,
                         "count": template.adam.count}))
    a, b = ({k: v for k, v in t.items() if v.dtype != object}   # None
            for t in (a, b))
    assert set(a) == set(b)
    for k in b:
        assert a[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k].astype(a[k].dtype),
                                      err_msg=k)


@pytest.mark.parametrize("with_actors", [True, False])
def test_port_checkpoint_loads_into_jax(tmp_path, with_actors):
    """A port `save_checkpoint` loaded by the JAX `load_checkpoint` equals
    the JAX state exactly, dtypes included."""
    jstate, tm = _jax_state(with_actors)
    p = str(tmp_path / "j.npz")
    jio.save_checkpoint(p, jstate, 7, 1)
    port_state, _, _ = tio.load_checkpoint(p, ttr.init_train_state(tm))
    q = str(tmp_path / "t.npz")
    tio.save_checkpoint(q, port_state, 7, 1)
    back, step, sh = jio.load_checkpoint(q, jtr.init_train_state(
        jstate.models))
    assert (step, sh) == (7, 1)
    fa, fb = jax.tree.leaves(back), jax.tree.leaves(jstate)
    assert len(fa) == len(fb)
    for x, y in zip(fa, fb):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    with np.load(p) as f, np.load(q) as g:
        assert sorted(f.files) == sorted(g.files)


def test_checkpoint_mismatch_names_the_leaf(tmp_path):
    jstate, tm = _jax_state(True)
    p = str(tmp_path / "iteration_1.npz")
    jio.save_checkpoint(p, jstate, 1, 0)
    smaller = tm.replace(actors=tm.actors.replace(
        xyz=tm.actors.xyz[:, :32]))
    with pytest.raises(ValueError, match="models/actors/xyz"):
        tio.load_checkpoint(p, ttr.init_train_state(smaller))
    with pytest.raises(ValueError, match="leaves"):
        tio.load_checkpoint(p, ttr.init_train_state(tm.replace(
            sky_gauss=None, sky_gauss_aux=None)))


def test_load_latest_checkpoint(tmp_path):
    """tests/test_train.py:120 for the port."""
    models, meta, arrays = tsyn.make_scene(
        n_background=50, bkgd_capacity=64, n_actors=1, actor_capacity=32,
        n_frames=2, device="cpu")
    state = ttr.init_train_state(models)
    state = state.replace(models=state.models.replace(
        background=state.models.background.replace(
            xyz=state.models.background.xyz + 1.25)))
    d = str(tmp_path)
    tio.save_checkpoint(f"{d}/iteration_40.npz", state, 40, 1)
    tio.save_checkpoint(f"{d}/iteration_100.npz", state, 100, 2)
    assert tio.search_max_iteration(d) == 100
    restored = tio.load_latest_checkpoint(d, models)
    np.testing.assert_allclose(restored.background.xyz.numpy(),
                               models.background.xyz.numpy() + 1.25,
                               rtol=1e-6)
    assert tio.load_latest_checkpoint(f"{d}/nope", models) is models


def test_export_flat_ply_matches_jax(tmp_path):
    """Both packages' flat single-element PLY of a composite scene at a
    frame: every field within 1e-6."""
    jstate, tm = _jax_state(True)
    jm = jstate.models
    _, jmeta, jarr = jsyn.make_scene(
        n_background=300, bkgd_capacity=512, n_actors=2, actor_capacity=64,
        n_frames=4, sh_degree=1, fourier_dim=2, opt_track=True)
    _, tmeta, tarr = scene_from_tree({"models": tree_of(jm),
                                      "meta": tree_of(jmeta),
                                      "arrays": tree_of(jarr)}, device="cpu")
    p, q = str(tmp_path / "t.ply"), str(tmp_path / "j.ply")
    tio.export_flat_ply(p, tm, tmeta, tarr, frame=2)
    jio.export_flat_ply(q, jm, jmeta, jarr, frame=2)
    a, b = tply.read_ply(p)["vertex"], jply.read_ply(q)["vertex"]
    assert a.dtype == b.dtype and len(a) == len(b) > 300
    for name in b.dtype.names:
        np.testing.assert_allclose(a[name], b[name], rtol=1e-6, atol=1e-6,
                                   err_msg=name)


def test_load_gaussians_from_ply_matches_jax(tmp_path):
    rng = np.random.default_rng(6)
    p = str(tmp_path / "g.ply")
    jply.write_ply(p, {"vertex": jply.gaussian_to_struct(
        *_gaussian_arrays(rng, 40))})
    jp, jaux = jio.load_gaussians_from_ply(p, fourier_dim=2)
    tp, taux = tio.load_gaussians_from_ply(p, fourier_dim=2, device="cpu")
    a = _flat(tree_of({"p": tp, "aux": taux}))
    b = _flat(tree_of({"p": jp, "aux": jaux}))
    for k in b:
        np.testing.assert_array_equal(a[k], b[k].astype(a[k].dtype),
                                      err_msg=k)
    assert isinstance(tp.xyz, torch.Tensor)
