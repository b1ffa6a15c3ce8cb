"""The port's visualization helpers (`utils/visualize.py`) against the JAX
package's (`gaussianrpg_tpu/utils/visualize.py`): PNGs through the
port's own writer, the JET depth colormap through cv2 (an error naming
cv2 without it), the contact sheet and the camera concat."""
import builtins

import numpy as np
import pytest
import torch

from gaussianrpg_tpu.utils import visualize as jv  # noqa: E402

from gaussianrpg_tpu_torch.data.image_io import read_png  # noqa: E402
from gaussianrpg_tpu_torch.utils import visualize as tv  # noqa: E402

from .torch_parity import one_cpu_thread  # noqa: E402,F401


def _img(rng, c=3, h=12, w=10):
    return rng.uniform(-0.2, 1.2, (c, h, w)).astype(np.float32)


def test_to_hwc8_and_save_image_match_jax(tmp_path):
    """Truncating quantization of numpy and tensor inputs; the port's PNG
    holds the JAX package's (Pillow) PNG's pixels."""
    rng = np.random.default_rng(0)
    x = _img(rng)
    np.testing.assert_array_equal(tv.to_hwc8(x), jv.to_hwc8(x))
    np.testing.assert_array_equal(tv.to_hwc8(torch.from_numpy(x)),
                                  jv.to_hwc8(x))
    tv.save_image(str(tmp_path / "a" / "t.png"), torch.from_numpy(x))
    jv.save_image(str(tmp_path / "j.png"), x)
    np.testing.assert_array_equal(read_png(str(tmp_path / "a" / "t.png")),
                                  read_png(str(tmp_path / "j.png")))


def test_visualize_depth_and_sheets_match_jax():
    pytest.importorskip("cv2")
    rng = np.random.default_rng(1)
    depth = rng.uniform(0.5, 30.0, (1, 12, 10)).astype(np.float32)
    depth[0, :2] = 0.0
    np.testing.assert_array_equal(tv.visualize_depth(torch.from_numpy(depth)),
                                  jv.visualize_depth(depth))
    np.testing.assert_array_equal(tv.visualize_depth(depth[0], far=10.0),
                                  jv.visualize_depth(depth[0], far=10.0))
    gt, rgb = _img(rng), _img(rng)
    acc = rng.uniform(0, 1, (1, 12, 10)).astype(np.float32)
    np.testing.assert_array_equal(
        tv.training_contact_sheet(gt, torch.from_numpy(rgb), depth, acc),
        jv.training_contact_sheet(gt, rgb, depth, acc))
    ims = [_img(rng, h=12), _img(rng, h=9)]
    np.testing.assert_array_equal(tv.hcat_cameras(ims), jv.hcat_cameras(ims))


def test_missing_cv2_and_imageio_are_named(monkeypatch, tmp_path):
    """Without cv2 the depth colormap raises naming cv2 (no colormap of
    the port's own); without imageio the video writer names imageio."""
    real = builtins.__import__

    def no(name, *a, **kw):
        if name in ("cv2", "imageio"):
            raise ImportError(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no)
    with pytest.raises(ImportError, match="cv2"):
        tv.visualize_depth(np.ones((4, 4), np.float32))
    with pytest.raises(ImportError, match="imageio"):
        tv.write_video(str(tmp_path / "v.mp4"), [np.zeros((3, 4, 4))])
