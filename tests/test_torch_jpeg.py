"""The port's baseline JPEG decoder (`data/image_io.read_jpeg`: the host
library's entropy decoder and islow IDCT, libjpeg's fancy upsampling and
YCbCr tables in numpy) against Pillow (libjpeg-turbo), pixel for pixel;
its encoder (`encode_jpeg`), `image_hw` on JPEG headers, `read_grey` and
`resize_lanczos` against Pillow."""
import io

import numpy as np
import pytest

PIL = pytest.importorskip("PIL")
from PIL import Image  # noqa: E402

from gaussianrpg_tpu_torch.data import image_io  # noqa: E402

from .torch_parity import one_cpu_thread  # noqa: F401,E402

SUBSAMPLING = {"4:4:4": 0, "4:2:2": 1, "4:2:0": 2}


def _picture(h, w, channels, seed=0):
    """Gradients, sharp edges and noise: every DCT band and chroma edge."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([(x * 3 + y * 5) % 256, (x * y) % 256,
                     (255 - 2 * x + y) % 256], -1)
    img = np.clip(0.6 * base + rng.integers(0, 60, (h, w, 3)), 0, 255)
    img = img.astype(np.uint8)
    return img[..., 0] if channels == 1 else img


def _pillow_jpeg(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _pillow_pixels(data):
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im)


def _assert_same(data, name="x.jpg"):
    got = image_io.decode_jpeg(data, name)
    ref = _pillow_pixels(data)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    diff = np.abs(got.astype(np.int64) - ref)
    assert not diff.any(), (int(diff.max()), int((diff > 0).sum()))


@pytest.mark.parametrize("quality", [50, 75, 95, 100])
@pytest.mark.parametrize("sampling", ["4:4:4", "4:2:2", "4:2:0", "grey"])
@pytest.mark.parametrize("hw", [(33, 47), (48, 64), (17, 130)])
def test_decoder_equals_pillow(quality, sampling, hw):
    img = _picture(*hw, 1 if sampling == "grey" else 3, seed=quality)
    kw = {} if sampling == "grey" else dict(
        subsampling=SUBSAMPLING[sampling])
    _assert_same(_pillow_jpeg(img, quality=quality, **kw))


@pytest.mark.parametrize("hw", [(1, 1), (2, 3), (5, 17), (31, 2), (9, 4)])
@pytest.mark.parametrize("sampling", ["4:2:2", "4:2:0"])
def test_decoder_equals_pillow_at_tiny_sizes(hw, sampling):
    """Chroma planes one or two samples wide (box replication, not the
    triangle filter) and sizes below one MCU."""
    img = _picture(*hw, 3, seed=hw[0] * 31 + hw[1])
    _assert_same(_pillow_jpeg(img, quality=90,
                              subsampling=SUBSAMPLING[sampling]))


@pytest.mark.parametrize("kw", [dict(restart_marker_blocks=1),
                                dict(restart_marker_blocks=5),
                                dict(restart_marker_rows=1),
                                dict(restart_marker_rows=2)])
@pytest.mark.parametrize("sampling", ["4:4:4", "4:2:0", "grey"])
def test_restart_intervals_equal_pillow(kw, sampling):
    img = _picture(61, 77, 1 if sampling == "grey" else 3, seed=5)
    extra = {} if sampling == "grey" else dict(
        subsampling=SUBSAMPLING[sampling])
    data = _pillow_jpeg(img, quality=85, **kw, **extra)
    assert b"\xff\xd0" in data          # the encoder wrote RST markers
    _assert_same(data)


def test_a_camera_sized_image_equals_pillow(tmp_path):
    """1920x886 (a side camera of the Waymo rig), 4:2:0 at quality 95, read
    from disk through `read_image`, with its size from the header."""
    img = _picture(886, 1920, 3, seed=9)
    path = str(tmp_path / "000000_3.jpg")
    with open(path, "wb") as f:
        f.write(_pillow_jpeg(img, quality=95))
    with Image.open(path) as im:
        ref = np.asarray(im)
    np.testing.assert_array_equal(image_io.read_image(path), ref)
    assert image_io.image_hw(path) == (886, 1920)


def test_image_hw_skips_app_segments(tmp_path):
    """JFIF, EXIF, ICC and comment segments before the frame header."""
    img = _picture(40, 56, 3)
    exif = Image.Exif()
    exif[0x010F] = "maker"
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=80, exif=exif.tobytes(),
                              icc_profile=b"\0" * 300, comment=b"hello")
    path = str(tmp_path / "a.jpg")
    with open(path, "wb") as f:
        f.write(buf.getvalue())
    data = buf.getvalue()
    assert data.find(b"Exif") < data.find(b"\xff\xc0")
    assert image_io.image_hw(path) == (40, 56)
    _assert_same(data)


def test_progressive_and_arithmetic_raise(tmp_path):
    img = _picture(24, 24, 3)
    path = str(tmp_path / "prog.jpg")
    with open(path, "wb") as f:
        f.write(_pillow_jpeg(img, quality=80, progressive=True))
    with pytest.raises(image_io.ImageReadError, match="prog.jpg.*progressive"):
        image_io.read_jpeg(path)
    assert image_io.image_hw(path) == (24, 24)
    data = bytearray(_pillow_jpeg(img, quality=80))
    sof = data.find(b"\xff\xc0")
    for marker, what in ((0xC9, "arithmetic"), (0xC3, "lossless")):
        data[sof + 1] = marker
        with pytest.raises(image_io.ImageReadError, match=what):
            image_io.decode_jpeg(bytes(data), "a.jpg")
    data[sof + 1] = 0xC0
    data[sof + 4] = 12                  # sample precision
    with pytest.raises(image_io.ImageReadError, match="12-bit"):
        image_io.decode_jpeg(bytes(data), "b.jpg")


def test_corrupt_and_truncated_scans_raise():
    data = _pillow_jpeg(_picture(64, 64, 3), quality=90)
    with pytest.raises(image_io.ImageReadError, match="t.jpg"):
        image_io.decode_jpeg(data[:len(data) // 2], "t.jpg")
    with pytest.raises(image_io.ImageReadError, match="not a JPEG"):
        image_io.decode_jpeg(b"\x89PNG\r\n\x1a\n", "n.jpg")


def test_other_formats_raise_naming_the_file(tmp_path):
    path = str(tmp_path / "x.bmp")
    Image.fromarray(_picture(8, 8, 3)).save(path)
    with pytest.raises(image_io.ImageReadError, match="x.bmp.*PNG.*JPEG"):
        image_io.read_image(path)
    with pytest.raises(image_io.ImageReadError, match="x.bmp"):
        image_io.image_hw(path)


def test_read_image_jpeg_without_pillow(tmp_path, monkeypatch):
    """`read_image` decodes a JPEG with Pillow absent, to Pillow's
    pixels."""
    import sys

    path = str(tmp_path / "x.jpg")
    Image.fromarray(_picture(16, 16, 3, seed=3)).save(path)
    with Image.open(path) as im:
        ref = np.asarray(im)
    monkeypatch.setitem(sys.modules, "PIL", None)
    np.testing.assert_array_equal(image_io.read_image(path), ref)
    assert image_io.image_hw(path) == (16, 16)


@pytest.mark.parametrize("sampling", ["4:4:4", "4:2:2", "4:2:0", "4:4:0",
                                      "grey"])
@pytest.mark.parametrize("hw", [(1, 1), (33, 47), (64, 48), (121, 203)])
def test_encoder_files_decode_the_same_in_pillow(sampling, hw):
    """The fixture encoder's files (incl. 4:4:0, whose chroma libjpeg
    upsamples with its 1x2 triangle filter) decode in Pillow exactly as in
    the port, and close to the source."""
    img = _picture(*hw, 1 if sampling == "grey" else 3, seed=2)
    y, x = np.mgrid[0:hw[0], 0:hw[1]]
    smooth = np.clip(np.stack([100 + x, 80 + y, 160 - x + y], -1), 0,
                     255).astype(np.uint8)
    for src in (img, smooth[..., 0] if sampling == "grey" else smooth):
        data = image_io.encode_jpeg(src, 95, "4:2:0" if sampling == "grey"
                                    else sampling)
        _assert_same(data)
    err = np.abs(image_io.decode_jpeg(data).astype(float) - src)
    assert err.mean() < 2.0


@pytest.mark.parametrize("quality", [50, 75, 95, 100])
@pytest.mark.parametrize("sampling", ["4:4:4", "4:2:2", "4:2:0", "grey"])
@pytest.mark.parametrize("hw", [(1, 1), (8, 8), (22, 30), (33, 47)])
def test_encoder_writes_pillows_scan(quality, sampling, hw):
    """libjpeg's arithmetic (integer YCbCr, its chroma downsampling and
    edge padding, the islow DCT, its rounding, the standard tables): the
    entropy-coded scan is byte for byte the one Pillow writes."""
    img = _picture(*hw, 1 if sampling == "grey" else 3, seed=hw[1])
    kw = {} if sampling == "grey" else dict(
        subsampling=SUBSAMPLING[sampling])
    ref = _pillow_jpeg(img, quality=quality, **kw)
    ours = image_io.encode_jpeg(img, quality, "4:2:0" if sampling == "grey"
                                else sampling)
    assert ours[ours.index(b"\xff\xda"):] == ref[ref.index(b"\xff\xda"):]


def test_encoder_tables_are_libjpegs():
    """The standard Huffman tables and libjpeg's quality scaling: a
    Pillow file's DHT and DQT segments at the same quality."""
    data = _pillow_jpeg(_picture(16, 16, 3), quality=95)
    ours = image_io.encode_jpeg(_picture(16, 16, 3), 95)

    def segments(d, marker):
        out, pos = [], 2
        while pos < len(d) and d[pos + 1] != 0xDA:
            n = int.from_bytes(d[pos + 2:pos + 4], "big")
            if d[pos + 1] == marker:
                out.append(d[pos + 4:pos + 2 + n])
            pos += 2 + n
        return b"".join(out)

    assert segments(ours, 0xC4) == segments(data, 0xC4)
    assert segments(ours, 0xDB) == segments(data, 0xDB)


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA", "LA", "P"])
def test_read_grey_equals_pillow_convert_l(tmp_path, mode):
    rng = np.random.default_rng(4)
    rgba = rng.integers(0, 256, (13, 17, 4), dtype=np.uint8)
    im = {"L": lambda: Image.fromarray(rgba[..., 0]),
          "RGB": lambda: Image.fromarray(rgba[..., :3]),
          "RGBA": lambda: Image.fromarray(rgba),
          "LA": lambda: Image.fromarray(rgba[..., :2], "LA"),
          "P": lambda: Image.fromarray(rgba[..., :3]).convert(
              "P", palette=Image.ADAPTIVE, colors=16)}[mode]()
    for ext in (".png", ".jpg") if mode in ("L", "RGB") else (".png",):
        path = str(tmp_path / f"g{ext}")
        im.save(path)
        with Image.open(path) as ref:
            np.testing.assert_array_equal(image_io.read_grey(path),
                                          np.asarray(ref.convert("L")))


@pytest.mark.parametrize("size,new", [((1280, 1920), (960, 640)),
                                      ((96, 128), (64, 48)),
                                      ((37, 53), (26, 18)),
                                      ((37, 53), (106, 74)),
                                      ((16, 24), (3, 2))])
@pytest.mark.parametrize("channels", [1, 3])
def test_resize_lanczos_equals_pillow(size, new, channels):
    img = _picture(*size, channels, seed=7)
    got = image_io.resize_lanczos(img, new)
    ref = np.asarray(Image.fromarray(img).resize(new, Image.LANCZOS))
    np.testing.assert_array_equal(got, ref)


def test_blender_frames_read_jpeg_as_pillow_rgba(tmp_path):
    """The Blender loader's non-PNG frames: `Image.open(p).convert("RGBA")`
    of a grey and an RGB JPEG, without Pillow."""
    from gaussianrpg_tpu_torch.data.blender import _read_rgba

    for channels in (1, 3):
        path = str(tmp_path / f"f{channels}.jpg")
        Image.fromarray(_picture(20, 28, channels)).save(path, quality=90)
        with Image.open(path) as im:
            np.testing.assert_array_equal(_read_rgba(path),
                                          np.asarray(im.convert("RGBA")))
