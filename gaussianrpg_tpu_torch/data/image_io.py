"""Image reading, writing and resizing without Pillow, so the port runs
where Pillow is not installed.

The JAX package reads its camera images, sky masks and semantic planes
with Pillow (`gaussianrpg_tpu/data/waymo.py`, `data/lidar_init.py`). Here:

  read_png / write_png   PNG on zlib and numpy: 8-bit grey, grey+alpha,
                         RGB, RGBA and palette images (palette also at
                         1, 2 and 4 bits), non-interlaced, all five row
                         filters. `read_png` gives what
                         `np.asarray(PIL.Image.open(path))` gives.
  read_png_rgba          the same PNGs as `Image.open(path).convert("RGBA")`
                         gives them: grey and RGB widened, palette indices
                         looked up in PLTE, alpha from the image, from
                         tRNS (per palette entry, or the one transparent
                         grey or RGB value) or 255.
  read_image             PNG by `read_png`; any other format (the JPEGs of
                         `apps/waymo_converter.py`) through Pillow where it
                         is installed, else an error naming the file.
  image_hw               (height, width) from the file's header.
  resize_bilinear        `Image.resize(size, BILINEAR)` on uint8 images,
                         the same integer arithmetic: a triangle filter
                         whose support widens with the downscale factor,
                         22-bit fixed-point weights, a horizontal pass
                         rounded to uint8, then a vertical pass.
  resize_nearest         `Image.resize(size, NEAREST)`: the source pixel
                         under each output pixel's centre.
"""
from __future__ import annotations

import math
import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples a pixel
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


class ImageReadError(ValueError):
    pass


def _chunks(data: bytes, path: str):
    if data[:8] != PNG_SIGNATURE:
        raise ImageReadError(f"{path}: not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0]
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ImageReadError(f"{path}: bad CRC in chunk {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ImageReadError(f"{path}: truncated PNG")


def _header(body: bytes, path: str):
    w, h, depth, ctype, comp, filt, interlace = struct.unpack(">IIBBBBB",
                                                              body)
    if ctype not in _CHANNELS or comp != 0 or filt != 0:
        raise ImageReadError(f"{path}: unsupported PNG header")
    if interlace:
        raise ImageReadError(f"{path}: interlaced PNGs are not supported")
    if depth != 8 and not (ctype == 3 and depth in (1, 2, 4)):
        raise ImageReadError(
            f"{path}: {depth}-bit PNGs of colour type {ctype} are not "
            "supported (8-bit grey, grey+alpha, RGB, RGBA; palette at 1, 2, "
            "4 or 8 bits)")
    return w, h, depth, ctype


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters of `raw` [h, 1 + stride] (uint8)."""
    types = raw[:, 0]
    data = raw[:, 1:].astype(np.int32)
    if types.max(initial=0) > 4:
        raise ImageReadError("bad PNG row filter")
    out = np.zeros((h, stride), np.int32)
    if (types <= 2).all():
        prev = np.zeros(stride, np.int32)
        for r in range(h):
            t, row = types[r], data[r]
            if t == 1:
                px = row.reshape(-1, bpp) if stride % bpp == 0 else None
                if px is not None:
                    row = np.cumsum(px, axis=0).reshape(-1)
                else:
                    row = row.copy()
                    for i in range(bpp, stride):
                        row[i] += row[i - bpp]
            elif t == 2:
                row = row + prev
            out[r] = row & 255
            prev = out[r]
        return out.astype(np.uint8)
    # Average and Paeth take the reconstructed left neighbour: walk the
    # anti-diagonals of the (row, unit) grid, where a unit is `bpp` bytes,
    # each step vectorized over the rows it crosses
    n_units = -(-stride // bpp)
    pad = np.zeros((h + 1, (n_units + 1) * bpp), np.int32)
    src = np.zeros((h, n_units * bpp), np.int32)
    src[:, :stride] = data
    cols = np.arange(bpp)
    for d in range(h + n_units - 1):
        r = np.arange(max(0, d - n_units + 1), min(h, d + 1))
        u = d - r
        t = types[r][:, None]
        cur = (u[:, None] + 1) * bpp + cols          # this unit in `pad`
        a = pad[r[:, None] + 1, cur - bpp]
        b = pad[r[:, None], cur]
        c = pad[r[:, None], cur - bpp]
        pred = np.select([t == 1, t == 2, t == 3, t == 4],
                         [a, b, (a + b) >> 1, _paeth(a, b, c)], 0)
        pad[r[:, None] + 1, cur] = (src[r[:, None], u[:, None] * bpp + cols]
                                    + pred) & 255
    return pad[1:, bpp:bpp + stride].astype(np.uint8)


def _decode_png(path: str):
    """(pixels as `read_png` gives them, colour type, PLTE bytes or None,
    tRNS bytes or None)."""
    with open(path, "rb") as f:
        data = f.read()
    hdr, idat, plte, trns = None, [], None, None
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            hdr = _header(body, path)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"PLTE":
            plte = body
        elif kind == b"tRNS":
            trns = body
    if hdr is None or not idat:
        raise ImageReadError(f"{path}: no IHDR or IDAT chunk")
    w, h, depth, ctype = hdr
    ch = _CHANNELS[ctype]
    stride = (w * ch * depth + 7) // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ImageReadError(f"{path}: image data has the wrong size")
    px = _unfilter(raw.reshape(h, stride + 1), h, stride,
                   max(1, ch * depth // 8))
    if depth < 8:
        bits = np.unpackbits(px, axis=1).reshape(h, -1, depth)
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        px = (bits * weights).sum(-1).astype(np.uint8)[:, :w]
    px = px.reshape(h, w, ch) if ch > 1 else px.reshape(h, w)
    return px, ctype, plte, trns


def read_png(path: str) -> np.ndarray:
    """The pixels of a PNG as `np.asarray(PIL.Image.open(path))` gives
    them: [H, W] grey or palette indices, [H, W, 2] grey+alpha, [H, W, 3]
    RGB, [H, W, 4] RGBA, uint8."""
    return _decode_png(path)[0]


def read_png_rgba(path: str) -> np.ndarray:
    """[H, W, 4] uint8: the PNG as `PIL.Image.open(path).convert("RGBA")`
    gives it."""
    px, ctype, plte, trns = _decode_png(path)
    h, w = px.shape[:2]
    out = np.full((h, w, 4), 255, np.uint8)
    if ctype == 3:
        if plte is None:
            raise ImageReadError(f"{path}: palette image without PLTE")
        table = np.zeros((256, 4), np.uint8)
        table[:, 3] = 255
        pal = np.frombuffer(plte, np.uint8).reshape(-1, 3)[:256]
        table[:len(pal), :3] = pal
        if trns is not None:
            alpha = np.frombuffer(trns, np.uint8)[:256]
            table[:len(alpha), 3] = alpha
        return table[px]
    if ctype in (0, 4):
        grey = px if ctype == 0 else px[..., 0]
        out[..., :3] = grey[..., None]
        if ctype == 4:
            out[..., 3] = px[..., 1]
        elif trns is not None and len(trns) >= 2:
            out[..., 3] = np.where(grey == struct.unpack(">H", trns[:2])[0],
                                   0, 255)
        return out
    out[..., :px.shape[2]] = px
    if ctype == 2 and trns is not None and len(trns) >= 6:
        key = np.array(struct.unpack(">HHH", trns[:6]))
        out[..., 3] = np.where((px == key).all(-1), 0, 255)
    return out


def write_png(path: str, img: np.ndarray, level: int = 6) -> None:
    """Write a uint8 [H, W] grey or [H, W, 3] RGB image (8-bit, no row
    filter, zlib at `level`)."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (
            img.ndim == 3 and img.shape[2] != 3):
        raise ValueError("write_png takes uint8 [H, W] or [H, W, 3]")
    h, w = img.shape[:2]
    ctype = 2 if img.ndim == 3 else 0
    rows = np.zeros((h, 1 + img[0].size), np.uint8)
    rows[:, 1:] = img.reshape(h, -1)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0,
                                             0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
                + chunk(b"IEND", b""))


def _is_png(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(8) == PNG_SIGNATURE


def _pillow(path: str):
    try:
        from PIL import Image
    except ImportError:
        raise ImageReadError(
            f"{path}: not a PNG, and Pillow is not installed; without "
            "Pillow the port reads PNG images only") from None
    return Image.open(path)


def read_image(path: str) -> np.ndarray:
    """The pixels of a PNG (`read_png`), or of another format through
    Pillow, as `np.asarray(PIL.Image.open(path))`."""
    if _is_png(path):
        return read_png(path)
    with _pillow(path) as img:
        return np.asarray(img)


def image_hw(path: str) -> tuple[int, int]:
    """(height, width) from the file's header."""
    if _is_png(path):
        with open(path, "rb") as f:
            head = f.read(24)
        w, h = struct.unpack(">II", head[16:24])
        return h, w
    with _pillow(path) as img:
        return img.size[1], img.size[0]


# --------------------------------------------------------------- resizing

_PRECISION_BITS = 32 - 8 - 2


def _bilinear_coeffs(in_size: int, out_size: int):
    """Pillow's `precompute_coeffs` + `normalize_coeffs_8bpc` for the
    triangle filter: per output pixel the first source pixel, and integer
    weights [out, ksize] (zero past each pixel's own taps)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    xmins = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        ss = 1.0 / filterscale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        ws = []
        ww = 0.0
        for x in range(xmax):
            t = abs((x + xmin - center + 0.5) * ss)
            w = 1.0 - t if t < 1.0 else 0.0
            ws.append(w)
            ww += w
        for x in range(xmax):
            w = ws[x] / ww if ww != 0.0 else ws[x]
            kk[xx, x] = int((-0.5 if w < 0 else 0.5)
                            + w * (1 << _PRECISION_BITS))
        xmins[xx] = xmin
    return xmins, kk


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass of Pillow's 8-bit resampling along `axis` of [H, W, C]
    (int32 sums, as Pillow's)."""
    in_size = img.shape[axis]
    xmins, kk = _bilinear_coeffs(in_size, out_size)
    src = np.moveaxis(img, axis, 0)
    acc = np.full((out_size,) + src.shape[1:], 1 << (_PRECISION_BITS - 1),
                  np.int32)
    shape = (-1,) + (1,) * (src.ndim - 1)
    for k in range(kk.shape[1]):
        w = kk[:, k].astype(np.int32).reshape(shape)
        if not w.any():
            continue
        idx = np.minimum(xmins + k, in_size - 1)
        acc += np.multiply(src[idx], w, dtype=np.int32)
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def _check_resizable(img: np.ndarray, what: str) -> np.ndarray:
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError(f"{what} takes a uint8 [H, W] or [H, W, C] image")
    return img


def resize_bilinear(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """`PIL.Image.fromarray(img).resize(size, BILINEAR)` of a uint8 grey
    [H, W] or RGB [H, W, 3] image; `size` is (width, height) as Pillow
    takes it."""
    _check_resizable(img, "resize_bilinear")
    if img.ndim == 3 and img.shape[2] != 3:
        raise ValueError("resize_bilinear takes grey or RGB images (Pillow "
                         "resizes alpha images premultiplied)")
    w, h = size
    out = img
    if w != img.shape[1]:
        out = _resample_axis(out, w, 1)
    if h != img.shape[0]:
        out = _resample_axis(out, h, 0)
    return out.copy() if out is img else out


def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """Pillow's affine nearest-neighbour scaling: the source coordinate
    starts at half a step and advances by one step an output pixel (a
    running float64 sum), truncated."""
    step = in_size / out_size
    pos = np.add.accumulate(np.concatenate(
        [[step * 0.5], np.full(out_size - 1, step)]))
    return np.minimum(pos.astype(np.int64), in_size - 1)


def resize_nearest(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """`PIL.Image.fromarray(img).resize(size, NEAREST)`; `size` is
    (width, height)."""
    _check_resizable(img, "resize_nearest")
    w, h = size
    return img[_nearest_index(img.shape[0], h)][:, _nearest_index(
        img.shape[1], w)]
