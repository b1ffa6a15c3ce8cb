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
  read_jpeg              baseline Huffman JPEG (SOF0/SOF1, 8-bit; grey or
                         three components at any integral sampling;
                         restart intervals; the raw camera JPEGs of
                         `apps/waymo_converter.py`) as Pillow decodes it
                         through libjpeg-turbo: the scans are entropy-
                         decoded and inverse-transformed by the host
                         library (`csrc/host/jpeg_decode.cc`, libjpeg's
                         integer "islow" IDCT), the chroma upsampled with
                         libjpeg's "fancy" triangle filter (`jdsample.c`)
                         and converted with its fixed-point YCbCr tables
                         (`jdcolor.c`). Progressive, arithmetic-coded,
                         lossless, hierarchical and 12-bit files raise.
  encode_jpeg / write_jpeg  a baseline JPEG encoder vectorised in numpy,
                         libjpeg's arithmetic throughout (integer YCbCr,
                         its chroma downsampling and edge padding, the
                         islow forward DCT, its quality-scaled tables and
                         rounding, its dummy blocks, the standard Huffman
                         tables): the entropy-coded scan is byte for byte
                         the one Pillow writes at the same quality and
                         subsampling (the headers differ).
  read_image             PNG by `read_png`, JPEG by `read_jpeg`; any other
                         format raises, naming the file.
  read_grey              `Image.open(path).convert("L")` of either.
  image_hw               (height, width) from the file's header (a JPEG's
                         SOF segment, past its APPn segments).
  resize_bilinear        `Image.resize(size, BILINEAR)` on uint8 images,
                         the same integer arithmetic: a triangle filter
                         whose support widens with the downscale factor,
                         22-bit fixed-point weights, a horizontal pass
                         rounded to uint8, then a vertical pass.
  resize_lanczos         `Image.resize(size, LANCZOS)`: the same passes with
                         Pillow's Lanczos filter (support 3).
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


def _head(path: str, n: int) -> bytes:
    with open(path, "rb") as f:
        return f.read(n)


def _is_png(path: str) -> bool:
    return _head(path, 8) == PNG_SIGNATURE


def _is_jpeg(path: str) -> bool:
    return _head(path, 2) == JPEG_SOI


def _unknown_format(path: str) -> ImageReadError:
    return ImageReadError(f"{path}: neither a PNG nor a JPEG file; the port "
                          "reads PNG and baseline JPEG images")


def read_image(path: str) -> np.ndarray:
    """The pixels of a PNG (`read_png`) or a JPEG (`read_jpeg`), as
    `np.asarray(PIL.Image.open(path))` gives them."""
    if _is_png(path):
        return read_png(path)
    if _is_jpeg(path):
        return read_jpeg(path)
    raise _unknown_format(path)


def image_hw(path: str) -> tuple[int, int]:
    """(height, width) from the file's header."""
    if _is_png(path):
        w, h = struct.unpack(">II", _head(path, 24)[16:24])
        return h, w
    if _is_jpeg(path):
        return _jpeg_hw(path)
    raise _unknown_format(path)


def read_grey(path: str) -> np.ndarray:
    """[H, W] uint8: the image as `PIL.Image.open(path).convert("L")`
    gives it (ITU-R 601 luma, `(19595 R + 38470 G + 7471 B + 0x8000) >>
    16`; grey images as they are, palettes looked up, alpha dropped)."""
    img = read_png_rgba(path)[..., :3] if _is_png(path) else read_image(path)
    if img.ndim == 2:
        return img
    r, g, b = (img[..., i].astype(np.uint32) for i in range(3))
    return ((19595 * r + 38470 * g + 7471 * b + 0x8000) >> 16).astype(
        np.uint8)


# ------------------------------------------------------------------- JPEG

JPEG_SOI = b"\xff\xd8"
# zigzag index -> natural (row-major) index of an 8x8 block
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
_SOF_KINDS = {
    0xC2: "progressive", 0xC3: "lossless", 0xC5: "hierarchical",
    0xC6: "hierarchical progressive", 0xC7: "hierarchical lossless",
    0xC9: "arithmetic-coded", 0xCA: "arithmetic-coded progressive",
    0xCB: "arithmetic-coded lossless",
    0xCD: "arithmetic-coded hierarchical",
    0xCE: "arithmetic-coded hierarchical progressive",
    0xCF: "arithmetic-coded hierarchical lossless"}
_SCAN_ERRORS = {-1: "a malformed Huffman table", -2: "an invalid Huffman code",
                -3: "a coefficient run past the block",
                -4: "a missing restart marker",
                -5: "entropy-coded data cut short"}


def _segment_at(data: bytes, pos: int, name: str):
    """(marker, segment body, offset after it) of the first marker
    segment at or after `pos` (standalone markers skipped), or None at
    EOI or the end of the data."""
    n = len(data)
    while pos < n:
        if data[pos] != 0xFF:
            raise ImageReadError(f"{name}: bad JPEG marker at byte {pos}")
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n or data[pos] == 0xD9:
            return None
        m = data[pos]
        pos += 1
        if m == 0x01 or 0xD0 <= m <= 0xD8:
            continue
        length = int.from_bytes(data[pos:pos + 2], "big")
        if length < 2 or pos + length > n:
            raise ImageReadError(f"{name}: truncated JPEG segment "
                                 f"0xFF{m:02X}")
        return m, data[pos + 2:pos + length], pos + length
    return None


def _sof(body: bytes):
    """(precision, height, width, [(id, h, v, quant table)])."""
    p, h, w, nf = struct.unpack(">BHHB", body[:6])
    comps = [tuple(body[6 + 3 * i:9 + 3 * i]) for i in range(nf)]
    comps = [(c, hv >> 4, hv & 15, tq) for c, hv, tq in comps]
    return p, h, w, comps


def _jpeg_hw(path: str) -> tuple[int, int]:
    with open(path, "rb") as f:
        data = f.read()
    pos = 2
    while (seg := _segment_at(data, pos, path)) is not None:
        m, body, pos = seg
        if 0xC0 <= m <= 0xCF and m not in (0xC4, 0xC8, 0xCC):
            _, h, w, _ = _sof(body)
            return h, w
    raise ImageReadError(f"{path}: no JPEG frame header")


def _unsupported(name: str, what: str) -> ImageReadError:
    return ImageReadError(f"{name}: {what} JPEGs are not supported (baseline "
                          "8-bit Huffman only)")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def read_jpeg(path: str) -> np.ndarray:
    """The pixels of a baseline JPEG as `np.asarray(PIL.Image.open(path))`
    gives them: uint8 [H, W, 3], or [H, W] for a grey image."""
    with open(path, "rb") as f:
        return decode_jpeg(f.read(), path)


def decode_jpeg(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """`read_jpeg` of the bytes of a JPEG file (`name` for errors)."""
    from .native import load_library

    if data[:2] != JPEG_SOI:
        raise ImageReadError(f"{name}: not a JPEG file")
    lib = load_library()
    buf = np.frombuffer(data, np.uint8)
    quant: dict[int, np.ndarray] = {}
    bits = np.zeros((8, 16), np.uint8)
    vals = np.zeros((8, 256), np.uint8)
    frame = planes = None
    restart, jfif, adobe, done = 0, False, None, set()
    pos = 2
    while (seg := _segment_at(data, pos, name)) is not None:
        m, body, pos = seg
        if m == 0xDB:                                   # DQT
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                size = 128 if pq else 64
                zz = np.frombuffer(body[i + 1:i + 1 + size],
                                   ">u2" if pq else np.uint8)
                table = np.zeros(64, np.int32)
                table[ZIGZAG] = zz
                quant[tq] = table
                i += 1 + size
        elif m == 0xC4:                                 # DHT
            i = 0
            while i < len(body):
                tc, th = body[i] >> 4, body[i] & 15
                counts = np.frombuffer(body[i + 1:i + 17], np.uint8)
                total = int(counts.sum())
                k = 4 * tc + th
                bits[k] = counts
                vals[k] = 0
                vals[k, :total] = np.frombuffer(body[i + 17:i + 17 + total],
                                                np.uint8)
                i += 17 + total
        elif m in (0xC0, 0xC1):
            p, h, w, comps = _sof(body)
            if p != 8:
                raise _unsupported(name, f"{p}-bit")
            if h == 0 or w == 0:
                raise ImageReadError(f"{name}: JPEG without its size in the "
                                     "frame header (DNL) is not supported")
            hmax = max(c[1] for c in comps)
            vmax = max(c[2] for c in comps)
            mcux, mcuy = _cdiv(w, 8 * hmax), _cdiv(h, 8 * vmax)
            layout, offset = [], 0
            for cid, ch, cv, tq in comps:
                if ch < 1 or cv < 1 or hmax % ch or vmax % cv:
                    raise ImageReadError(f"{name}: unsupported JPEG "
                                         "sampling factors")
                stride, rows = mcux * ch * 8, mcuy * cv * 8
                layout.append(dict(id=cid, h=ch, v=cv, tq=tq, stride=stride,
                                   rows=rows, offset=offset,
                                   dw=_cdiv(w * ch, hmax),
                                   dh=_cdiv(h * cv, vmax)))
                offset += stride * rows
            frame = (h, w, hmax, vmax, mcux, mcuy, layout)
            planes = np.zeros(offset, np.uint8)
        elif m in _SOF_KINDS:
            raise _unsupported(name, _SOF_KINDS[m])
        elif m == 0xCC:
            raise _unsupported(name, "arithmetic-coded")
        elif m == 0xDD:
            restart = int.from_bytes(body[:2], "big")
        elif m == 0xE0:
            jfif |= body[:5] == b"JFIF\0"
        elif m == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe = body[11]
        elif m == 0xDA:                                 # SOS
            if frame is None:
                raise ImageReadError(f"{name}: scan before the frame header")
            h, w, hmax, vmax, mcux, mcuy, layout = frame
            ns = body[0]
            if not 1 <= ns <= 4 or len(body) < 4 + 2 * ns:
                raise ImageReadError(f"{name}: bad JPEG scan header")
            ss, se, a = body[1 + 2 * ns:4 + 2 * ns]
            if (ss, se, a) != (0, 63, 0):
                raise _unsupported(name, "progressive")
            ids = {c["id"]: c for c in layout}
            comp = np.zeros((ns, 6), np.int32)
            qt = np.zeros((ns, 64), np.int32)
            for j in range(ns):
                cid, tab = body[1 + 2 * j], body[2 + 2 * j]
                c = ids.get(cid)
                if c is None or c["tq"] not in quant:
                    raise ImageReadError(f"{name}: scan of an unknown "
                                         "component or table")
                td, ta = tab >> 4, tab & 15
                if td > 3 or ta > 3 or not bits[td].any() \
                        or not bits[4 + ta].any():
                    raise ImageReadError(f"{name}: scan without its "
                                         "Huffman tables")
                bw, bh = (c["h"], c["v"]) if ns > 1 else (1, 1)
                comp[j] = (bw, bh, c["stride"], td, ta, c["offset"])
                qt[j] = quant[c["tq"]]
                done.add(cid)
            if ns > 1:
                mx, my = mcux, mcuy
            else:
                mx, my = _cdiv(c["dw"], 8), _cdiv(c["dh"], 8)
            end = lib.grpg_jpeg_scan(
                buf.ctypes.data, len(data), pos, ns, comp.ctypes.data,
                qt.ctypes.data, bits.ctypes.data, vals.ctypes.data, mx, my,
                restart, planes.ctypes.data)
            if end < 0:
                raise ImageReadError(f"{name}: corrupt JPEG scan "
                                     f"({_SCAN_ERRORS.get(end, end)})")
            pos = int(end)
    if frame is None or len(done) < len(frame[6]):
        raise ImageReadError(f"{name}: JPEG without complete image data")
    h, w, hmax, vmax, _, _, layout = frame
    comps = [planes[c["offset"]:c["offset"] + c["stride"] * c["rows"]]
             .reshape(c["rows"], c["stride"])[:c["dh"], :c["dw"]]
             for c in layout]
    if len(comps) == 1:
        return np.ascontiguousarray(comps[0][:h, :w])
    if len(comps) != 3:
        raise ImageReadError(f"{name}: {len(comps)}-component JPEGs are not "
                             "supported (grey or three components)")
    full = [_upsample(x, hmax // c["h"], vmax // c["v"])[:h, :w]
            for x, c in zip(comps, layout)]
    ids = tuple(c["id"] for c in layout)
    if jfif:
        rgb = False
    elif adobe is not None:
        rgb = adobe == 0
    else:
        rgb = ids == (82, 71, 66)
    if rgb:
        return np.stack(full, -1).astype(np.uint8)
    return _ycc_to_rgb(*full)


def _interleave(a: np.ndarray, b: np.ndarray, axis: int) -> np.ndarray:
    """a, b alternating along `axis` (a first)."""
    shape = list(a.shape)
    shape[axis] *= 2
    out = np.empty(shape, a.dtype)
    idx = [slice(None)] * a.ndim
    idx[axis] = slice(0, None, 2)
    out[tuple(idx)] = a
    idx[axis] = slice(1, None, 2)
    out[tuple(idx)] = b
    return out


def _upsample(x: np.ndarray, rh: int, rv: int) -> np.ndarray:
    """libjpeg-turbo's upsampling of one component plane [dh, dw] (its
    real samples) by (rh, rv) (`jdsample.c`): the "fancy" triangle filters
    for 2x1 and 2x2 (when the plane is more than two samples wide) and
    1x2, with the plane's edge samples repeated; box replication
    otherwise. int32."""
    x = x.astype(np.int32)
    dw = x.shape[1]
    if (rh, rv) == (1, 1):
        return x
    if rv == 2 and rh in (1, 2) and (rh == 1 or dw > 2):
        xp = np.pad(x, ((1, 1), (0, 0)), mode="edge")
        x3 = 3 * x
        if rh == 1:                                   # h1v2
            return _interleave((x3 + xp[:-2] + 1) >> 2,
                               (x3 + xp[2:] + 2) >> 2, 0)
        sums = _interleave(x3 + xp[:-2], x3 + xp[2:], 0)   # h2v2
        sp = np.pad(sums, ((0, 0), (1, 1)), mode="edge")
        s3 = 3 * sums
        return _interleave((s3 + sp[:, :-2] + 8) >> 4,
                           (s3 + sp[:, 2:] + 7) >> 4, 1)
    if (rh, rv) == (2, 1) and dw > 2:                 # h2v1
        xp = np.pad(x, ((0, 0), (1, 1)), mode="edge")
        x3 = 3 * x
        return _interleave((x3 + xp[:, :-2] + 1) >> 2,
                           (x3 + xp[:, 2:] + 2) >> 2, 1)
    return np.repeat(np.repeat(x, rv, 0), rh, 1)


def _fix16(v: float) -> int:
    return int(v * 65536 + 0.5)


_C = np.arange(256, dtype=np.int64) - 128
_CR_R = ((_fix16(1.40200) * _C + 32768) >> 16).astype(np.int32)
_CB_B = ((_fix16(1.77200) * _C + 32768) >> 16).astype(np.int32)
# the green term by (cb, cr): (Cb_g[cb] + Cr_g[cr]) >> 16
_CBCR_G = ((-_fix16(0.34414) * _C[:, None] + 32768
            - _fix16(0.71414) * _C[None, :]) >> 16).astype(np.int32)
_CLAMP = np.clip(np.arange(-512, 512), 0, 255).astype(np.uint8)


def _ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """libjpeg's `ycc_rgb_convert` (`jdcolor.c`): 16-bit fixed-point
    tables, the green term shifted after summing, clamped to 0-255."""
    y = y + 512
    out = np.empty(y.shape + (3,), np.uint8)
    out[..., 0] = _CLAMP[y + _CR_R[cr]]
    out[..., 1] = _CLAMP[y + _CBCR_G[cb, cr]]
    out[..., 2] = _CLAMP[y + _CB_B[cb]]
    return out


# the JPEG standard's example tables (ITU T.81 Annex K), zigzag order
_BASE_QUANT = (np.array([
    16, 11, 12, 14, 12, 10, 16, 14, 13, 14, 18, 17, 16, 19, 24, 40,
    26, 24, 22, 22, 24, 49, 35, 37, 29, 40, 58, 51, 61, 60, 57, 51,
    56, 55, 64, 72, 92, 78, 64, 68, 87, 69, 55, 56, 80, 109, 81, 87,
    95, 98, 103, 104, 103, 62, 77, 113, 121, 112, 100, 120, 92, 101, 103,
    99]), np.array([17, 18, 18, 24, 21, 24, 47, 26, 26, 47, 99, 66, 56, 66]
                   + [99] * 50))
_STD_HUFF = (   # (counts of lengths 1-16, symbols): DC luma, AC luma,
    # DC chroma, AC chroma
    ("00010501010101010100000000000000", "000102030405060708090a0b"),
    ("0002010303020403050504040000017d",
     "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
     "2433627282090a161718191a25262728292a3435363738393a43444546474849"
     "4a535455565758595a636465666768696a737475767778797a83848586878889"
     "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
     "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
     "f9fa"),
    ("00030101010101010101010000000000", "000102030405060708090a0b"),
    ("00020102040403040705040400010277",
     "000102031104052131061241510761711322328108144291a1b1c109233352f0"
     "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
     "494a535455565758595a636465666768696a737475767778797a828384858687"
     "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
     "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
     "f9fa"))


def jpeg_quant_tables(quality: int) -> list[np.ndarray]:
    """The luma and chroma quantization tables (zigzag order) libjpeg's
    `jpeg_set_quality(quality, force_baseline=TRUE)` writes."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return [np.clip((t * scale + 50) // 100, 1, 255) for t in _BASE_QUANT]


def _huff_codes(counts: bytes, symbols: bytes):
    """Canonical codes: (code [256], length [256]) by symbol."""
    code = np.zeros(256, np.uint64)
    length = np.zeros(256, np.int64)
    c, k = 0, 0
    for n_bits, n in enumerate(counts, start=1):
        for _ in range(n):
            code[symbols[k]] = c
            length[symbols[k]] = n_bits
            c += 1
            k += 1
        c <<= 1
    return code, length


def _fdct_pass(d: np.ndarray, first: bool) -> np.ndarray:
    """One pass of libjpeg's integer forward DCT (`jfdctint.c`,
    `jpeg_fdct_islow`) along the last axis of int64 [..., 8]: the first
    (rows) keeps PASS1_BITS of headroom, the second (columns) removes it
    and leaves the output scaled by 8."""
    cb, p1 = 13, 2                               # CONST_BITS, PASS1_BITS
    s = cb - p1 if first else cb + p1

    def descale(x, n):
        return (x + (1 << (n - 1))) >> n

    t0, t7 = d[..., 0] + d[..., 7], d[..., 0] - d[..., 7]
    t1, t6 = d[..., 1] + d[..., 6], d[..., 1] - d[..., 6]
    t2, t5 = d[..., 2] + d[..., 5], d[..., 2] - d[..., 5]
    t3, t4 = d[..., 3] + d[..., 4], d[..., 3] - d[..., 4]
    t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
    out = np.empty_like(d)
    if first:
        out[..., 0] = (t10 + t11) << p1
        out[..., 4] = (t10 - t11) << p1
    else:
        out[..., 0] = descale(t10 + t11, p1)
        out[..., 4] = descale(t10 - t11, p1)
    z1 = (t12 + t13) * 4433
    out[..., 2] = descale(z1 + t13 * 6270, s)
    out[..., 6] = descale(z1 - t12 * 15137, s)
    z1, z2, z3, z4 = t4 + t7, t5 + t6, t4 + t6, t5 + t7
    z5 = (z3 + z4) * 9633
    t4, t5, t6, t7 = t4 * 2446, t5 * 16819, t6 * 25172, t7 * 12299
    z1, z2 = z1 * -7373, z2 * -20995
    z3, z4 = z3 * -16069 + z5, z4 * -3196 + z5
    out[..., 7] = descale(t4 + z1 + z3, s)
    out[..., 5] = descale(t5 + z2 + z4, s)
    out[..., 3] = descale(t6 + z2 + z3, s)
    out[..., 1] = descale(t7 + z1 + z4, s)
    return out


def _fdct_quantize(blocks: np.ndarray, table: np.ndarray) -> np.ndarray:
    """Level-shifted samples [N, 8, 8] -> quantized coefficients [N, 64]
    in zigzag order: libjpeg's islow DCT, then its rounding division by
    8 x the table (zigzag order), as libjpeg-turbo's reciprocal
    multiplication computes it for every 16-bit coefficient."""
    rows = _fdct_pass(blocks, True)
    coef = _fdct_pass(rows.swapaxes(-1, -2), False).swapaxes(-1, -2)
    coef = coef.reshape(-1, 64)[:, ZIGZAG]
    div = 8 * table.astype(np.int64)
    q = (np.abs(coef) + div // 2) // div
    return np.where(coef < 0, -q, q)


_SAMPLING = {"4:4:4": (1, 1), "4:2:2": (2, 1), "4:2:0": (2, 2),
             "4:4:0": (1, 2)}


def _bit_count(v: np.ndarray) -> np.ndarray:
    """Bits of |v| (the JPEG magnitude category), int64."""
    return np.frexp(np.abs(v).astype(np.float64))[1].astype(np.int64)


def _rgb_to_ycc(img: np.ndarray) -> list[np.ndarray]:
    """libjpeg's `rgb_ycc_convert` (`jccolor.c`), int32 planes."""
    r, g, b = (img[..., i].astype(np.int32) for i in range(3))
    half, off = 32768, 128 << 16
    y = (19595 * r + 38470 * g + 7471 * b + half) >> 16
    cb = (-11059 * r - 21709 * g + 32768 * b + off + half - 1) >> 16
    cr = (32768 * r - 27439 * g - 5329 * b + off + half - 1) >> 16
    return [y, cb, cr]


def encode_jpeg(img: np.ndarray, quality: int = 75,
                subsampling: str = "4:2:0") -> bytes:
    """A baseline JPEG (JFIF, one interleaved scan, the standard Huffman
    tables) of a uint8 [H, W] grey or [H, W, 3] RGB image. `subsampling`
    is the chroma's: "4:4:4", "4:2:2", "4:2:0" or "4:4:0"."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (
            img.ndim == 3 and img.shape[2] != 3):
        raise ValueError("encode_jpeg takes uint8 [H, W] or [H, W, 3]")
    h, w = img.shape[:2]
    grey = img.ndim == 2
    hs, vs = (1, 1) if grey else _SAMPLING[subsampling]
    mcux, mcuy = _cdiv(w, 8 * hs), _cdiv(h, 8 * vs)
    pad_w, pad_h = mcux * 8 * hs, mcuy * 8 * vs
    # edges repeated as libjpeg pads them: the columns out to the MCU, the
    # rows to the chroma's row group, then each plane's rows to its MCU
    # (the chroma's after downsampling)
    group_h = _cdiv(h, vs) * vs
    planes = [img.astype(np.int32)] if grey else _rgb_to_ycc(img)
    planes = [np.pad(p, ((0, group_h - h), (0, pad_w - w)), mode="edge")
              for p in planes]
    if not grey and (hs, vs) != (1, 1):
        # chroma: each hs x vs box's mean, rounded as libjpeg's `jcsample.c`
        # (2x2 and 2x1 with a bias alternating along the row)
        n = hs * vs
        bias = n // 2
        if hs == 2:
            bias = np.arange(pad_w // hs) % 2 + (1 if vs == 2 else 0)
        for i in (1, 2):
            p = planes[i].reshape(group_h // vs, vs, pad_w // hs, hs).sum(
                (1, 3))
            planes[i] = (p + bias) // n
    planes = [np.pad(p, ((0, (pad_h if i == 0 else pad_h // vs)
                          - p.shape[0]), (0, 0)), mode="edge")
              for i, p in enumerate(planes)]
    tables = jpeg_quant_tables(quality)
    samp = [(hs, vs), (1, 1), (1, 1)][:len(planes)]
    qsel = [0, 1, 1][:len(planes)]
    # every component's quantized blocks in scan order, zigzag
    per_mcu = []
    for p, (ch, cv), t in zip(planes, samp, qsel):
        rows, cols = p.shape
        blocks = (p.reshape(rows // 8, 8, cols // 8, 8).transpose(0, 2, 1, 3)
                  .reshape(-1, 8, 8).astype(np.int64) - 128)
        qz = _fdct_quantize(blocks, tables[t]).reshape(rows // 8,
                                                       cols // 8, 64)
        if (ch, cv) != (1, 1):
            # blocks past the image that fill its last MCUs: libjpeg's
            # dummy blocks (`jccoefct.c`), the DC of the block before
            # them in the MCU and no AC
            wb, hb = _cdiv(w, 8), _cdiv(h, 8)
            qz[:, wb:] = 0
            qz[:, wb:, 0] = qz[:, wb - 1:wb, 0]
            last = (np.arange(cols // 8) // ch) * ch + ch - 1
            qz[hb:] = 0
            qz[hb:, :, 0] = qz[hb - 1, last, 0]
        qz = qz.reshape(mcuy, cv, mcux, ch, 64).transpose(0, 2, 1, 3, 4)
        per_mcu.append(qz.reshape(mcuy * mcux, cv * ch, 64))
    order = np.concatenate(per_mcu, 1)                    # [M, blocks, 64]
    comp_of = np.concatenate([np.full(x.shape[1], i)
                              for i, x in enumerate(per_mcu)])
    coefs = order.reshape(-1, 64)
    comp = np.tile(comp_of, mcux * mcuy)
    # DC differences per component in scan order
    dc = coefs[:, 0].copy()
    diff = np.zeros_like(dc)
    for i in range(len(per_mcu)):
        sel = comp == i
        d = dc[sel]
        diff[sel] = np.diff(d, prepend=0)
    huff = [_huff_codes(bytes.fromhex(c), bytes.fromhex(s))
            for c, s in _STD_HUFF]
    dc_tab = np.where(comp == 0, 0, 2)
    ac_tab = dc_tab + 1
    n_blocks = len(coefs)
    keys, codes, lens = [], [], []

    def add(key, tab, sym, extra, nbits):
        code = np.zeros(len(sym), np.uint64)
        clen = np.zeros(len(sym), np.int64)
        for t in np.unique(tab):
            sel = tab == t
            code[sel] = huff[t][0][sym[sel]]
            clen[sel] = huff[t][1][sym[sel]]
        keys.append(key)
        codes.append((code << nbits.astype(np.uint64))
                     | extra.astype(np.uint64))
        lens.append(clen + nbits)

    def magnitude(v, s):
        return np.where(v >= 0, v, v + (np.int64(1) << s) - 1) & (
            (np.int64(1) << s) - 1)

    blk = np.arange(n_blocks, dtype=np.int64)
    s = _bit_count(diff)
    add(blk * 256, dc_tab, s, magnitude(diff, s), s)
    ac = coefs[:, 1:]
    b_i, p_i = np.nonzero(ac)
    p_i = p_i + 1
    v = ac[b_i, p_i - 1]
    first = np.ones(len(b_i), bool)
    first[1:] = b_i[1:] != b_i[:-1]
    prev = np.where(first, 0, np.concatenate([[0], p_i[:-1]]))
    run = p_i - prev - 1
    n_zrl = run // 16
    if n_zrl.any():
        zb = np.repeat(b_i, n_zrl)
        zp = np.repeat(p_i, n_zrl)
        z = np.full(len(zb), 0xF0)
        add(zb * 256 + 2 * zp - 1, ac_tab[zb], z, np.zeros(len(zb)),
            np.zeros(len(zb), np.int64))
    s = _bit_count(v)
    add(b_i * 256 + 2 * p_i, ac_tab[b_i], (run % 16) * 16 + s,
        magnitude(v, s), s)
    last = np.zeros(n_blocks, np.int64)
    if len(b_i):
        ends = np.nonzero(np.append(b_i[1:] != b_i[:-1], True))[0]
        last[b_i[ends]] = p_i[ends]
    eob = np.nonzero(last < 63)[0]
    add(eob * 256 + 255, ac_tab[eob], np.zeros(len(eob), np.int64),
        np.zeros(len(eob)), np.zeros(len(eob), np.int64))
    key = np.concatenate(keys)
    srt = np.argsort(key, kind="stable")
    code = np.concatenate(codes)[srt]
    length = np.concatenate(lens)[srt]
    data = _pack_bits(code, length)

    def seg(marker, body):
        return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body

    out = [JPEG_SOI, seg(0xE0, b"JFIF\0\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for i in range(1 if grey else 2):
        out.append(seg(0xDB, bytes([i]) + tables[i].astype(np.uint8)
                       .tobytes()))
    sof = struct.pack(">BHHB", 8, h, w, len(planes))
    for i, (ch, cv) in enumerate(samp):
        sof += bytes([i + 1, ch * 16 + cv, qsel[i]])
    out.append(seg(0xC0, sof))
    for k, (c, sy) in enumerate(_STD_HUFF[:2] if grey else _STD_HUFF):
        out.append(seg(0xC4, bytes([(k % 2) * 16 + k // 2])
                       + bytes.fromhex(c) + bytes.fromhex(sy)))
    sos = bytes([len(planes)])
    for i in range(len(planes)):
        sos += bytes([i + 1, 0x00 if i == 0 else 0x11])
    out.append(seg(0xDA, sos + b"\x00\x3f\x00"))
    out += [data, b"\xff\xd9"]
    return b"".join(out)


def _pack_bits(code: np.ndarray, length: np.ndarray) -> bytes:
    """The entropy-coded bytes of codes (uint64, at most 32 bits each) of
    the given lengths, in order: big-endian 32-bit words summed from each
    code's two shifted halves (the codes' bits never overlap), the last
    byte padded with ones, 0xFF bytes stuffed with 0x00."""
    total = int(length.sum())
    if total == 0:
        return b""
    start = np.cumsum(length) - length
    word = start >> 5
    shift = (64 - (start & 31) - length).astype(np.uint64)
    v = code << shift
    n_words = total // 32 + 2
    hi = np.bincount(word, weights=(v >> np.uint64(32)).astype(np.float64),
                     minlength=n_words)
    lo = np.bincount(word + 1, weights=(v & np.uint64(0xFFFFFFFF))
                     .astype(np.float64), minlength=n_words)
    words = (hi + lo).astype(np.uint64).astype(">u4")
    out = np.frombuffer(words.tobytes(), np.uint8)[:_cdiv(total, 8)].copy()
    if total % 8:
        out[-1] |= (1 << (8 - total % 8)) - 1
    ff = np.nonzero(out == 0xFF)[0]
    return np.insert(out, ff + 1, 0).tobytes()


def write_jpeg(path: str, img: np.ndarray, quality: int = 75,
               subsampling: str = "4:2:0") -> None:
    """Write `encode_jpeg(img, quality, subsampling)` to `path`."""
    with open(path, "wb") as f:
        f.write(encode_jpeg(img, quality, subsampling))


# --------------------------------------------------------------- resizing

_PRECISION_BITS = 32 - 8 - 2


def _triangle(x: float) -> float:
    x = abs(x)
    return 1.0 - x if x < 1.0 else 0.0


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x *= math.pi
    return math.sin(x) / x


def _lanczos(x: float) -> float:
    return _sinc(x) * _sinc(x / 3) if -3.0 <= x < 3.0 else 0.0


_FILTERS = {"bilinear": (_triangle, 1.0), "lanczos": (_lanczos, 3.0)}


def _coeffs(in_size: int, out_size: int, kind: str):
    """Pillow's `precompute_coeffs` + `normalize_coeffs_8bpc` for the
    filter `kind`: per output pixel the first source pixel, and integer
    weights [out, ksize] (zero past each pixel's own taps)."""
    filt, fsupport = _FILTERS[kind]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = fsupport * filterscale
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
            w = filt((x + xmin - center + 0.5) * ss)
            ws.append(w)
            ww += w
        for x in range(xmax):
            w = ws[x] / ww if ww != 0.0 else ws[x]
            kk[xx, x] = int((-0.5 if w < 0 else 0.5)
                            + w * (1 << _PRECISION_BITS))
        xmins[xx] = xmin
    return xmins, kk


def _resample_axis(img: np.ndarray, out_size: int, axis: int,
                   kind: str) -> np.ndarray:
    """One pass of Pillow's 8-bit resampling along `axis` of [H, W, C]
    (int32 sums, as Pillow's)."""
    in_size = img.shape[axis]
    xmins, kk = _coeffs(in_size, out_size, kind)
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


def _resize(img: np.ndarray, size: tuple[int, int], kind: str,
            what: str) -> np.ndarray:
    _check_resizable(img, what)
    if img.ndim == 3 and img.shape[2] != 3:
        raise ValueError(f"{what} takes grey or RGB images (Pillow resizes "
                         "alpha images premultiplied)")
    w, h = size
    out = img
    if w != img.shape[1]:
        out = _resample_axis(out, w, 1, kind)
    if h != img.shape[0]:
        out = _resample_axis(out, h, 0, kind)
    return out.copy() if out is img else out


def resize_bilinear(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """`PIL.Image.fromarray(img).resize(size, BILINEAR)` of a uint8 grey
    [H, W] or RGB [H, W, 3] image; `size` is (width, height) as Pillow
    takes it."""
    return _resize(img, size, "bilinear", "resize_bilinear")


def resize_lanczos(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """`PIL.Image.fromarray(img).resize(size, LANCZOS)` of a uint8 grey
    [H, W] or RGB [H, W, 3] image; `size` is (width, height)."""
    return _resize(img, size, "lanczos", "resize_lanczos")


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
