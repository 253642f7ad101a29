"""Image files and the host image operations of the data path, without cv2.

The port's counterpart of the cv2 calls in hipie_tpu/data/{transforms,
datasets,mapper}.py and tools/make_tiny_coco.py, in numpy and the standard
library's ``zlib``:

  * ``read_png`` / ``write_png``: 8-bit grey, RGB and RGBA PNG, non-interlaced,
    all five scanline filters on read (the writer uses filter 0, None);
  * ``load_image``: an RGB uint8 image from a file. PNG is read here and JPEG
    (COCO's, RefCOCO's and ADE's images) by the port's own decoder
    (hipie_torch/native/jpeg.cpp, built with g++ at first use: libjpeg-turbo's
    arithmetic, so within one level of cv2.imread); any other format goes
    through PIL, imported at call time, and without PIL the call raises naming
    the file and its format;
  * ``write_jpeg``: baseline JPEG, 4:2:0, quality 95 by default (cv2.imwrite's
    defaults);
  * ``resize_bilinear``: cv2.INTER_LINEAR's geometry (half-pixel centres,
    edge clamping, no antialiasing) on a uint8 or float (H, W[, C]) array;
    a uint8 result is rounded, where cv2 uses 11-bit fixed-point weights, so
    the two differ by at most 1;
  * ``resize_nearest``: cv2.INTER_NEAREST (source index floor(x * src / dst)
    in cv2's double arithmetic, clamped), the floor rule of the predictor's
    ``resize_nearest``;
  * ``fill_polygon``: cv2.fillPoly of integer vertices: each scanline filled
    from the first pixel centre right of the left edge to the last one left of
    the right edge, plus the outline traced as cv2 traces it (8-connected
    Bresenham); pixels differ from cv2 only on the boundary.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Sequence, Tuple

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}          # PNG colour type -> channels (grey, RGB, RGBA)


# -- PNG -------------------------------------------------------------------

def _chunks(data: bytes):
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IEND":
            return


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline filters (PNG spec 9.2) -> (h, stride) uint8."""
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        row = raw[y * (stride + 1):(y + 1) * (stride + 1)]
        kind = row[0]
        cur = np.frombuffer(row, np.uint8, stride, 1)
        if kind == 0:                                   # None
            rec = cur.copy()
        elif kind == 1:                                 # Sub: running sum per channel
            rec = (np.cumsum(cur.reshape(-1, bpp).astype(np.int64), 0) % 256
                   ).astype(np.uint8).reshape(-1)
        elif kind == 2:                                 # Up
            rec = cur + prev
        elif kind in (3, 4):                            # Average, Paeth: left to right
            r = bytearray(cur.tobytes())
            up = prev.tobytes()
            for i in range(stride):
                a = r[i - bpp] if i >= bpp else 0
                if kind == 3:
                    r[i] = (r[i] + ((a + up[i]) >> 1)) & 0xFF
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    r[i] = (r[i] + _paeth(a, up[i], c)) & 0xFF
            rec = np.frombuffer(bytes(r), np.uint8)
        else:
            raise ValueError(f"PNG: unknown filter type {kind} in row {y}")
        out[y] = rec
        prev = rec
    return out


def read_png(path_or_bytes) -> np.ndarray:
    """An 8-bit PNG -> (H, W) grey or (H, W, 3|4) uint8, as stored (RGB order)."""
    data = path_or_bytes
    if not isinstance(data, (bytes, bytearray)):
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file" + (f": {path_or_bytes}" if isinstance(
            path_or_bytes, str) else ""))
    idat, header = [], None
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError(f"PNG: only 8-bit non-interlaced grey/RGB/RGBA is read "
                         f"(bit depth {depth}, colour type {ctype}, interlace {interlace})")
    ch = _CHANNELS[ctype]
    img = _unfilter(zlib.decompress(b"".join(idat)), h, w * ch, ch)
    return img.reshape(h, w) if ch == 1 else img.reshape(h, w, ch)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(
        ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def write_png(path: str, img: np.ndarray) -> None:
    """(H, W) grey or (H, W, 3|4) uint8 -> a PNG file (filter 0 on every row)."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"PNG: uint8 only, got {img.dtype}")
    ch = 1 if img.ndim == 2 else img.shape[2]
    ctype = {1: 0, 3: 2, 4: 6}.get(ch)
    if ctype is None:
        raise ValueError(f"PNG: 1, 3 or 4 channels, got shape {img.shape}")
    h, w = img.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * ch)], 1)
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))


def write_jpeg(path: str, img: np.ndarray, quality: int = 95) -> None:
    """(H, W, 3) RGB or (H, W) grey uint8 -> a baseline JPEG file (4:2:0 for
    colour, the Annex-K tables at ``quality``)."""
    from hipie_torch.native.jpeg import encode_jpeg

    data = encode_jpeg(img, quality)
    with open(path, "wb") as f:
        f.write(data)


def _format_of(head: bytes, path: str) -> str:
    if head[:8] == PNG_SIGNATURE:
        return "PNG"
    if head[:3] == b"\xff\xd8\xff":
        return "JPEG"
    if head[:4] in (b"II*\x00", b"MM\x00*"):
        return "TIFF"
    return os.path.splitext(path)[1].lstrip(".").upper() or "unknown"


def load_image(path: str, color: bool = True) -> np.ndarray:
    """An image file -> (H, W, 3) uint8 RGB (grey repeated, alpha dropped, a
    JPEG's EXIF orientation applied, as cv2.IMREAD_COLOR gives it after BGR ->
    RGB); ``color=False`` returns the stored array (label maps: grey PNG,
    16-bit TIFF). PNG and JPEG are read here; other formats need PIL, imported
    here at call time."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    with open(path, "rb") as f:
        data = f.read()
    fmt = _format_of(data[:8], path)
    if fmt == "PNG":
        img = read_png(data)
    elif fmt == "JPEG":
        from hipie_torch.native.jpeg import decode_jpeg

        img = decode_jpeg(data, path)
    else:
        try:
            from PIL import Image
        except ImportError as e:
            raise RuntimeError(f"{path}: {fmt} images need PIL, which is not installed; "
                               f"the port reads PNG itself (convert the dataset's images "
                               f"to PNG)") from e
        with Image.open(path) as im:
            img = np.asarray(im.convert("RGB") if color else im)
    if not color:
        return img
    if img.ndim == 2:
        return np.repeat(img[:, :, None], 3, 2)
    return np.ascontiguousarray(img[:, :, :3])


# -- resizing ----------------------------------------------------------------

def _linear_taps(src: int, dst: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """cv2.INTER_LINEAR's source taps (i0, i1) and weight of i1 for each output."""
    scale = src / dst
    f = (np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5
    i0 = np.floor(f).astype(np.int64)
    w = (f - i0).astype(np.float32)
    low = i0 < 0
    i0[low], w[low] = 0, 0.0
    high = i0 >= src - 1
    i0[high], w[high] = src - 1, 0.0
    return i0, np.minimum(i0 + 1, src - 1), w


def resize_bilinear(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """(H, W[, C]) -> (h, w[, C]) with cv2.INTER_LINEAR's geometry. uint8 in,
    uint8 out (rounded); float in, float32 out."""
    h, w = size
    y0, y1, wy = _linear_taps(img.shape[0], h)
    x0, x1, wx = _linear_taps(img.shape[1], w)
    src = img.astype(np.float32)
    shape = (-1,) + (1,) * (img.ndim - 1)
    rows = src[y0] * (1 - wy).reshape(shape) + src[y1] * wy.reshape(shape)
    shape = (1, -1) + (1,) * (img.ndim - 2)
    out = rows[:, x0] * (1 - wx).reshape(shape) + rows[:, x1] * wx.reshape(shape)
    if img.dtype == np.uint8:
        return np.clip(np.floor(out + 0.5), 0, 255).astype(np.uint8)
    return out


def _nearest_index(src: int, dst: int) -> np.ndarray:
    inv = dst / src                        # cv2: ifx = 1 / inv_scale_x, sx = floor(x * ifx)
    return np.minimum(np.floor(np.arange(dst) * (1.0 / inv)).astype(np.int64), src - 1)


def resize_nearest(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """(H, W[, C]) -> (h, w[, C]) with cv2.INTER_NEAREST's source indices."""
    h, w = size
    return img[_nearest_index(img.shape[0], h)][:, _nearest_index(img.shape[1], w)]


# -- polygons ----------------------------------------------------------------

def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """cv2.clipLine: the segment's ends moved onto the image rectangle
    (integer arithmetic truncating toward zero); None if it misses it."""
    right, bottom = w - 1, h - 1
    code = lambda x, y: (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8
    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1, c1 = a, (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2, c2 = a, (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1, c1 = a, 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2, c2 = a, 0
    return None if (c1 | c2) else (x1, y1, x2, y2)


def _draw_line(m: np.ndarray, x0: int, y0: int, x1: int, y1: int, value) -> None:
    """8-connected Bresenham line from (x0, y0) to (x1, y1), clipped to the
    array and traced left to right as cv2's LineIterator does."""
    clipped = _clip_line(m.shape[1], m.shape[0], x0, y0, x1, y1)
    if clipped is None:
        return
    x0, y0, x1, y1 = clipped
    if x1 < x0:
        x0, y0, x1, y1 = x1, y1, x0, y0
    dx, dy = x1 - x0, abs(y1 - y0)
    sy = -1 if y1 < y0 else 1
    y_major = dy > dx
    major, minor = (dy, dx) if y_major else (dx, dy)
    err = major - 2 * minor
    xs, ys = np.empty(major + 1, np.int64), np.empty(major + 1, np.int64)
    x, y = x0, y0
    for i in range(major + 1):
        xs[i], ys[i] = x, y
        step_minor = err < 0
        err += -2 * minor + (2 * major if step_minor else 0)
        if y_major:
            y += sy
            x += 1 if step_minor else 0
        else:
            x += 1
            y += sy if step_minor else 0
    m[ys, xs] = value


def fill_polygon(m: np.ndarray, polys: Sequence[np.ndarray], value=1) -> np.ndarray:
    """Fill polygons of integer (x, y) vertices into ``m`` in place (even-odd
    rule over the scanlines at pixel centres, then the outline); returns ``m``."""
    h, w = m.shape[:2]
    for poly in polys:
        pts = np.asarray(poly, np.int64).reshape(-1, 2)
        if len(pts) == 0:
            continue
        xa, ya = pts[:, 0].astype(np.float64), pts[:, 1].astype(np.float64)
        xb, yb = np.roll(xa, -1), np.roll(ya, -1)
        for y in range(max(int(ya.min()), 0), min(int(ya.max()), h - 1) + 1):
            # edges crossing the scanline (half-open in y, so a vertex counts once)
            cross = ((ya <= y) & (yb > y)) | ((yb <= y) & (ya > y))
            if not cross.any():
                continue
            xc = np.sort(xa[cross] + (y - ya[cross]) * (xb[cross] - xa[cross])
                         / (yb[cross] - ya[cross]))
            for left, right in zip(xc[0::2], xc[1::2]):
                lo, hi = max(int(np.ceil(left)), 0), min(int(np.floor(right)), w - 1)
                if lo <= hi:
                    m[y, lo:hi + 1] = value
        for (p, q) in zip(pts, np.roll(pts, -1, 0)):
            _draw_line(m, int(p[0]), int(p[1]), int(q[0]), int(q[1]), value)
    return m
