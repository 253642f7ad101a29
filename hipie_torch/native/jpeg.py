"""ctypes bindings for the JPEG decoder and encoder (jpeg.cpp).

jpeg.cpp is built with g++ at first use into ``hipie_torch/_build/native/``
(``hipie_torch.native.build_library``, as evalcore.cpp is). There is no
fallback: where the build fails, every call raises with the compiler's
message.

  * ``decode_jpeg(data, name)``: the file's bytes -> (H, W, 3) uint8 RGB, as
    ``cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1]`` gives it (grey repeated;
    the EXIF orientation applied as cv2 applies it). Arithmetic-coded,
    12-bit, lossless, hierarchical, CMYK and RGB/Adobe-transformed files raise
    ``ValueError`` naming ``name`` and the marker.
  * ``encode_jpeg(img, quality=95)``: (H, W, 3) RGB or (H, W) grey uint8 ->
    the bytes of a baseline JPEG, 4:2:0 for colour, the Annex-K tables at
    ``quality``: what ``cv2.imwrite`` writes by default.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

from hipie_torch.native import build_library

_SRC = os.path.join(os.path.dirname(__file__), "jpeg.cpp")
_lib: Optional[ctypes.CDLL] = None
_ERR = 512


def get_lib() -> ctypes.CDLL:
    """The built library (compiled on first use); raises RuntimeError with
    g++'s message where it cannot be built."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build_library(_SRC))
    lib.hipie_jpeg_info.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                                    ctypes.c_char_p, ctypes.c_int]
    lib.hipie_jpeg_decode.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                                      ctypes.c_char_p, ctypes.c_int]
    lib.hipie_jpeg_encode.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
                                      ctypes.c_char_p, ctypes.c_int]
    lib.hipie_jpeg_encode.restype = ctypes.c_int64
    _lib = lib
    return lib


def apply_orientation(img: np.ndarray, orientation: int) -> np.ndarray:
    """EXIF orientation 1-8 applied as OpenCV's ExifTransform does."""
    flip_h = lambda a: a[:, ::-1]
    flip_v = lambda a: a[::-1]
    t = lambda a: np.swapaxes(a, 0, 1)
    ops = {1: lambda a: a, 2: flip_h, 3: lambda a: a[::-1, ::-1], 4: flip_v, 5: t,
           6: lambda a: flip_h(t(a)), 7: lambda a: t(a)[::-1, ::-1], 8: lambda a: flip_v(t(a))}
    return np.ascontiguousarray(ops[orientation](img))


def jpeg_info(data: bytes, name: str = "<bytes>") -> dict:
    """height, width, components, orientation, progressive of a JPEG's header."""
    lib = get_lib()
    info = np.zeros(5, np.int32)
    err = ctypes.create_string_buffer(_ERR)
    if lib.hipie_jpeg_info(data, len(data), info.ctypes.data, err, _ERR):
        raise ValueError(f"{name}: JPEG: {err.value.decode()}")
    return dict(zip(("height", "width", "components", "orientation", "progressive"),
                    (int(v) for v in info)))


def decode_jpeg(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """A JPEG file's bytes -> (H, W, 3) uint8 RGB, the EXIF orientation applied."""
    lib = get_lib()
    info = jpeg_info(data, name)
    out = np.empty((info["height"], info["width"], 3), np.uint8)
    err = ctypes.create_string_buffer(_ERR)
    if lib.hipie_jpeg_decode(data, len(data), out.ctypes.data, err, _ERR):
        raise ValueError(f"{name}: JPEG: {err.value.decode()}")
    return apply_orientation(out, info["orientation"])


def encode_jpeg(img: np.ndarray, quality: int = 95) -> bytes:
    """(H, W, 3) RGB or (H, W) grey uint8 -> baseline JPEG bytes."""
    lib = get_lib()
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[:, :, 0]
    if not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"JPEG: 1 or 3 channels, got shape {img.shape}")
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else 3
    err = ctypes.create_string_buffer(_ERR)
    cap = h * w * ch + 4096
    while True:
        out = np.empty(cap, np.uint8)
        n = lib.hipie_jpeg_encode(img.ctypes.data, h, w, ch, int(quality), out.ctypes.data, cap,
                                  err, _ERR)
        if n == 0:
            raise ValueError(f"JPEG encode: {err.value.decode()}")
        if n > 0:
            return out[:n].tobytes()
        cap = -n
