"""ctypes bindings for the native evaluation kernels (evalcore.cpp).

The port's copy of hipie_tpu/native/__init__.py. evalcore.cpp (a copy of the
JAX package's) is built with g++ at first use into
``hipie_torch/_build/native/``, under a name keyed by the host CPU's features
and the source's hash (the library is compiled ``-march=native``, so one
built on another host is never loaded); ``build_library`` builds jpeg.cpp the
same way. Without g++, or if the build fails,
``available()`` is False and hipie_torch/evaluation uses its numpy versions,
which give the same results; ``status()`` says which one runs.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import platform
import subprocess
from typing import Optional

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "evalcore.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "_build", "native")
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def _fingerprint(src: str) -> str:
    """Host CPU flags + source hash."""
    parts = []
    try:
        with open("/proc/cpuinfo") as f:
            parts += [line for line in f if line.startswith("flags")][:1]
    except OSError:
        pass
    if not parts:
        parts.append(platform.processor())
    with open(src, "rb") as f:
        parts.append(hashlib.sha1(f.read()).hexdigest())
    return hashlib.sha1("|".join(parts).encode()).hexdigest()[:10]


def library_path(src: str) -> str:
    """Where ``src`` (a C++ file of this directory) is built for this host."""
    stem = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(_BUILD_DIR, f"_{stem}-{_fingerprint(src)}.so")


def build_library(src: str) -> str:
    """Compile ``src`` with g++ into ``library_path(src)`` unless it is there;
    returns the path, or raises RuntimeError with the compiler's message.
    Compiles to a temporary name and renames, so that a concurrent reader
    never loads a half-written library; removes builds for other hosts."""
    path = library_path(src)
    if os.path.exists(path):
        return path
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC", "-o",
                        tmp, src], check=True, capture_output=True, text=True, timeout=180)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"building {src} failed: {type(e).__name__}: "
                           f"{getattr(e, 'stderr', '') or e}") from e
    os.replace(tmp, path)
    stem = os.path.splitext(os.path.basename(src))[0]
    for old in glob.glob(os.path.join(_BUILD_DIR, f"_{stem}-*.so")):
        if old != path:
            try:
                os.remove(old)
            except OSError:
                pass
    return path


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _build_error
    if _lib is None and _build_error is None:
        try:
            path = build_library(_SRC)
        except RuntimeError as e:
            _build_error = str(e)
        else:
            lib = ctypes.CDLL(path)
            lib.mask_iou.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
            lib.coco_match.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
            _lib = lib
    return _lib


def available() -> bool:
    return get_lib() is not None


def status() -> str:
    """"evalcore <library>" when the native library is loaded, else "numpy
    fallback (<why>)"."""
    if available():
        return f"evalcore {os.path.relpath(library_path(_SRC), os.path.dirname(_BUILD_DIR))}"
    return f"numpy fallback ({_build_error or 'no library'})"


def mask_iou_native(dets: np.ndarray, gts: np.ndarray,
                    iscrowd: np.ndarray) -> np.ndarray:
    """dets (nd, hw) uint8, gts (ng, hw) uint8 -> (nd, ng) float64."""
    lib = get_lib()
    nd, hw = dets.shape
    ng = gts.shape[0]
    out = np.zeros((nd, ng), np.float64)
    dets = np.ascontiguousarray(dets, np.uint8)
    gts = np.ascontiguousarray(gts, np.uint8)
    crowd = np.ascontiguousarray(iscrowd, np.uint8)
    lib.mask_iou(dets.ctypes.data, nd, gts.ctypes.data, ng, hw,
                 crowd.ctypes.data, out.ctypes.data)
    return out


def coco_match_native(ious: np.ndarray, gt_ignore: np.ndarray,
                      gt_iscrowd: np.ndarray, thrs: np.ndarray):
    lib = get_lib()
    D, G = ious.shape
    T = len(thrs)
    dt_m = np.zeros((T, D), np.uint8)
    dt_ig = np.zeros((T, D), np.uint8)
    gt_m = np.zeros((T, G), np.int64)
    ious = np.ascontiguousarray(ious, np.float64)
    lib.coco_match(ious.ctypes.data, D, G,
                   np.ascontiguousarray(gt_ignore, np.uint8).ctypes.data,
                   np.ascontiguousarray(gt_iscrowd, np.uint8).ctypes.data,
                   np.ascontiguousarray(thrs, np.float64).ctypes.data, T,
                   dt_m.ctypes.data, dt_ig.ctypes.data, gt_m.ctypes.data)
    return dt_m.astype(bool), dt_ig.astype(bool), gt_m
