"""Build the port's CUDA kernels with nvcc and load them through ctypes.

All sources under ``hipie_torch/csrc/`` compile, at first use, into one shared
library with a plain C interface, for ``sm_90a``: one nvcc per source, all
started together, then one link:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC \
         -Xptxas -v -c -o <name>.o hipie_torch/csrc/<name>.cu        # each source
    nvcc -shared -o hipie_torch/_build/<hash>/libhipie_kernels.so *.o

The output directory is keyed by a hash of the sources, the headers they
include (``*.cuh``) and the flags, so an edited kernel or header rebuilds and
an unchanged build loads at once. Nothing here runs at import time: ``load()``
is called by the kernel wrappers when a CUDA tensor reaches them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
LIB_NAME = "libhipie_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_vp = ctypes.c_void_p
_int = ctypes.c_int
# C entry points: name -> argtypes. Every entry returns cudaGetLastError().
_SIGNATURES = {
    "hipie_vit_attention": [_vp, _vp, _vp, _vp, _vp, _vp, _vp,
                            _int, _int, _int, _int, _int, ctypes.c_float, _vp],
    "hipie_vit_attention_bwd": [_vp] * 14 + [_int, _int, _int, _int, _int, ctypes.c_float, _vp],
    "hipie_vit_attention_bwd_design": [_int, _int, _int, _int],
    "hipie_ms_deform_attn": [_vp, _vp, _vp, _vp, _vp, _vp, _int, _int, _int, _int, _int,
                             _int, _int, _int, _int, _int, _int, _vp],
    "hipie_ms_deform_attn_constants": [_vp],
    "hipie_msda_reduce": [_vp, _vp, _vp, ctypes.c_longlong, _int, _int, _int, _vp],
    "hipie_ms_deform_attn_bwd": [_vp] * 9 + [_int] * 10 + [_vp, _int, _vp, ctypes.c_longlong,
                                                           _vp, _vp],
    "hipie_ms_deform_attn_bwd_design": [_vp] + [_int] * 7,
    "hipie_ms_deform_attn_bwd_scratch_bytes": [_vp] + [_int] * 8 + [_vp],
    "hipie_ms_deform_attn_bwd_constants": [_vp],
    "hipie_nms": [_vp, _vp, _vp, _int, ctypes.c_float, _vp, _vp, _vp],
    "hipie_nms_max_boxes": [],
}


class BuildInfo:
    """What the last build did: library path, seconds, and nvcc's ptxas report."""

    def __init__(self, path: Path, seconds: float, log: str, cached: bool):
        self.path = path
        self.seconds = seconds
        self.log = log
        self.cached = cached


_lib: Optional[ctypes.CDLL] = None
_info: Optional[BuildInfo] = None


def _sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def _hashed():
    """Every file a build reads: the sources and the headers they include."""
    return sorted([*CSRC_DIR.glob("*.cu"), *CSRC_DIR.glob("*.cuh")])


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed")


def build() -> BuildInfo:
    """Compile the kernels if the sources changed; return the build record."""
    global _info
    if _info is not None:
        return _info
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _hashed():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out_dir = BUILD_DIR / h.hexdigest()[:16]
    lib = out_dir / LIB_NAME
    log_file = out_dir / "nvcc.log"
    if lib.is_file():
        log = log_file.read_text() if log_file.is_file() else ""
        _info = BuildInfo(lib, 0.0, log, cached=True)
        return _info
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in _sources()]
        compiles = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                    for src, obj in zip(_sources(), objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True) for cmd in compiles]
        outs = [proc.communicate()[0] for proc in procs]     # wait for every compile
        log = "".join(outs)
        for cmd, proc, out in zip(compiles, procs, outs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
        tmp_lib = Path(tmp) / LIB_NAME
        link = [nvcc, "-shared", "-o", str(tmp_lib), *map(str, objs)]
        res = subprocess.run(link, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{' '.join(link)}\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(tmp_lib, lib)
    log_file.write_text(log)
    _info = BuildInfo(lib, time.perf_counter() - t0, log, cached=False)
    return _info


def load() -> ctypes.CDLL:
    """Build if needed and return the loaded library with typed entry points."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build().path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: launch failed with cudaError {err}")
