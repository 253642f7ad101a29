"""The port's JPEG decoder and encoder (hipie_torch/native/jpeg.cpp, through
hipie_torch/native/jpeg.py and data/image_io.py) against cv2, JAX's reader
(``cv2.imread(path, IMREAD_COLOR)``, hipie_tpu/data/datasets.py).

The decoder must give cv2's RGB within one level on every value and a mean
|difference| of at most 0.01, on files written here by cv2 and PIL: baseline
4:4:4, 4:2:2, 4:2:0 and 4:4:0, grey, progressive (cv2's and PIL's scans, every
subsampling), restart intervals, every EXIF orientation, odd sizes; and on the
files committed under tests/data/jpeg/ against cv2's decodes committed beside
them (the check chip_smoke.py repeats on the card's machine, which has no cv2).
Arithmetic-coded, 12-bit, lossless and CMYK files raise, naming the file and
the marker. cv2 decodes the encoder's files, and the port's decode of them is
within the same bound of cv2's.
"""

import torch_threads  # noqa: F401  (first: sizes torch's CPU threads)
import glob
import io
import os
import re

import cv2
import numpy as np
import pytest
from PIL import Image

from hipie_torch.data.image_io import load_image, read_png, write_jpeg
from hipie_torch.native.jpeg import decode_jpeg, encode_jpeg, jpeg_info

DATA = os.path.join(os.path.dirname(__file__), "data", "jpeg")


def _picture(h, w, seed=0, noise=12.0):
    r = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 110 * np.sin(x / 5.0 + c) * np.cos(y / 8.0 - c) for c in range(3)], -1)
    return np.clip(img + r.randn(h, w, 3) * noise, 0, 255).astype(np.uint8)


def _cv2_rgb(data: bytes) -> np.ndarray:
    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)[..., ::-1]


def _within_bound(got, want, name):
    assert got.shape == want.shape, (name, got.shape, want.shape)
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1 and d.mean() <= 0.01, (name, int(d.max()), float(d.mean()))


def _cases():
    """name -> JPEG bytes, written by cv2 and PIL."""
    out = {}
    sf = cv2.IMWRITE_JPEG_SAMPLING_FACTOR
    for h, w in ((48, 64), (37, 53), (17, 9), (203, 129)):
        img = _picture(h, w, seed=h)
        bgr = np.ascontiguousarray(img[..., ::-1])
        enc = lambda a, *p: cv2.imencode(".jpg", a, list(p))[1].tobytes()
        tag = f"{h}x{w}"
        out[f"cv2_420_{tag}"] = enc(bgr)
        for name in ("444", "422", "440"):
            out[f"cv2_{name}_{tag}"] = enc(bgr, sf, getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{name}"))
        out[f"cv2_progressive_{tag}"] = enc(bgr, cv2.IMWRITE_JPEG_PROGRESSIVE, 1)
        out[f"cv2_restart_{tag}"] = enc(bgr, cv2.IMWRITE_JPEG_RST_INTERVAL, 3)
        out[f"cv2_restart_progressive_{tag}"] = enc(bgr, cv2.IMWRITE_JPEG_RST_INTERVAL, 1,
                                                    cv2.IMWRITE_JPEG_PROGRESSIVE, 1)
        out[f"cv2_optimized_q40_{tag}"] = enc(bgr, cv2.IMWRITE_JPEG_OPTIMIZE, 1,
                                              cv2.IMWRITE_JPEG_QUALITY, 40)
        grey = cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY)
        out[f"cv2_grey_{tag}"] = enc(grey)
        out[f"cv2_grey_progressive_{tag}"] = enc(grey, cv2.IMWRITE_JPEG_PROGRESSIVE, 1)
        for ss in (0, 1, 2):
            for prog in (False, True):
                b = io.BytesIO()
                Image.fromarray(img).save(b, "JPEG", subsampling=ss, progressive=prog, quality=88)
                out[f"pil_ss{ss}_{'progressive' if prog else 'baseline'}_{tag}"] = b.getvalue()
    img = _picture(23, 37, seed=5)
    for o in range(1, 9):
        exif = Image.Exif()
        exif[0x0112] = o
        b = io.BytesIO()
        Image.fromarray(img).save(b, "JPEG", exif=exif.tobytes(), quality=90)
        out[f"pil_exif_orientation_{o}"] = b.getvalue()
    return out


CASES = _cases()


@pytest.mark.parametrize("kind", ["cv2_4", "cv2_p", "cv2_r", "cv2_o", "cv2_g", "pil_ss", "pil_exif"])
def test_decoder_matches_cv2(kind):
    names = [k for k in CASES if k.startswith(kind)]
    assert names
    for name in names:
        _within_bound(decode_jpeg(CASES[name], name), _cv2_rgb(CASES[name]), name)


def test_exif_orientation_turns_the_image_as_cv2_does():
    shapes = {o: decode_jpeg(CASES[f"pil_exif_orientation_{o}"]).shape for o in range(1, 9)}
    assert all(shapes[o] == (23, 37, 3) for o in (1, 2, 3, 4))
    assert all(shapes[o] == (37, 23, 3) for o in (5, 6, 7, 8))
    assert jpeg_info(CASES["pil_exif_orientation_6"])["orientation"] == 6


def test_committed_files_match_cv2s_committed_decodes():
    jpgs = sorted(glob.glob(os.path.join(DATA, "*.jpg")))
    assert len(jpgs) >= 10
    assert sum(os.path.getsize(f) for f in glob.glob(os.path.join(DATA, "*.*g"))) <= 64 * 1024
    for path in jpgs:
        want = read_png(path[:-4] + ".png")
        _within_bound(load_image(path), want, path)
        _within_bound(want, cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1], path)


def _patched(data: bytes, old: bytes, new: bytes) -> bytes:
    i = data.index(old)
    return data[:i] + new + data[i + len(old):]


def test_unsupported_files_raise_naming_the_file_and_marker(tmp_path):
    base = CASES["cv2_420_48x64"]
    prog = CASES["cv2_progressive_48x64"]
    sof0 = base.index(b"\xff\xc0")
    twelve = base[:sof0 + 4] + b"\x0c" + base[sof0 + 5:]
    b = io.BytesIO()
    Image.fromarray(_picture(16, 16)).convert("CMYK").save(b, "JPEG")
    bad = {
        "arith.jpg": (_patched(base, b"\xff\xc0", b"\xff\xc9"), "SOF9 (arithmetic coding)"),
        "arith_prog.jpg": (_patched(prog, b"\xff\xc2", b"\xff\xca"), "SOF10 (arithmetic coding)"),
        "lossless.jpg": (_patched(base, b"\xff\xc0", b"\xff\xc3"), "SOF3 (lossless)"),
        "twelve.jpg": (twelve, "12-bit"),
        "cmyk.jpg": (b.getvalue(), "4 components"),
    }
    for name, (data, marker) in bad.items():
        path = tmp_path / name
        path.write_bytes(data)
        with pytest.raises(ValueError, match=re.escape(marker)) as e:
            load_image(str(path))
        assert str(path) in str(e.value)


def test_load_image_reads_jpeg_without_pil(tmp_path, monkeypatch):
    import sys

    path = tmp_path / "a.jpg"
    path.write_bytes(CASES["cv2_420_37x53"])
    monkeypatch.setitem(sys.modules, "PIL", None)
    _within_bound(load_image(str(path)), _cv2_rgb(CASES["cv2_420_37x53"]), "a.jpg")


@pytest.mark.parametrize("shape", [(48, 64, 3), (37, 53, 3), (1, 1, 3), (17, 300, 3), (31, 29)])
def test_encoder_round_trip(tmp_path, shape):
    """The encoder's file: cv2 decodes it, the port's decode is within the
    bound of cv2's, both near the source (q95), and it is what cv2.imwrite
    writes (4:2:0, the same tables and quality)."""
    img = _picture(*shape[:2], seed=3, noise=4.0)
    if len(shape) == 2:
        img = img[..., 0]
    path = str(tmp_path / "x.jpg")
    write_jpeg(path, img)
    data = open(path, "rb").read()
    want = cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1]
    got = load_image(path)
    _within_bound(got, want, shape)
    src = img if img.ndim == 3 else np.repeat(img[..., None], 3, 2)
    if min(shape[:2]) > 8:
        assert np.abs(got.astype(np.int32) - src).mean() < 6.0
    info = jpeg_info(data)
    assert (info["height"], info["width"], info["progressive"]) == (*shape[:2], 0)
    ref = cv2.imencode(".jpg", img[..., ::-1] if img.ndim == 3 else img)[1].tobytes()
    _within_bound(decode_jpeg(ref), _cv2_rgb(ref), "cv2's own file")
    # the same headers as cv2's file: quantisation tables, frame, Huffman tables
    for marker in (b"\xff\xdb", b"\xff\xc0", b"\xff\xc4"):
        assert data[data.index(marker):data.index(b"\xff\xda")] == \
            ref[ref.index(marker):ref.index(b"\xff\xda")]
    assert encode_jpeg(img) == data
