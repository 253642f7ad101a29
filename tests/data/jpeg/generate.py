"""Writes the JPEG files of this directory and cv2's decode of each as PNG.

The files cover what the port's decoder (hipie_torch/native/jpeg.cpp) reads:
baseline 4:2:0, 4:2:2, 4:4:4 and 4:4:0, grey, progressive (cv2's and PIL's),
restart intervals, EXIF orientation 6, odd sizes. ``<name>.png`` holds
``cv2.imread(<name>.jpg, cv2.IMREAD_COLOR)[..., ::-1]``; tests/test_torch_jpeg.py
and chip_smoke.py hold the port's decode of each file against it, the latter on
a machine without cv2. Run from the repository root (needs cv2 and PIL):

    python tests/data/jpeg/generate.py
"""

import io
import os

import cv2
import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))


def picture(h, w, seed=0):
    """Smooth colour waves with a little noise: compresses to a few KB."""
    r = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(x / 6.0 + c) * np.cos(y / 9.0 - c) for c in range(3)], -1)
    return np.clip(img + r.randn(h, w, 3) * 6, 0, 255).astype(np.uint8)


def files():
    img = picture(37, 53)
    bgr = np.ascontiguousarray(img[..., ::-1])
    enc = lambda a, *p: cv2.imencode(".jpg", a, list(p))[1].tobytes()
    sf = cv2.IMWRITE_JPEG_SAMPLING_FACTOR
    out = {
        "baseline_420": enc(bgr),
        "baseline_422": enc(bgr, sf, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422),
        "baseline_444": enc(bgr, sf, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444),
        "baseline_440": enc(bgr, sf, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440),
        "grey": enc(cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY)),
        "progressive_420": enc(bgr, cv2.IMWRITE_JPEG_PROGRESSIVE, 1),
        "restart_420": enc(bgr, cv2.IMWRITE_JPEG_RST_INTERVAL, 2),
        "odd_17x9": enc(np.ascontiguousarray(picture(17, 9, 1)[..., ::-1])),
    }
    b = io.BytesIO()
    Image.fromarray(img).save(b, "JPEG", subsampling=1, progressive=True, quality=85)
    out["pil_progressive_422"] = b.getvalue()
    exif = Image.Exif()
    exif[0x0112] = 6
    b = io.BytesIO()
    Image.fromarray(picture(23, 37, 2)).save(b, "JPEG", exif=exif.tobytes(), quality=90)
    out["exif_orientation_6"] = b.getvalue()
    return out


def main():
    for name, data in files().items():
        path = os.path.join(HERE, f"{name}.jpg")
        with open(path, "wb") as f:
            f.write(data)
        cv2.imwrite(os.path.join(HERE, f"{name}.png"), cv2.imread(path, cv2.IMREAD_COLOR))


if __name__ == "__main__":
    main()
