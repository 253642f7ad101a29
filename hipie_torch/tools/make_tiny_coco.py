"""Generate a tiny synthetic COCO-panoptic dataset (real files on disk), without cv2.

The port's twin of tools/make_tiny_coco.py: the same categories, directory
layout (panopticapi format: id = R + 256G + 65536B PNGs + json), JSON, random
draws and ``--refcoco`` splits, so the whole data pipeline
(registry -> loader -> mapper -> train step -> evaluators) runs without a
download. The shapes are drawn with numpy (``image_io.fill_polygon`` for the
triangles) and the images are written as PNG (``file_name`` ends in .png), so
its pixels differ from the JAX tool's (cv2 edges, JPEG) but not its structure.
(The JAX tool's ``--ade-semseg`` mirror is not ported: the ADE registration
pairs GT with .jpg images.)

Images are shape scenes: a stuff background split into 2 colour bands (sky /
grass) plus 1-4 thing instances (circle / square / triangle) with
per-category base colours over pixel noise. Category names are common English
words, so the toy WordPiece vocabulary tokenizes them.

    python -m hipie_torch.tools.make_tiny_coco --root DIR [--n-train 48]
        [--n-val 16] [--size 512] [--refcoco]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil

import numpy as np

from hipie_torch.data.image_io import fill_polygon, read_png, write_png
from hipie_torch.evaluation.rle import rle_encode

THINGS = [
    ("circle", (220, 40, 40)),
    ("square", (40, 220, 40)),
    ("triangle", (40, 40, 220)),
]
STUFF = [
    ("sky", (90, 150, 230)),
    ("grass", (60, 170, 80)),
]


def _draw_instance(img, pan, rng, kind, color, seg_id, size):
    r = int(rng.randint(size // 12, size // 5))
    cx = int(rng.randint(r, size - r))
    cy = int(rng.randint(r, size - r))
    if kind == "circle":
        yy, xx = np.ogrid[:size, :size]
        m = (xx - cx) ** 2 + (yy - cy) ** 2 <= r * r
    elif kind == "square":
        m = np.zeros((size, size), bool)
        m[max(cy - r, 0):cy + r + 1, max(cx - r, 0):cx + r + 1] = True
    else:  # triangle
        pts = np.array([[cx, cy - r], [cx - r, cy + r], [cx + r, cy + r]])
        m = fill_polygon(np.zeros((size, size), np.uint8), [pts]).astype(bool)
    jitter = rng.randint(-25, 25, 3)
    img[m] = np.clip(np.asarray(color) + jitter, 0, 255)
    pan[m] = seg_id
    return m


def _pan_png(pan: np.ndarray) -> np.ndarray:
    return np.stack([pan % 256, (pan // 256) % 256, pan // 65536], -1).astype(np.uint8)


def _pan_ids(path: str) -> np.ndarray:
    png = read_png(path).astype(np.int64)
    return png[:, :, 0] + 256 * png[:, :, 1] + 65536 * png[:, :, 2]


def make_split(root, split, n_images, size, seed):
    rng = np.random.RandomState(seed)
    img_dir = os.path.join(root, "coco", split)
    pan_dir = os.path.join(root, "coco", f"panoptic_{split}")
    ann_dir = os.path.join(root, "coco", "annotations")
    for d in (img_dir, pan_dir, ann_dir):
        os.makedirs(d, exist_ok=True)

    categories = []
    for i, (name, _) in enumerate(THINGS):
        categories.append({"id": i + 1, "name": name, "isthing": 1})
    for i, (name, _) in enumerate(STUFF):
        categories.append({"id": 100 + i, "name": name, "isthing": 0})

    images, annotations = [], []
    for idx in range(n_images):
        img_id = idx + 1
        fname = f"{img_id:012d}"
        img = (rng.randn(size, size, 3) * 12 + 128).clip(0, 255).astype(np.uint8)
        pan = np.zeros((size, size), np.int32)

        # stuff: horizontal split at a random height
        horizon = int(rng.randint(size // 4, 3 * size // 4))
        segments = []
        for si, ((name, color), sl) in enumerate(
                zip(STUFF, [np.s_[:horizon], np.s_[horizon:]])):
            seg_id = 1000 + si
            img[sl] = np.clip(np.asarray(color) + rng.randint(-20, 20, 3), 0, 255)
            pan[sl] = seg_id
            segments.append({"id": seg_id, "category_id": 100 + si, "iscrowd": 0,
                             "area": int((pan == seg_id).sum())})
        # re-add noise over stuff regions
        img = np.clip(img.astype(np.int16) + rng.randn(size, size, 3) * 8, 0, 255).astype(np.uint8)

        n_inst = int(rng.randint(1, 5))
        for k in range(n_inst):
            ci = int(rng.randint(len(THINGS)))
            kind, color = THINGS[ci]
            seg_id = 2000 + k
            m = _draw_instance(img, pan, rng, kind, color, seg_id, size)
            area = int(m.sum())
            if area < 16:
                continue
            segments.append({"id": seg_id, "category_id": ci + 1, "iscrowd": 0, "area": area})
        # drop fully-occluded segments
        segments = [s for s in segments if (pan == s["id"]).any()]
        for s in segments:
            s["area"] = int((pan == s["id"]).sum())

        write_png(os.path.join(img_dir, fname + ".png"), img)
        write_png(os.path.join(pan_dir, fname + ".png"), _pan_png(pan))
        images.append({"id": img_id, "file_name": fname + ".png", "height": size, "width": size})
        annotations.append({"image_id": img_id, "file_name": fname + ".png",
                            "segments_info": segments})

    with open(os.path.join(ann_dir, f"panoptic_{split}.json"), "w") as f:
        json.dump({"images": images, "annotations": annotations, "categories": categories}, f)
    return len(images)


def emit_refcoco(root: str, split: str = "val2017", out_name: str = "refcoco-unc-val"):
    """A tiny RefCOCO-style split (annotations/{out_name}_instances.json) from a
    panoptic split: three referring expressions per thing instance, RLE
    segmentation, the images mirrored under coco/train2017 as ref_<name>, where
    load_refcoco looks for them."""
    with open(os.path.join(root, f"coco/annotations/panoptic_{split}.json")) as f:
        ann = json.load(f)
    id2name = {c["id"]: c["name"] for c in ann["categories"]}
    out_images, out_anns = [], []
    aid = 1
    os.makedirs(os.path.join(root, "coco/train2017"), exist_ok=True)
    for im, an in zip(ann["images"], ann["annotations"]):
        pan = _pan_ids(os.path.join(root, f"coco/panoptic_{split}", an["file_name"]))
        h, w = pan.shape
        dst_img = os.path.join(root, "coco/train2017", "ref_" + im["file_name"])
        if not os.path.exists(dst_img):
            shutil.copy(os.path.join(root, f"coco/{split}", im["file_name"]), dst_img)
        out_images.append({"id": 100000 + im["id"], "file_name": "ref_" + im["file_name"],
                           "height": h, "width": w})
        things = [s for s in an["segments_info"] if s["category_id"] < 100]
        for s in things:
            m = (pan == s["id"]).astype(np.uint8)
            if m.sum() < 64:
                continue
            ys, xs = np.nonzero(m)
            x0, y0 = int(xs.min()), int(ys.min())
            bw, bh = int(xs.max() - x0 + 1), int(ys.max() - y0 + 1)
            cx, cy = xs.mean() / w, ys.mean() / h
            horiz = "left" if cx < 0.45 else ("right" if cx > 0.55 else "middle")
            vert = "top" if cy < 0.45 else ("bottom" if cy > 0.55 else "middle")
            kind = id2name[s["category_id"]]
            rel_area = m.sum() / float(h * w)
            size_adj = "big" if rel_area > 0.04 else "small"
            exprs = [
                f"the {kind} at the {vert} {horiz}",
                f"{kind} on the {horiz} side near the {vert}",
                f"the {size_adj} {kind} near the {vert}",
            ]
            out_anns.append({
                "id": aid, "image_id": 100000 + im["id"], "category_id": 1,
                "bbox": [x0, y0, bw, bh], "area": int(m.sum()),
                "iscrowd": 0, "expressions": exprs,
                "segmentation": rle_encode(m),
            })
            aid += 1
    os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
    out = {"images": out_images, "annotations": out_anns,
           "categories": [{"id": 1, "name": "object"}]}
    with open(os.path.join(root, "annotations", f"{out_name}_instances.json"), "w") as f:
        json.dump(out, f)
    print(f"emitted tiny {out_name}: {len(out_anns)} expressions")


def dataset_bytes(root: str) -> int:
    """Bytes of every file under ``root``."""
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(root) for f in fs)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--root", required=True)
    p.add_argument("--n-train", type=int, default=48)
    p.add_argument("--n-val", type=int, default=16)
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--refcoco", action="store_true",
                   help="also emit a tiny refcoco-style grounding split")
    args = p.parse_args(argv)
    n = make_split(args.root, "train2017", args.n_train, args.size, seed=0)
    m = make_split(args.root, "val2017", args.n_val, args.size, seed=1)
    if args.refcoco:
        emit_refcoco(args.root)
        emit_refcoco(args.root, split="train2017", out_name="refcoco-mixed")
    print(f"wrote {n} train + {m} val images under {args.root} "
          f"(set HIPIE_DATASETS={args.root})")


if __name__ == "__main__":
    main()
