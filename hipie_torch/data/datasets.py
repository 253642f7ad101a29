"""Dataset registry + COCO-format loaders (host side).

The port's copy of hipie_tpu/data/datasets.py, with its image files read by
hipie_torch/data/image_io.py (PNG itself, other formats through PIL at call
time) and polygons filled by ``image_io.fill_polygon``.

Behavioral parity target: reference hipie/data/datasets/builtin.py (refcoco
splits, COCO panoptic/semseg, ADE20k, Pascal ctx/voc, Pascal-Parts, PACO,
Objects365v2, SeginW/ODinW registrations, all rooted at DETECTRON2_DATASETS) and
datasets/catids.py get_openseg_labels.

This module keeps the same shape: a global registry of named datasets, each
producing a list of records {file_name, image_id, annotations[...],
class_names, class_is_thing}; open-vocab label sets load from the reference's
`id:name` txt format (openseg_labels). The dataset root comes from
HIPIE_DATASETS (falling back to DETECTRON2_DATASETS).
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from hipie_torch.data.image_io import fill_polygon, load_image
from hipie_torch.evaluation.rle import rle_decode

DATASET_REGISTRY: Dict[str, Callable[[], List[Dict[str, Any]]]] = {}
DATASET_METADATA: Dict[str, Dict[str, Any]] = {}


def register_dataset(name: str, loader: Callable[[], List[Dict[str, Any]]],
                     metadata: Optional[Dict[str, Any]] = None):
    DATASET_REGISTRY[name] = loader
    DATASET_METADATA[name] = metadata or {}


def get_dataset(name: str) -> List[Dict[str, Any]]:
    return DATASET_REGISTRY[name]()


def dataset_root() -> str:
    return os.environ.get("HIPIE_DATASETS",
                          os.environ.get("DETECTRON2_DATASETS", "datasets"))


def load_openseg_labels(path: str) -> Tuple[List[str], List[List[str]]]:
    """Parse the reference's openseg label format: 'id:name1,name2,...' lines.

    Returns (primary names, synonym groups). reference datasets/catids.py:3-41.
    """
    names, groups = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            _, _, body = line.partition(":")
            syns = [s.strip() for s in body.split(",") if s.strip()]
            names.append(syns[0])
            groups.append(syns)
    return names, groups


# ---------------------------------------------------------------------------
# COCO-format loaders
# ---------------------------------------------------------------------------

def load_coco_json(json_file: str, image_root: str,
                   with_masks: bool = True) -> List[Dict[str, Any]]:
    """Minimal COCO instances loader (replaces detectron2 load_coco_json)."""
    with open(json_file) as f:
        coco = json.load(f)
    cats = sorted(coco["categories"], key=lambda c: c["id"])
    cat_ids = [c["id"] for c in cats]
    id_map = {cid: i for i, cid in enumerate(cat_ids)}
    class_names = [c["name"] for c in cats]
    class_is_thing = [bool(c.get("isthing", 1)) for c in cats]

    anns_by_img: Dict[int, List[dict]] = {}
    for a in coco.get("annotations", []):
        anns_by_img.setdefault(a["image_id"], []).append(a)

    records = []
    for img in coco["images"]:
        anns = []
        for a in anns_by_img.get(img["id"], []):
            if a.get("iscrowd", 0):
                continue
            x, y, w, h = a["bbox"]
            ann = {
                "bbox": np.array([x, y, x + w, y + h], np.float32),
                "category_id": id_map[a["category_id"]],
                "is_thing": class_is_thing[id_map[a["category_id"]]],
                "segmentation_raw": a.get("segmentation") if with_masks else None,
                "area": a.get("area", w * h),
            }
            anns.append(ann)
        records.append({
            "file_name": os.path.join(image_root, img["file_name"]),
            "image_id": img["id"],
            "height": img["height"], "width": img["width"],
            "annotations": anns,
            "class_names": class_names,
            "class_is_thing": class_is_thing,
            "task": "detection",
        })
    return records


def load_refcoco(json_file: str, image_root: str) -> List[Dict[str, Any]]:
    """RefCOCO-mixed loader: records with one expression each (grounding task).

    The reference registers refcoco/+/g unc/umd splits converted to a COCO-like
    json with 'expressions' per annotation (conversion/ scripts).
    """
    with open(json_file) as f:
        coco = json.load(f)
    anns_by_img: Dict[int, List[dict]] = {}
    for a in coco.get("annotations", []):
        anns_by_img.setdefault(a["image_id"], []).append(a)
    records = []
    for img in coco["images"]:
        for a in anns_by_img.get(img["id"], []):
            exprs = a.get("expressions") or [a.get("expression", "")]
            x, y, w, h = a["bbox"]
            for expr in exprs:
                records.append({
                    "file_name": os.path.join(image_root, img["file_name"]),
                    "image_id": img["id"],
                    "height": img["height"], "width": img["width"],
                    "annotations": [{
                        "bbox": np.array([x, y, x + w, y + h], np.float32),
                        "category_id": 0, "is_thing": True,
                        "segmentation_raw": a.get("segmentation"),
                    }],
                    "expression": expr,
                    "class_names": ["object"], "class_is_thing": [True],
                    "task": "grounding",
                })
    return records


def decode_segmentation(ann: Dict[str, Any], h: int, w: int) -> np.ndarray:
    """Polygon / RLE -> (h, w) uint8 mask (replaces pycocotools.mask.decode)."""
    seg = ann.get("segmentation_raw")
    if seg is None:
        return np.zeros((h, w), np.uint8)
    if isinstance(seg, list):                     # polygons
        m = np.zeros((h, w), np.uint8)
        for poly in seg:
            pts = np.asarray(poly, np.float64).reshape(-1, 2)
            fill_polygon(m, [np.round(pts).astype(np.int64)], 1)
        return m
    if isinstance(seg, dict):                     # RLE
        return rle_decode(seg)
    raise ValueError(f"unknown segmentation format {type(seg)}")


def materialize_record(record: Dict[str, Any]) -> Dict[str, Any]:
    """Load the image + decode masks for one record (called by the loader)."""
    if record.get("pan_seg_file"):
        record = panoptic_record_to_instances(record)
    out = dict(record)
    if "image" not in out:
        out["image"] = load_image(record["file_name"])
    h, w = out["image"].shape[:2]
    anns = []
    for a in record.get("annotations", []):
        a = dict(a)
        if a.get("segmentation_raw") is not None:
            a["segmentation"] = decode_segmentation(a, h, w)
        anns.append(a)
    out["annotations"] = anns
    return out


def load_panoptic_png(path: str) -> np.ndarray:
    """COCO panoptic PNG -> (H, W) int32 segment ids (R + 256G + 65536B)."""
    img = load_image(path).astype(np.int64)
    return (img[..., 0] + img[..., 1] * 256 + img[..., 2] * 65536).astype(np.int32)


def load_coco_panoptic(json_file: str, image_root: str,
                       panoptic_root: str) -> List[Dict[str, Any]]:
    """COCO panoptic annotations (panopticapi format) -> records with lazy
    panoptic GT (pan_seg_file + segments), thing+stuff label space."""
    with open(json_file) as f:
        coco = json.load(f)
    cats = sorted(coco["categories"], key=lambda c: c["id"])
    id_map = {c["id"]: i for i, c in enumerate(cats)}
    class_names = [c["name"] for c in cats]
    class_is_thing = [bool(c.get("isthing", 1)) for c in cats]
    anns = {a["image_id"]: a for a in coco["annotations"]}
    records = []
    for img in coco["images"]:
        a = anns.get(img["id"])
        segments = []
        if a is not None:
            for s in a["segments_info"]:
                segments.append({"id": s["id"],
                                 "category_id": id_map[s["category_id"]],
                                 "iscrowd": s.get("iscrowd", 0),
                                 "area": s.get("area", 0)})
        records.append({
            "file_name": os.path.join(image_root, img["file_name"]),
            "image_id": img["id"],
            "height": img["height"], "width": img["width"],
            "pan_seg_file": (os.path.join(panoptic_root, a["file_name"])
                             if a is not None else None),
            "pan_segments": segments,
            "annotations": [],       # instance anns derivable from the png
            "class_names": class_names,
            "class_is_thing": class_is_thing,
            "task": "detection",
        })
    return records


def panoptic_record_to_instances(record: Dict[str, Any]) -> Dict[str, Any]:
    """Decode the panoptic PNG into per-segment instance annotations + the GT
    maps used by the PQ / mIoU evaluators (sem_seg_gt with ignore=255)."""
    out = dict(record)
    pan = load_panoptic_png(record["pan_seg_file"])
    out["pan_seg_gt"] = pan
    sem = np.full(pan.shape, 255, np.int32)
    anns = []
    for s in record["pan_segments"]:
        m = pan == s["id"]
        sem[m] = s["category_id"]
        if not m.any():
            continue
        ys, xs = np.where(m)
        anns.append({
            "bbox": np.array([xs.min(), ys.min(), xs.max() + 1, ys.max() + 1],
                             np.float32),
            "category_id": s["category_id"],
            "is_thing": record["class_is_thing"][s["category_id"]],
            "segmentation": m.astype(np.uint8),
            "area": float(m.sum()),
            "iscrowd": s.get("iscrowd", 0),
        })
    out["sem_seg_gt"] = sem
    out["annotations"] = anns
    return out


# -- builtin registrations (lazy, gated on the dataset root) ------------------

def _register_builtin():
    root = dataset_root()
    specs = {
        "coco_2017_train": ("coco/annotations/instances_train2017.json",
                            "coco/train2017"),
        "coco_2017_val": ("coco/annotations/instances_val2017.json",
                          "coco/val2017"),
    }
    for name, (js, imroot) in specs.items():
        register_dataset(
            name,
            (lambda js=js, imroot=imroot: load_coco_json(
                os.path.join(root, js), os.path.join(root, imroot))),
        )
    for name, split in [("coco_panoptic_train", "train2017"),
                        ("coco_panoptic_val", "val2017")]:
        register_dataset(
            name,
            (lambda split=split: load_coco_panoptic(
                os.path.join(root, f"coco/annotations/panoptic_{split}.json"),
                os.path.join(root, f"coco/{split}"),
                os.path.join(root, f"coco/panoptic_{split}"))),
            metadata={"evaluator_type": "panoptic"},
        )
    for split in ["refcoco-mixed", "refcoco-unc-val", "refcocoplus-unc-val",
                  "refcocog-umd-val"]:
        js = f"annotations/{split}_instances.json"
        register_dataset(
            split,
            (lambda js=js: load_refcoco(os.path.join(root, js),
                                        os.path.join(root, "coco/train2017"))),
        )


_register_builtin()


# benchmark-matrix registrations (ADE20k, Pascal ctx/voc/parts, PACO, O365v2,
# SeginW/ODinW, COCO semseg) + bundled openseg label sets live in
# datasets_extra to keep this module focused on the registry + COCO loaders.
from hipie_torch.data import datasets_extra as _extra  # noqa: E402,F401
