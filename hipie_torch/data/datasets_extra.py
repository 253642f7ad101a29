"""Benchmark-matrix dataset registrations + open-vocab label sets.

The port's copy of hipie_tpu/data/datasets_extra.py, with its own copy of the
label files (hipie_torch/data/openseg_labels/).

Behavioral parity target: reference hipie/data/datasets/builtin.py:329-360 and
its helpers — register_ade20k_panoptic.py, register_ade_20k_full.py,
register_pascal.py (ctx59/ctx459/pascal21/pascal-parts), paco.py,
objects365(_v2).py, register_seginw.py, register_odinw.py — plus
catids.py:3-41 get_openseg_labels. Directory layouts match the reference's
(rooted at HIPIE_DATASETS / DETECTRON2_DATASETS), so datasets prepared for the
reference work unchanged.

Every record carries {file_name, image_id, class_names, class_is_thing,
task} plus either `annotations` (instances) or `sem_seg_file_name`
(semantic GT); metadata records evaluator_type / ignore_label / label_group.
"""

from __future__ import annotations

import glob
import os
from functools import lru_cache
from typing import Any, Dict, List, Optional, Sequence, Tuple

from hipie_torch.data.datasets import (
    DATASET_METADATA,
    dataset_root,
    load_coco_json,
    load_coco_panoptic,
    load_openseg_labels,
    register_dataset,
)

OPENSEG_LABELS_DIR = os.path.join(os.path.dirname(__file__), "openseg_labels")


@lru_cache(maxsize=None)
def get_openseg_labels(name: str, prompt_eng: bool = False
                       ) -> List[Dict[str, Any]]:
    """Open-vocab label set by name (reference datasets/catids.py:3-41).

    Returns [{'id': i, 'name': 'syn1,syn2,...'}] — names keep the comma-joined
    synonym list exactly like the reference so downstream synonym ensembling
    (postprocess_clip) can split on ','.
    """
    suffix = "_with_prompt_eng" if prompt_eng else ""
    path = os.path.join(OPENSEG_LABELS_DIR, f"{name}{suffix}.txt")
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            cid, _, body = line.partition(":")
            out.append({"id": int(cid), "name": body})
    return out


def openseg_names_and_things(label_set: str, is_thing: Optional[Sequence[bool]]
                             = None, skip_invalid: bool = True
                             ) -> Tuple[List[str], List[bool]]:
    labels = get_openseg_labels(label_set)
    names = [l["name"] for l in labels]
    if skip_invalid and names and names[0] == "invalid_class_id":
        names = names[1:]
    things = list(is_thing) if is_thing is not None else [False] * len(names)
    return names, things


def load_sem_seg(image_dir: str, gt_dir: str, label_set: str,
                 image_ext: str = "jpg", gt_ext: str = "png",
                 is_thing: Optional[Sequence[bool]] = None
                 ) -> List[Dict[str, Any]]:
    """Pair images with semantic GT files by basename (d2 load_sem_seg)."""
    names, things = openseg_names_and_things(label_set, is_thing)
    gts = sorted(glob.glob(os.path.join(gt_dir, f"*.{gt_ext}")))
    records = []
    for gt in gts:
        base = os.path.splitext(os.path.basename(gt))[0]
        records.append({
            "file_name": os.path.join(image_dir, f"{base}.{image_ext}"),
            "sem_seg_file_name": gt,
            "image_id": base,
            "class_names": names,
            "class_is_thing": things,
            "task": "detection",
        })
    return records


# ---------------------------------------------------------------------------
# per-benchmark registration helpers
# ---------------------------------------------------------------------------

# ADE20k-150: first 100 entries of the panoptic ordering are things
# (reference register_ade20k_panoptic.py ADE20K_150_CATEGORIES isthing flags).
def _ade150_is_thing() -> List[bool]:
    thing_idx = set(range(0, 150))
    # stuff classes in ADE150 panoptic metadata: isthing=0 entries
    stuff = {0, 1, 2, 3, 4, 5, 6, 9, 11, 13, 16, 17, 21, 25, 26, 28, 29,
             34, 40, 46, 48, 51, 52, 54, 60, 61, 63, 68, 77, 79, 84, 91,
             94, 96, 101, 105, 106, 109, 113, 114, 122, 128, 131, 140, 141,
             145}
    return [i not in stuff for i in sorted(thing_idx)]


def _register_sem_seg(name: str, image_dir: str, gt_dir: str, label_set: str,
                      gt_ext: str = "png", ignore_label: int = 255,
                      label_group: Optional[Dict[int, int]] = None,
                      n_merged: int = 0):
    root = dataset_root()
    register_dataset(
        name,
        (lambda: load_sem_seg(os.path.join(root, image_dir),
                              os.path.join(root, gt_dir), label_set,
                              gt_ext=gt_ext)),
        metadata={"evaluator_type": "sem_seg", "ignore_label": ignore_label,
                  "label_set": label_set, "label_group": label_group,
                  "n_merged": n_merged},
    )


def register_benchmark_datasets():
    root = dataset_root()

    # ---- ADE20k panoptic + semseg (150) -----------------------------------
    for split, dirname in [("train", "training"), ("val", "validation")]:
        register_dataset(
            f"ade20k_panoptic_{split}",
            (lambda split=split, dirname=dirname: load_coco_panoptic(
                os.path.join(root, f"ade/ADEChallengeData2016/ade20k_panoptic_{split}.json"),
                os.path.join(root, f"ade/ADEChallengeData2016/images/{dirname}"),
                os.path.join(root, f"ade/ADEChallengeData2016/ade20k_panoptic_{split}"))),
            metadata={"evaluator_type": "panoptic", "label_set": "ade20k_150"},
        )
        _register_sem_seg(
            f"ade20k_sem_seg_{split}",
            f"ade/ADEChallengeData2016/images/{dirname}",
            f"ade/ADEChallengeData2016/annotations_detectron2/{dirname}",
            "ade20k_150")
        # instances (ADE-150 AP rows): coco-format instance json
        register_dataset(
            f"ade20k_instance_{split}",
            (lambda split=split, dirname=dirname: load_coco_json(
                os.path.join(root, f"ade/ADEChallengeData2016/ade20k_instance_{split}.json"),
                os.path.join(root, f"ade/ADEChallengeData2016/images/{dirname}"))),
            metadata={"evaluator_type": "coco_openvocab",
                      "label_set": "ade20k_150"},
        )

    # ---- ADE20k-full (847 classes, semseg) --------------------------------
    for split, dirname in [("train", "training"), ("val", "validation")]:
        _register_sem_seg(
            f"ade20k_full_sem_seg_{split}",
            f"ade/ADE20K_2021_17_01/images_detectron2/{dirname}",
            f"ade/ADE20K_2021_17_01/annotations_detectron2/{dirname}",
            "ade20k_847", gt_ext="tif", ignore_label=65535)

    # ---- Pascal Context 59 / 459 + VOC 21 ---------------------------------
    for split, dirname in [("train", "training"), ("val", "validation")]:
        _register_sem_seg(
            f"ctx59_sem_seg_{split}",
            f"pascal_ctx_d2/images/{dirname}",
            f"pascal_ctx_d2/annotations_ctx59/{dirname}", "pascal_context_59")
        _register_sem_seg(
            f"ctx459_sem_seg_{split}",
            f"pascal_ctx_d2/images/{dirname}",
            f"pascal_ctx_d2/annotations_ctx459/{dirname}", "pascal_context_459",
            gt_ext="tif", ignore_label=65535)
        _register_sem_seg(
            f"pascal21_sem_seg_{split}",
            f"pascal_voc_d2/images/{dirname}",
            f"pascal_voc_d2/annotations_pascal21/{dirname}", "pascal_voc_21")

    # ---- Pascal-Panoptic-Parts (hierarchical; mIoU-PartS) ------------------
    from hipie_torch.data.label_spaces import PASCAL_PART_LABEL_GROUP
    for split, dirname in [("train", "training_pano"), ("val", "validation_pano"),
                           ("test", "test_pano")]:
        _register_sem_seg(
            f"pascal_parts_{split}",
            "VOCdevkit/VOC2010/JPEGImages",
            f"pascal_parts/labels/{dirname}", "pascal_parts_pano",
            gt_ext="tif", ignore_label=0,
            label_group=PASCAL_PART_LABEL_GROUP, n_merged=58)

    # ---- PACO (part instances) ---------------------------------------------
    for source, img_root, splits in [
            ("lvis_v1", "coco", ("train", "val", "test")),
            ("ego4d_v1", "paco/ego4d_frames", ("train", "val", "test"))]:
        for split in splits:
            register_dataset(
                f"paco_{source}_{split}",
                (lambda source=source, split=split, img_root=img_root:
                 load_coco_json(
                     os.path.join(root, f"paco/paco_{source}_{split}.json"),
                     os.path.join(root, img_root))),
                metadata={"evaluator_type": "coco_openvocab",
                          "label_set": "paco"},
            )

    # ---- Objects365 v2 ------------------------------------------------------
    for split, (img_dir, js) in {
        "train": ("Objects365/images/train", "Objects365/zhiyuan_objv2_train_new.json"),
        "val": ("Objects365/images/val", "Objects365/zhiyuan_objv2_val_new.json"),
    }.items():
        register_dataset(
            f"objects365_v2_{split}",
            (lambda img_dir=img_dir, js=js: load_coco_json(
                os.path.join(root, js), os.path.join(root, img_dir))),
            metadata={"evaluator_type": "coco", "label_set": "obj365v2"},
        )

    # ---- SeginW (25 instance-segmentation-in-the-wild sets) ----------------
    seginw_cats = [
        "Elephants", "Hand-Metal", "Watermelon", "House-Parts",
        "HouseHold-Items", "Strawberry", "Fruits", "Nutterfly-Squireel",
        "Hand", "Garbage", "Chicken", "Rail", "Airplane-Parts", "Brain-Tumor",
        "Poles", "Electric-Shaver", "Bottles", "Toolkits", "Trash",
        "Salmon-Fillet", "Puppies", "Tablets", "Phones", "Cows",
        "Ginger-Garlic"]
    for cat in seginw_cats:
        register_dataset(
            f"seginw_{cat}_val",
            (lambda cat=cat: load_coco_json(
                os.path.join(root, f"seginw/{cat}/valid/_annotations_min1cat.coco.json"),
                os.path.join(root, f"seginw/{cat}/valid"))),
            metadata={"evaluator_type": "coco_openvocab",
                      "label_set": f"seginw_{cat}"},
        )

    # ---- ODinW (detection in the wild; label sets shipped per sub-dataset) --
    odinw_sets = sorted(
        os.path.basename(p)[len("odinw_"):-len(".txt")]
        for p in glob.glob(os.path.join(OPENSEG_LABELS_DIR, "odinw_*.txt"))
        if "_with_prompt_eng" not in p)
    for name in odinw_sets:
        register_dataset(
            f"odinw_{name}_val",
            (lambda name=name: load_coco_json(
                os.path.join(root, f"odinw/{name}/valid/annotations_without_background.json"),
                os.path.join(root, f"odinw/{name}/valid"))),
            metadata={"evaluator_type": "coco_openvocab",
                      "label_set": f"odinw_{name}"},
        )

    # ---- COCO semseg from panoptic (mIoU rows) ------------------------------
    for split in ["train", "val"]:
        _register_sem_seg(
            f"coco_sem_seg_{split}",
            f"coco/{split}2017",
            f"coco/panoptic_semseg_{split}2017", "coco_panoptic")


register_benchmark_datasets()
