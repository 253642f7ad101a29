"""Convert the official refer-API RefCOCO/+/g pickles into the COCO-like jsons
that hipie_torch.data.datasets.load_refcoco consumes.

The port's host copy of tools/convert_refcoco.py (tests/test_torch_hostcode.py
holds the two tools' outputs equal).

Behavioral parity target: reference conversion/convert_ref2coco.py +
convert_mix_ref.py — splits refs by (dataset, splitBy, split), joins each ref's
sentences onto its annotation as `expressions`, and writes
{split}_instances.json. The "mixed" training set is the union of
refcoco/refcoco+/refcocog train splits with duplicate (image, ann) pairs kept
(each keeps its own expressions), like the reference's refcoco-mixed.

Usage:
  python -m hipie_torch.tools.convert_refcoco --refer-root datasets/refer \
      --coco-instances datasets/coco/annotations/instances_train2014.json \
      --out datasets/annotations

Expects the refer download layout: refer/{refcoco,refcoco+,refcocog}/refs(<by>).p
(pickled list of {ref_id, ann_id, image_id, split, sentences:[{sent}...]}).
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
from collections import defaultdict


SPLITS = {
    "refcoco": "unc",
    "refcoco+": "unc",
    "refcocog": "umd",
}


def load_refs(refer_root: str, dataset: str, split_by: str):
    path = os.path.join(refer_root, dataset, f"refs({split_by}).p")
    with open(path, "rb") as f:
        return pickle.load(f)


def convert(refs, coco, split: str):
    """Build a COCO-like dict for one split: annotations carry expressions."""
    anns = {a["id"]: a for a in coco["annotations"]}
    images = {i["id"]: i for i in coco["images"]}
    out_images, out_anns = {}, []
    for ref in refs:
        if ref["split"] != split:
            continue
        ann = anns.get(ref["ann_id"])
        if ann is None:
            continue
        a = dict(ann)
        a["expressions"] = [s["sent"] for s in ref["sentences"]]
        out_anns.append(a)
        img = images[ref["image_id"]]
        out_images[img["id"]] = img
    return {"images": list(out_images.values()), "annotations": out_anns,
            "categories": coco.get("categories", [])}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--refer-root", required=True)
    p.add_argument("--coco-instances", required=True,
                   help="instances_train2014.json (refcoco images are train2014)")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)

    with open(args.coco_instances) as f:
        coco = json.load(f)
    os.makedirs(args.out, exist_ok=True)

    mixed = {"images": {}, "annotations": [], "categories":
             coco.get("categories", [])}
    name_map = {"refcoco": "refcoco-unc", "refcoco+": "refcocoplus-unc",
                "refcocog": "refcocog-umd"}
    for dataset, split_by in SPLITS.items():
        refs = load_refs(args.refer_root, dataset, split_by)
        splits = sorted({r["split"] for r in refs})
        for split in splits:
            conv = convert(refs, coco, split)
            out_name = f"{name_map[dataset]}-{split}_instances.json"
            with open(os.path.join(args.out, out_name), "w") as f:
                json.dump(conv, f)
            print(f"{out_name}: {len(conv['annotations'])} refs, "
                  f"{len(conv['images'])} images")
            if split == "train":
                for img in conv["images"]:
                    mixed["images"][img["id"]] = img
                mixed["annotations"].extend(conv["annotations"])

    mixed["images"] = list(mixed["images"].values())
    with open(os.path.join(args.out, "refcoco-mixed_instances.json"), "w") as f:
        json.dump(mixed, f)
    print(f"refcoco-mixed_instances.json: {len(mixed['annotations'])} refs")


if __name__ == "__main__":
    main()
