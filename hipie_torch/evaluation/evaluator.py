"""Dataset evaluation orchestration.

The port's copy of hipie_tpu/evaluation/evaluator.py, on the port's
``HIPIEPredictor`` (a model and a device, where JAX's takes parameters).

Behavioral parity target: detectron2 inference_on_dataset
(evaluation/evaluator.py:103) + the evaluator zoo wiring in reference
train_net.py build_evaluator (:59-108): COCO box/segm AP, RefCOCO oIoU,
panoptic PQ, semantic mIoU — selected per dataset.

One process evaluates the whole dataset (the JAX package's multi-host merge
waits for the port's multi-GPU work).
"""

from __future__ import annotations

import time
from typing import Any, Dict, Iterable, List, Optional, Sequence

import numpy as np

from hipie_torch.evaluation.coco_eval import COCOApEvaluator
from hipie_torch.evaluation.seg_eval import (
    PanopticEvaluator,
    RefCOCOEvaluator,
    SemSegEvaluator,
)


def evaluate_detection_dataset(
    predictor,
    records: Iterable[Dict[str, Any]],
    num_classes: int,
    is_thing: Sequence[bool],
    tasks: Sequence[str] = ("bbox", "segm"),
    max_images: Optional[int] = None,
    score_thresh: float = 0.0,
) -> Dict[str, float]:
    """Run the predictor over COCO-style records and compute AP (+PQ/mIoU when
    panoptic outputs are present)."""
    from hipie_torch.data.datasets import (decode_segmentation, load_image,
                                         materialize_record)

    evaluators: Dict[str, Any] = {}
    if "bbox" in tasks:
        evaluators["bbox"] = COCOApEvaluator("bbox")
    if "segm" in tasks:
        evaluators["segm"] = COCOApEvaluator("segm")
    pan_eval = PanopticEvaluator(num_classes, is_thing) if "panoptic" in tasks else None
    sem_eval = SemSegEvaluator(num_classes) if "sem_seg" in tasks else None

    n = 0
    start = time.time()
    for rec in records:
        if max_images is not None and n >= max_images:
            break
        # panoptic records carry GT lazily (pan_seg_file + segments):
        # materialize decodes the png into instance annotations + pan/sem GT.
        if rec.get("pan_seg_file") or any(
                a.get("segmentation_raw") is not None
                for a in rec.get("annotations", [])):
            rec = materialize_record(rec)
        img = rec.get("image")
        if img is None:
            img = load_image(rec["file_name"])
        h, w = img.shape[:2]
        result = predictor(img, task="detection",
                           test_categories=rec["class_names"],
                           test_is_thing=rec["class_is_thing"],
                           score_thresh=score_thresh)
        inst = result["instances"]
        dets_box, dets_mask = [], []
        for i in range(len(inst["scores"])):
            x0, y0, x1, y1 = inst["boxes"][i]
            d = {"category_id": int(inst["classes"][i]),
                 "score": float(inst["scores"][i]),
                 "bbox": [float(x0), float(y0), float(x1), float(y1)],
                 "area": float(max(x1 - x0, 0) * max(y1 - y0, 0))}
            dets_box.append(d)
            if "segm" in evaluators:
                dm = dict(d)
                dm["mask"] = inst["masks"][i]
                dm["area"] = float(inst["masks"][i].sum())
                dets_mask.append(dm)
        gts_box, gts_mask = [], []
        for a in rec.get("annotations", []):
            g = {"category_id": int(a["category_id"]),
                 "bbox": [float(v) for v in a["bbox"]],
                 "area": float(a.get("area", 0)) or float(
                     (a["bbox"][2] - a["bbox"][0]) * (a["bbox"][3] - a["bbox"][1])),
                 "iscrowd": a.get("iscrowd", 0)}
            gts_box.append(g)
            if "segm" in evaluators:
                gm = dict(g)
                gm["mask"] = (a.get("segmentation")
                              if a.get("segmentation") is not None
                              else decode_segmentation(a, h, w))
                gm["area"] = float(gm["mask"].sum())
                gts_mask.append(gm)
        if "bbox" in evaluators:
            evaluators["bbox"].add_image(rec["image_id"], gts_box, dets_box)
        if "segm" in evaluators:
            evaluators["segm"].add_image(rec["image_id"], gts_mask, dets_mask)
        if pan_eval is not None and "panoptic_seg" in result \
                and "pan_seg_gt" in rec:
            pan, segs = result["panoptic_seg"]
            pan_eval.add_image(pan, segs, rec["pan_seg_gt"], rec["pan_segments"])
        if sem_eval is not None and "sem_seg" in result and "sem_seg_gt" in rec:
            sem_eval.add_image(result["sem_seg"], rec["sem_seg_gt"])
        n += 1

    out: Dict[str, float] = {}
    for name, ev in evaluators.items():
        for k, v in ev.evaluate().items():
            out[f"{name}/{k}"] = v
    if pan_eval is not None:
        out.update({f"panoptic/{k}": v for k, v in pan_eval.evaluate().items()})
    if sem_eval is not None:
        out.update({f"sem_seg/{k}": v for k, v in sem_eval.evaluate().items()})
    out["images"] = n
    out["sec_per_image"] = (time.time() - start) / max(n, 1)
    return out


def evaluate_refcoco_dataset(predictor, records, max_images=None):
    from hipie_torch.data.datasets import decode_segmentation, load_image

    ev_mask = RefCOCOEvaluator()
    ev_box = RefCOCOEvaluator()
    n = 0
    for rec in records:
        if max_images is not None and n >= max_images:
            break
        img = rec.get("image")
        if img is None:
            img = load_image(rec["file_name"])
        h, w = img.shape[:2]
        result = predictor(img, task="grounding",
                           expressions=rec["expression"], score_thresh=-1.0)
        inst = result["instances"]
        gt = rec["annotations"][0]
        gt_mask = (gt.get("segmentation") if gt.get("segmentation") is not None
                   else decode_segmentation(gt, h, w))
        if len(inst["masks"]):
            ev_mask.add_image(inst["masks"][0], gt_mask)
            pb = np.zeros((h, w), bool)
            x0, y0, x1, y1 = np.clip(inst["boxes"][0], 0, [w, h, w, h]).astype(int)
            pb[y0:y1, x0:x1] = True
            gb = np.zeros((h, w), bool)
            gx0, gy0, gx1, gy1 = np.clip(gt["bbox"], 0, [w, h, w, h]).astype(int)
            gb[gy0:gy1, gx0:gx1] = True
            ev_box.add_image(pb, gb)
        n += 1
    out = {f"mask/{k}": v for k, v in ev_mask.evaluate().items()}
    out.update({f"box/{k}": v for k, v in ev_box.evaluate().items()})
    out["images"] = n
    return out


def load_sem_seg_gt(path: str) -> np.ndarray:
    """Load semantic GT (8-bit png or 16-bit tif; d2 layout)."""
    from hipie_torch.data.image_io import load_image
    return load_image(path, color=False)


def evaluate_semseg_dataset(predictor, records, metadata=None,
                            max_images: Optional[int] = None
                            ) -> Dict[str, float]:
    """Semantic-segmentation eval (mIoU; + merged-group mIoU-PartS for the
    Pascal-Parts label space). reference: SemSegEvaluator(+Parts) wiring in
    train_net.py build_evaluator + d2_evaluator.py:64-102."""
    from hipie_torch.data.datasets import load_image
    from hipie_torch.evaluation.seg_eval import (SemSegEvaluator,
                                               SemSegEvaluatorParts)

    metadata = metadata or {}
    ignore = metadata.get("ignore_label", 255)
    label_group = metadata.get("label_group")
    # ignore_label == 0 marks 1-based GT (pascal-parts 16-bit tif): shift to
    # 0-based and use a sentinel ignore id outside the label range.
    shift_gt = ignore == 0
    eff_ignore = 10 ** 6 if shift_gt else ignore
    ev = None
    n = 0
    start = time.time()
    for rec in records:
        if max_images is not None and n >= max_images:
            break
        if ev is None:
            c = len(rec["class_names"])
            if label_group:
                ev = SemSegEvaluatorParts(c, label_group,
                                          metadata.get("n_merged", 58),
                                          ignore_label=eff_ignore)
            else:
                ev = SemSegEvaluator(c, ignore_label=eff_ignore)
        img = rec.get("image")
        if img is None:
            img = load_image(rec["file_name"])
        result = predictor(img, task="detection",
                           test_categories=rec["class_names"],
                           test_is_thing=rec["class_is_thing"])
        gt = rec.get("sem_seg_gt")
        if gt is None:
            gt = load_sem_seg_gt(rec["sem_seg_file_name"])
        gt = np.asarray(gt).astype(np.int64)
        if shift_gt:
            gt = np.where(gt == 0, np.int64(eff_ignore), gt - 1)
        ev.add_image(result["sem_seg"], gt)
        n += 1
    out = {f"sem_seg/{k}": v for k, v in (ev.evaluate() if ev else {}).items()}
    out["images"] = n
    out["sec_per_image"] = (time.time() - start) / max(n, 1)
    return out


def instance_results_to_coco_json(predictions, records,
                                  dataset_id_map=None) -> List[Dict[str, Any]]:
    """Export predictions in COCO-results format with OPEN-VOCAB tolerant
    category-id unmapping (reference hipie/data/evaluation/
    instance_evaluation.py:30 InstanceSegEvaluator: contiguous prediction ids
    map back to dataset category ids; sparse/remapped id spaces allowed)."""
    out = []
    for rec, preds in zip(records, predictions):
        for i in range(len(preds["scores"])):
            cid = int(preds["classes"][i])
            if dataset_id_map is not None:
                if cid not in dataset_id_map:
                    raise KeyError(
                        f"prediction class {cid} not in dataset id map "
                        f"({len(dataset_id_map)} classes)")
                cid = dataset_id_map[cid]
            x0, y0, x1, y1 = [float(v) for v in preds["boxes"][i]]
            out.append({
                "image_id": rec["image_id"],
                "category_id": cid,
                "bbox": [x0, y0, x1 - x0, y1 - y0],
                "score": float(preds["scores"][i]),
            })
    return out


def make_inline_eval_fn(cfg, model, tokenizer, device="cuda"):
    """EvalHook-style closure for Trainer.eval_fn (reference
    engine/defaults.py:461 EvalHook + hooks.py BestCheckpointer feed).

    Returns fn(model) -> {metric: float}. One HIPIEPredictor over ``model``
    (bucket ``cfg.test.test_size``, on ``device``) is built at the first call
    and reused; each call evaluates the model as it stands, in eval mode, and
    puts it back in train mode. The dataset is cfg.data.test_dataset, capped at
    cfg.test.eval_max_images.
    """
    from hipie_torch.data.datasets import DATASET_METADATA, get_dataset
    from hipie_torch.predictor import HIPIEPredictor

    state: Dict[str, Any] = {}

    def eval_fn(m) -> Dict[str, float]:
        if "predictor" not in state:
            state["predictor"] = HIPIEPredictor(cfg, m, tokenizer,
                                                bucket=tuple(cfg.test.test_size), device=device)
            state["records"] = get_dataset(cfg.data.test_dataset)
        pred = state["predictor"]
        pred.model = m
        was_training = m.training
        m.eval()
        try:
            records = state["records"]
            max_images = cfg.test.eval_max_images or None
            name = cfg.data.test_dataset
            metadata = DATASET_METADATA.get(name, {})
            ev_type = metadata.get("evaluator_type", "coco")
            if "refcoco" in name:
                results = evaluate_refcoco_dataset(pred, records, max_images)
            elif ev_type == "sem_seg":
                results = evaluate_semseg_dataset(pred, records, metadata,
                                                  max_images)
            else:
                meta = records[0]
                tasks = ["bbox", "segm"]
                if ev_type == "panoptic":
                    tasks.append("panoptic")
                results = evaluate_detection_dataset(
                    pred, records, len(meta["class_names"]),
                    meta["class_is_thing"], tasks=tasks, max_images=max_images)
        finally:
            m.train(was_training)
        return {k: float(v) for k, v in results.items()
                if isinstance(v, (int, float))}

    return eval_fn
