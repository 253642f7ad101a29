"""Panoptic Quality (PQ), semantic mIoU, and referring oIoU evaluators.

The port's copy of hipie_tpu/evaluation/seg_eval.py.

Behavioral parity targets:
  * PQ — panopticapi semantics via detectron2 COCOPanopticEvaluator
    (d2_evaluator.py:48-62): segment matching by IoU > 0.5 over (category,
    segment) pairs, void handling, per-class PQ/SQ/RQ averaged over classes.
  * mIoU — detectron2 SemSegEvaluator (sem_seg_evaluation.py:30): confusion
    matrix over valid pixels, ignore label 255.
  * oIoU — RefCOCOeval (detectron2/evaluation/refcocoeval.py:39-530): overall
    IoU = cumulated intersection / cumulated union over the dataset, plus
    precision@{0.5..0.9}.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class PanopticEvaluator:
    """PQ over (panoptic id map, segments info) pairs."""

    def __init__(self, num_classes: int, is_thing: Sequence[bool],
                 void_id: int = 0):
        self.num_classes = num_classes
        self.is_thing = np.asarray(is_thing, bool)
        self.void = void_id
        self.iou = np.zeros(num_classes)
        self.tp = np.zeros(num_classes, np.int64)
        self.fp = np.zeros(num_classes, np.int64)
        self.fn = np.zeros(num_classes, np.int64)

    def add_image(self, pred_map: np.ndarray, pred_segments: List[dict],
                  gt_map: np.ndarray, gt_segments: List[dict]):
        """maps: (H, W) int32 segment ids (0 = void); segments: [{id, category_id}]."""
        pred_cat = {s["id"]: s["category_id"] for s in pred_segments}
        gt_cat = {s["id"]: s["category_id"] for s in gt_segments}
        # panopticapi crowd semantics: crowd GT segments never match and never
        # count as FN; their area shields same-class predictions from FP.
        gt_crowd = {s["id"] for s in gt_segments if s.get("iscrowd", 0)}
        # joint histogram of (gt_id, pred_id)
        joint = gt_map.astype(np.int64) * (2 ** 24) + pred_map.astype(np.int64)
        ids, counts = np.unique(joint, return_counts=True)
        inter = {(int(i // 2 ** 24), int(i % 2 ** 24)): int(c)
                 for i, c in zip(ids, counts)}
        gt_area = defaultdict(int)
        pred_area = defaultdict(int)
        for (gi, pi), c in inter.items():
            gt_area[gi] += c
            pred_area[pi] += c

        matched_gt, matched_pred = set(), set()
        for (gi, pi), c in inter.items():
            if gi == self.void or pi == self.void:
                continue
            if gi not in gt_cat or pi not in pred_cat:
                continue
            if gi in gt_crowd:
                continue
            if gt_cat[gi] != pred_cat[pi]:
                continue
            union = (gt_area[gi] + pred_area[pi] - c
                     - inter.get((self.void, pi), 0))
            iou = c / max(union, 1)
            if iou > 0.5:
                cat = gt_cat[gi]
                self.tp[cat] += 1
                self.iou[cat] += iou
                matched_gt.add(gi)
                matched_pred.add(pi)
        for gi, cat in gt_cat.items():
            if gi in gt_crowd:
                continue
            if gi not in matched_gt and gt_area.get(gi, 0) > 0:
                self.fn[cat] += 1
        for pi, cat in pred_cat.items():
            if pi in matched_pred or pred_area.get(pi, 0) == 0:
                continue
            # predictions mostly covered by void (+ same-class crowd GT
            # regions, panopticapi pq_compute_single_core) don't count as FP.
            void_overlap = inter.get((self.void, pi), 0)
            void_overlap += sum(c for (gi2, pi2), c in inter.items()
                                if pi2 == pi and gi2 in gt_crowd
                                and gt_cat.get(gi2) == cat)
            if void_overlap / max(pred_area[pi], 1) > 0.5:
                continue
            self.fp[cat] += 1

    def evaluate(self) -> Dict[str, float]:
        def agg(mask):
            pq = sq = rq = 0.0
            n = 0
            for c in range(self.num_classes):
                if not mask[c]:
                    continue
                denom = self.tp[c] + 0.5 * self.fp[c] + 0.5 * self.fn[c]
                if denom == 0:
                    continue
                sq_c = self.iou[c] / max(self.tp[c], 1)
                rq_c = self.tp[c] / denom
                pq += sq_c * rq_c
                sq += sq_c
                rq += rq_c
                n += 1
            n = max(n, 1)
            return pq / n * 100, sq / n * 100, rq / n * 100

        all_mask = np.ones(self.num_classes, bool)
        pq, sq, rq = agg(all_mask)
        pq_th, _, _ = agg(self.is_thing)
        pq_st, _, _ = agg(~self.is_thing)
        return {"PQ": pq, "SQ": sq, "RQ": rq, "PQ_th": pq_th, "PQ_st": pq_st}


class SemSegEvaluator:
    """mIoU via confusion matrix; ignore label 255."""

    def __init__(self, num_classes: int, ignore_label: int = 255):
        self.n = num_classes
        self.ignore = ignore_label
        self.conf = np.zeros((num_classes, num_classes), np.int64)

    def add_image(self, pred: np.ndarray, gt: np.ndarray):
        valid = gt != self.ignore
        p = pred[valid].astype(np.int64)
        g = gt[valid].astype(np.int64)
        idx = g * self.n + p
        self.conf += np.bincount(idx, minlength=self.n * self.n).reshape(self.n, self.n)

    def evaluate(self) -> Dict[str, float]:
        # exact detectron2 SemSegEvaluator semantics (reference
        # detectron2/evaluation/sem_seg_evaluation.py:148-166): IoU summed
        # over gt-present classes but DIVIDED by the count of classes present
        # in gt OR pred (a hallucinated never-in-gt class drags mIoU down);
        # fwIoU weights by gt frequency; pACC = sum(tp)/sum(gt).
        tp = np.diag(self.conf).astype(np.float64)
        gt_total = self.conf.sum(1).astype(np.float64)
        pred_total = self.conf.sum(0).astype(np.float64)
        union = gt_total + pred_total - tp
        acc_valid = gt_total > 0
        iou_valid = (gt_total + pred_total) > 0
        iou = np.where(union > 0, tp / np.maximum(union, 1e-9), 0.0)
        acc = np.where(acc_valid, tp / np.maximum(gt_total, 1e-9), 0.0)
        class_weights = gt_total / max(gt_total.sum(), 1)
        return {
            "mIoU": float(iou[acc_valid].sum() / max(iou_valid.sum(), 1) * 100),
            "fwIoU": float((iou[acc_valid] * class_weights[acc_valid]).sum()
                           * 100),
            "mACC": float(acc[acc_valid].mean() * 100) if acc_valid.any()
                    else 0.0,
            "pACC": float(tp.sum() / max(self.conf.sum(), 1) * 100),
        }


class SemSegEvaluatorParts(SemSegEvaluator):
    """mIoU over the raw part label space PLUS a reduced confusion matrix over
    merged label groups (reference detectron2/evaluation/sem_seg_evaluation.py
    SemSegEvaluatorParts :200-260 — Pascal-Panoptic-Parts 'mIoU-PartS' uses 58
    merged classes via PASCAL_LABEL_PART_GROUP)."""

    def __init__(self, num_classes: int, label_group: Dict[int, int],
                 n_merged: int, ignore_label: int = 255):
        super().__init__(num_classes, ignore_label)
        self.label_group = dict(label_group)
        self.n_merged = n_merged
        self.conf_reduced = np.zeros((n_merged + 1, n_merged + 1), np.int64)
        # dense remap lut: raw id (1-based) -> merged group (0 = unmapped)
        max_id = max(self.label_group) if self.label_group else 0
        self.lut = np.zeros(max(max_id, num_classes) + 2, np.int64)
        for k, v in self.label_group.items():
            self.lut[k] = v

    def add_image(self, pred: np.ndarray, gt: np.ndarray):
        """pred: (H, W) contiguous 0-based class ids; gt likewise (already
        offset-corrected by the caller)."""
        super().add_image(pred, gt)
        # reference remaps pred+1 / gt+1 through the 1-based label_group table
        pm = self.lut[np.clip(pred.astype(np.int64) + 1, 0, len(self.lut) - 1)]
        gm = self.lut[np.clip(
            np.where(gt == self.ignore, 0, gt.astype(np.int64) + 1),
            0, len(self.lut) - 1)]
        valid = gm > 0
        col = np.where(pm[valid] > 0, pm[valid] - 1, self.n_merged)  # last col
        idx = (gm[valid] - 1) * (self.n_merged + 1) + col            # = unmapped
        binc = np.bincount(idx, minlength=self.n_merged * (self.n_merged + 1))
        self.conf_reduced[:self.n_merged, :] += binc.reshape(
            self.n_merged, self.n_merged + 1)

    def evaluate(self) -> Dict[str, float]:
        out = super().evaluate()
        conf = self.conf_reduced[:self.n_merged, :self.n_merged]
        tp = np.diag(conf).astype(np.float64)
        gt_total = conf.sum(1).astype(np.float64)
        pred_total = conf.sum(0).astype(np.float64)
        union = gt_total + pred_total - tp
        valid = gt_total > 0
        iou = np.where(union > 0, tp / np.maximum(union, 1e-9), 0.0)
        out["mIoU_parts"] = float(iou[valid].mean() * 100) if valid.any() else 0.0
        return out


class RefCOCOEvaluator:
    """oIoU (cumulated I/U) + precision@K for referring segmentation/boxes."""

    def __init__(self, thresholds: Sequence[float] = (0.5, 0.6, 0.7, 0.8, 0.9)):
        self.thresholds = thresholds
        self.i_sum = 0.0
        self.u_sum = 0.0
        self.hits = np.zeros(len(thresholds), np.int64)
        self.count = 0
        self.miou_sum = 0.0

    def add_image(self, pred_mask: np.ndarray, gt_mask: np.ndarray):
        p = pred_mask.astype(bool)
        g = gt_mask.astype(bool)
        inter = float(np.logical_and(p, g).sum())
        union = float(np.logical_or(p, g).sum())
        self.i_sum += inter
        self.u_sum += union
        iou = inter / max(union, 1e-9)
        self.miou_sum += iou
        for k, t in enumerate(self.thresholds):
            # STRICT >: reference _derive_refcoco_results uses np.sum(ious > K)
            # (detectron2/evaluation/coco_evaluation.py:437-441)
            if iou > t:
                self.hits[k] += 1
        self.count += 1

    def evaluate(self) -> Dict[str, float]:
        out = {"oIoU": self.i_sum / max(self.u_sum, 1e-9) * 100,
               "mIoU": self.miou_sum / max(self.count, 1) * 100}
        for k, t in enumerate(self.thresholds):
            out[f"P@{t}"] = self.hits[k] / max(self.count, 1) * 100
        return out
