"""COCO-style AP evaluation (bbox + segm), pycocotools-compatible, pure numpy.

The port's copy of hipie_tpu/evaluation/coco_eval.py.

Replaces detectron2/evaluation/coco_evaluation.py + pycocotools COCOeval +
the C++ fast accumulate (detectron2 fast_eval_api.py). Matching and accumulation
follow the COCOeval algorithm exactly: 10 IoU thresholds .5:.95, 101 recall
points, areaRng all/small/medium/large, maxDets 100, greedy per-category
score-ordered matching with crowd handling.

Mask IoUs come from the native kernel (hipie_torch/native) when it is built;
the matching and accumulation here are numpy.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from hipie_torch.evaluation.rle import box_iou_matrix, mask_iou_matrix, rle_decode, rle_encode

IOU_THRS = np.linspace(0.5, 0.95, 10)
RECALL_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNG = {
    "all": (0.0, 1e10), "small": (0.0, 32 ** 2),
    "medium": (32 ** 2, 96 ** 2), "large": (96 ** 2, 1e10),
}


def _evaluate_image(dets: List[dict], gts: List[dict], ious: np.ndarray,
                    area_rng, max_det: int):
    """Greedy matching for one (image, category); returns match arrays."""
    # pycocotools area-range membership is inclusive on BOTH ends
    # (ignore iff area < lo or area > hi): a 32x32 object (area 1024) belongs
    # to both 'small' and 'medium'.
    gt_ignore = np.array(
        [g.get("iscrowd", 0) or not (area_rng[0] <= g["area"] <= area_rng[1])
         for g in gts], bool)
    # sort gts: non-ignored first (stable)
    g_order = np.argsort(gt_ignore, kind="stable")
    gts = [gts[i] for i in g_order]
    gt_ignore = gt_ignore[g_order]
    d_order = np.argsort([-d["score"] for d in dets], kind="stable")[:max_det]
    dets = [dets[i] for i in d_order]
    ious = ious[d_order][:, g_order] if len(dets) and len(gts) else ious

    T = len(IOU_THRS)
    D, G = len(dets), len(gts)
    dt_m = np.zeros((T, D), np.int64) - 1
    gt_m = np.zeros((T, G), np.int64) - 1
    dt_ig = np.zeros((T, D), bool)
    for t, thr in enumerate(IOU_THRS):
        for di in range(D):
            best = thr if thr > 1e-10 else 1e-10
            best_j = -1
            for gj in range(G):
                if gt_m[t, gj] >= 0 and not gts[gj].get("iscrowd", 0):
                    continue
                if best_j >= 0 and not gt_ignore[best_j] and gt_ignore[gj]:
                    break   # gts sorted: once we hit ignored with a valid match, stop
                if ious[di, gj] < best:
                    continue
                best = ious[di, gj]
                best_j = gj
            if best_j == -1:
                continue
            dt_m[t, di] = best_j
            gt_m[t, best_j] = di
            dt_ig[t, di] = gt_ignore[best_j]
    # unmatched dets outside area range are ignored.
    d_area_ig = np.array(
        [not (area_rng[0] <= d["area"] <= area_rng[1]) for d in dets], bool)
    dt_ig = dt_ig | ((dt_m == -1) & d_area_ig[None, :])
    return {
        "scores": np.array([d["score"] for d in dets]),
        "dt_matched": dt_m >= 0,
        "dt_ignore": dt_ig,
        "num_gt": int((~gt_ignore).sum()),
    }


class COCOApEvaluator:
    """Accumulates predictions and computes AP/AR per the COCOeval protocol."""

    def __init__(self, iou_type: str = "bbox", max_det: int = 100):
        assert iou_type in ("bbox", "segm")
        self.iou_type = iou_type
        self.max_det = max_det
        self._dets: Dict[Any, Dict[int, List[dict]]] = defaultdict(lambda: defaultdict(list))
        self._gts: Dict[Any, Dict[int, List[dict]]] = defaultdict(lambda: defaultdict(list))
        self._cats: set = set()
        self._imgs: set = set()

    def add_image(self, image_id, gt_anns: List[dict], det_anns: List[dict]):
        """gt ann: {category_id, bbox xyxy | mask, area, iscrowd}; det adds score."""
        self._imgs.add(image_id)
        for g in gt_anns:
            self._gts[image_id][g["category_id"]].append(g)
            self._cats.add(g["category_id"])
        for d in det_anns:
            self._dets[image_id][d["category_id"]].append(d)
            self._cats.add(d["category_id"])

    def share(self) -> Dict[str, Any]:
        """This evaluator's images as plain data, masks RLE-encoded: what a
        data-parallel rank sends to the one that computes the metrics."""
        enc = lambda a: ({**a, "mask": rle_encode(np.asarray(a["mask"], bool))}
                         if "mask" in a else a)
        plain = lambda store: {img: {cat: [enc(a) for a in anns] for cat, anns in by_cat.items()}
                               for img, by_cat in store.items()}
        return {"imgs": list(self._imgs), "gts": plain(self._gts), "dets": plain(self._dets)}

    def merge(self, share: Dict[str, Any]) -> None:
        """Add another rank's ``share`` (its image ids are not this one's)."""
        dec = lambda a: {**a, "mask": rle_decode(a["mask"])} if "mask" in a else a
        self._imgs.update(share["imgs"])
        for key, store in (("gts", self._gts), ("dets", self._dets)):
            for img, by_cat in share[key].items():
                for cat, anns in by_cat.items():
                    store[img][cat].extend(dec(a) for a in anns)
                    self._cats.add(cat)

    def _ious(self, dets, gts):
        crowd = [g.get("iscrowd", 0) for g in gts]
        if self.iou_type == "bbox":
            db = np.array([d["bbox"] for d in dets], np.float64).reshape(-1, 4)
            gb = np.array([g["bbox"] for g in gts], np.float64).reshape(-1, 4)
            return box_iou_matrix(db, gb, crowd)
        return mask_iou_matrix([d["mask"] for d in dets],
                               [g["mask"] for g in gts], crowd)

    def evaluate(self) -> Dict[str, float]:
        cats = sorted(self._cats)
        T, R, K = len(IOU_THRS), len(RECALL_THRS), len(cats)
        areas = list(AREA_RNG)
        precision = -np.ones((T, R, K, len(areas)))
        recall = -np.ones((T, K, len(areas)))
        for ki, cat in enumerate(cats):
            per_img = []
            # sorted image order matches pycocotools' sorted imgIds: the
            # global mergesort below is stable, so tied-score detections
            # interleave identically (and set-iteration order would vary
            # with hash randomization for string ids).
            for img in sorted(self._imgs):
                dets = self._dets[img].get(cat, [])
                gts = self._gts[img].get(cat, [])
                if not dets and not gts:
                    continue
                ious = self._ious(dets, gts)
                per_img.append((dets, gts, ious))
            for ai, aname in enumerate(areas):
                rng = AREA_RNG[aname]
                evs = [_evaluate_image(d, g, i, rng, self.max_det)
                       for d, g, i in per_img]
                if not evs:
                    continue
                scores = np.concatenate([e["scores"] for e in evs])
                order = np.argsort(-scores, kind="mergesort")
                matched = np.concatenate([e["dt_matched"] for e in evs], 1)[:, order]
                ignored = np.concatenate([e["dt_ignore"] for e in evs], 1)[:, order]
                n_gt = sum(e["num_gt"] for e in evs)
                if n_gt == 0:
                    continue
                tp = np.cumsum(matched & ~ignored, 1).astype(np.float64)
                fp = np.cumsum(~matched & ~ignored, 1).astype(np.float64)
                for t in range(T):
                    rc = tp[t] / n_gt
                    pr = tp[t] / np.maximum(tp[t] + fp[t], 1e-9)
                    recall[t, ki, ai] = rc[-1] if len(rc) else 0.0
                    # precision envelope
                    pr = pr.tolist()
                    for i in range(len(pr) - 1, 0, -1):
                        pr[i - 1] = max(pr[i - 1], pr[i])
                    inds = np.searchsorted(rc, RECALL_THRS, side="left")
                    q = np.zeros(R)
                    for ri, pi in enumerate(inds):
                        if pi < len(pr):
                            q[ri] = pr[pi]
                    precision[t, :, ki, ai] = q

        def ap(t_slice=slice(None), area="all"):
            ai = areas.index(area)
            p = precision[t_slice, :, :, ai]
            p = p[p > -1]
            return float(p.mean()) if p.size else float("nan")

        t50 = IOU_THRS.searchsorted(0.5)
        t75 = IOU_THRS.searchsorted(0.75)
        return {
            "AP": ap() * 100,
            "AP50": ap(slice(t50, t50 + 1)) * 100,
            "AP75": ap(slice(t75, t75 + 1)) * 100,
            "APs": ap(area="small") * 100,
            "APm": ap(area="medium") * 100,
            "APl": ap(area="large") * 100,
        }
