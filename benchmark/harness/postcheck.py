"""Judging one image's post-processed result against the reference's
post-processing of the same model outputs, with room for near-ties.

Post-processing makes discrete choices (the class argmax, greedy NMS, the
top-k, the panoptic thresholds and each pixel's argmax). Two sound
implementations of it, say the host loop and a device kernel, may round a
near-tie apart, and one tie may move everything after it (a box kept or
suppressed changes the top-k; a segment's validity renumbers the rest). So a
discrete answer that differs counts as a flip only where the reference's own
numbers put every choice it depends on farther than a stated margin from its
threshold or from the neighbour it could swap with:

* scores and class probabilities: ``SCORE_MARGIN`` of the larger, relative;
* IoU against the NMS threshold: ``IOU_MARGIN``;
* a pixel's mask probability against its runner-up and against 0.5, and a
  segment's score against its threshold: ``PROB_MARGIN``;
* a segment's area ratio against its overlap threshold: ``RATIO_MARGIN``.

Instances are compared as sets of (query, class); panoptic pixels by the
segment they belong to (a thing by its query, stuff by its class), so that a
renumbering is not a flip. The continuous fields of what both sides give
(scores, boxes, mask logits of the shared instances; the semantic map) are
compared by their largest error relative to the largest magnitude.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

SCORE_MARGIN = 1e-3
IOU_MARGIN = 1e-3
PROB_MARGIN = 1e-3
RATIO_MARGIN = 1e-2


def _rel_max(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        return float("inf")
    if want.numel() == 0:
        return 0.0
    return float((got - want).abs().amax() / want.abs().amax().clamp(min=1e-30))


def _close(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a and b within SCORE_MARGIN of the larger."""
    return (a - b).abs() <= SCORE_MARGIN * torch.maximum(a.abs(), b.abs())


def _runner_up_tie(prob: torch.Tensor) -> torch.Tensor:
    """(N, C) -> (N,) True where the best and second best are near-tied."""
    if prob.shape[-1] < 2:
        return torch.zeros(prob.shape[0], dtype=torch.bool, device=prob.device)
    top = prob.topk(2, dim=-1).values
    return _close(top[:, 0], top[:, 1])


def nms_ties(boxes: torch.Tensor, scores: torch.Tensor, cls_tie: torch.Tensor,
             classes: torch.Tensor, thresh: float) -> torch.Tensor:
    """(N,) True for the queries whose keep decision a near-tie could change:
    an IoU within IOU_MARGIN of the threshold, two overlapping scores within
    SCORE_MARGIN, a near-tied class, or an overlap with such a query earlier in
    the greedy order."""
    from hipie_plain.ops.box_ops import box_iou

    n = boxes.shape[0]
    order = torch.sort(-scores, stable=True).indices
    iou = box_iou(boxes[order], boxes[order])
    cls, tie_c, sc = classes[order], cls_tie[order], scores[order]
    same = (cls[:, None] == cls[None, :]) | tie_c[:, None] | tie_c[None, :]
    over = (iou > thresh - IOU_MARGIN) & same
    near = ((iou - thresh).abs() <= IOU_MARGIN) & same
    near |= over & _close(sc[:, None], sc[None, :])
    near.fill_diagonal_(False)
    over = over.triu(diagonal=1).cpu()
    tied = (tie_c | near.any(0) | near.any(1)).cpu()
    for i in range(n):
        if tied[i]:
            tied |= over[i]
    out = torch.zeros(n, dtype=torch.bool, device=boxes.device)
    out[order] = tied.to(boxes.device)
    return out


def instance_flips(res, raw: Dict[str, torch.Tensor], img: int, ref) -> Tuple[float, int, int]:
    """(error, flips, ties) of the instances (scores, classes, boxes, masks)."""
    from hipie_plain.models.postprocess import grounding_to_od_logits
    from hipie_plain.ops.box_ops import box_cxcywh_to_xyxy
    from hipie_plain.ops.nms import nms_keep_mask

    mc, tc = ref.mc, ref.test_cfg
    fg = mc.transformer.num_bg_queries
    logits = raw["pred_logits"][img][fg:]
    prob = grounding_to_od_logits(logits, ref.maps, mode="FG",
                                  max_pool=tc.max_pool_tokens).sigmoid()
    if raw.get("pred_boxious") is not None:
        prob = (prob * raw["pred_boxious"][img][fg:].float().sigmoid()).sqrt()
    boxes = box_cxcywh_to_xyxy(raw["pred_boxes"][img][fg:].float())
    masks = raw["pred_masks"][img][fg:].float()
    n_cls = prob.shape[1]
    scores, classes = prob.amax(1), prob.argmax(1)
    tied_q = nms_ties(boxes, scores, _runner_up_tie(prob), classes, tc.nms_thresh)
    keep = nms_keep_mask(boxes, scores, classes, tc.nms_thresh)
    k = min(tc.detections_per_image, int(keep.sum()) * n_cls)
    top = prob.masked_fill(~keep[:, None], float("-inf")).reshape(-1).topk(k)
    kth = top.values[-1]
    want = {(int(i) // n_cls, int(i) % n_cls) for i in top.indices}
    # the program's instances, each found among the queries by its class, box and score
    got, unknown = [], 0
    for s, c, b in zip(res.scores.float(), res.classes.long(), res.boxes.float()):
        d = (boxes - b).abs().amax(1) + (prob[:, c] - s).abs()
        q = int(d.argmin())
        if float(d[q]) > 1e-4 or (q, int(c)) in got:
            unknown += 1
        else:
            got.append((q, int(c)))
    ties = flips = 0
    for q, c in set(got) ^ want:
        if bool(tied_q[q]) or bool(_close(prob[q, c], kth)):
            ties += 1
        else:
            flips += 1
    shared = [(i, e) for i, e in enumerate(got) if e in want]
    err = 0.0
    if shared:
        rows = torch.tensor([i for i, _ in shared], device=boxes.device)
        qs = torch.tensor([q for _, (q, _) in shared], device=boxes.device)
        cs = torch.tensor([c for _, (_, c) in shared], device=boxes.device)
        err = max(_rel_max(res.scores[rows], prob[qs, cs]), _rel_max(res.boxes[rows], boxes[qs]),
                  _rel_max(res.mask_logits[rows], masks[qs]))
    return err, flips + unknown, ties


def _canonical(panoptic, valid, classes, is_thing, n):
    """Each pixel's segment as a thing's query or N + a stuff class; -1 void."""
    qs = torch.nonzero(valid).flatten()
    lab = torch.where(is_thing[classes[qs].long()], qs, n + classes[qs].long())
    table = torch.cat([torch.full((1,), -1, device=lab.device, dtype=lab.dtype), lab])
    return table[panoptic.long().clamp(min=0, max=qs.numel())]


def panoptic_flips(res, want, raw: Dict[str, torch.Tensor], img: int, ref) -> Tuple[int, int]:
    """(flips, ties) of the panoptic map and the segments' validity and classes."""
    from hipie_plain.models.postprocess import grounding_to_od_logits, transform_probs

    tc, maps = ref.test_cfg, ref.maps
    md = raw.get("maskdino")
    if md is None or not tc.use_bg_for_pano:
        raise NotImplementedError("near-ties are worked out for MaskDINO's bg branch only")
    prob = transform_probs(grounding_to_od_logits(md["pred_logits"][img], maps,
                                                  max_pool=tc.max_pool_tokens),
                           temperature=tc.pano_temperature, transform_eval=tc.transform_eval)
    masks = md["pred_masks"][img].float().masked_fill(ref.pad_s4[None], -1e4)
    n = prob.shape[0]
    scores, labels = prob.max(-1)
    probs = masks.sigmoid()
    keep = scores > tc.panoptic_object_mask_thresh
    pm = torch.where(keep[:, None, None], scores[:, None, None] * probs,
                     torch.full_like(probs, -1.0))
    top2 = pm.topk(2, dim=0)
    owner = top2.indices[0]
    p_own = probs.gather(0, owner[None])[0]
    pixel_tie = ((top2.values[0] - top2.values[1]).abs() <= PROB_MARGIN)
    pixel_tie |= (p_own - 0.5).abs() <= PROB_MARGIN
    one_hot = torch.nn.functional.one_hot(owner, n).permute(2, 0, 1).float()
    one_hot = one_hot.masked_fill(ref.pad_s4[None], 0.0)
    binary = (probs >= 0.5).float()
    area, orig = one_hot.sum((1, 2)), binary.sum((1, 2))
    ratio = area / orig.clamp(min=1.0)
    q_tie = _runner_up_tie(prob)
    q_tie |= (scores - tc.panoptic_object_mask_thresh).abs() <= PROB_MARGIN
    q_tie |= keep & ((ratio - tc.panoptic_overlap_thresh).abs() <= RATIO_MARGIN)
    # an area that tied pixels could empty
    tied_px = (one_hot * pixel_tie[None]).sum((1, 2))
    q_tie |= keep & (area > 0) & (area <= tied_px)
    stuff = ~maps.is_thing[labels.long()]
    tied_cls = torch.zeros(prob.shape[1], dtype=torch.bool, device=prob.device)
    tied_cls[labels[q_tie & stuff].long()] = True
    q_tie |= stuff & tied_cls[labels.long()]            # another stuff query of its class tied
    is_thing = maps.is_thing
    a = _canonical(res.panoptic, res.segment_valid, res.segment_classes, is_thing, n)
    b = _canonical(want.panoptic, want.segment_valid, want.segment_classes, is_thing, n)
    differ = a != b
    px_tie = pixel_tie | q_tie[owner]
    flips = int((differ & ~px_tie).sum())
    ties = int((differ & px_tie).sum())
    for name in ("segment_valid", "segment_classes"):
        d = getattr(res, name) != getattr(want, name)
        flips += int((d & ~q_tie).sum())
        ties += int((d & q_tie).sum())
    return flips, ties


def compare(res, want, raw: Dict[str, torch.Tensor], img: int, ref) -> Tuple[float, int, int]:
    """(largest continuous error, flips, near-ties) of one image's result
    ``res`` against ``want``, the reference's post-processing of ``raw``."""
    err, flips, ties = instance_flips(res, raw, img, ref)
    if (res.sem_seg is None) != (want.sem_seg is None):
        return err, flips + 1, ties
    if want.sem_seg is not None:
        err = max(err, _rel_max(res.sem_seg, want.sem_seg))
        f, t = panoptic_flips(res, want, raw, img, ref)
        flips, ties = flips + f, ties + t
    return err, flips, ties
