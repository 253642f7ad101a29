"""Inference post-processing (counterpart of hipie_tpu/models/postprocess.py).

Token->class pooling, score fusion, NMS, top-k instance selection, semantic
and panoptic fusion, all static-shape tensor code as in the JAX package
(reference hipie_img.py inference, semantic_inference, panoptic_inference).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from hipie_plain.ops.box_ops import box_cxcywh_to_xyxy
from hipie_plain.ops.nms import nms_keep_mask

NEG_INF = -9999.0


class ClassMaps(NamedTuple):
    """Dense per-dataset class/token layout, built on the host from the label set."""

    mean_weights: torch.Tensor    # (C, L) rows sum to 1 over the class's tokens
    token_mask: torch.Tensor      # (C, L) bool, True where a token belongs to the class
    is_thing: torch.Tensor        # (C,) bool


def grounding_to_od_logits(logits: torch.Tensor, maps: ClassMaps, mode: Optional[str] = None,
                           max_pool: bool = False) -> torch.Tensor:
    """(Q, L) token logits -> (Q, C) class logits; masked classes get -9999."""
    logits = logits.float()
    if logits.shape[-1] == 1:
        return logits
    has_tokens = maps.token_mask.any(-1)
    if max_pool:
        scores = torch.where(maps.token_mask[None], logits[:, None, :],
                             torch.finfo(torch.float32).min).amax(-1)
    else:
        scores = logits @ maps.mean_weights.float().T
        scores = scores.masked_fill(~has_tokens[None], NEG_INF)
    if mode == "FG":
        scores = scores.masked_fill(~maps.is_thing[None], NEG_INF)
    elif mode == "BG":
        scores = scores.masked_fill(maps.is_thing[None], NEG_INF)
    return scores


class InstanceOutput(NamedTuple):
    scores: torch.Tensor       # (K,)
    classes: torch.Tensor      # (K,) int32
    boxes: torch.Tensor        # (K, 4) xyxy, normalised
    mask_logits: torch.Tensor  # (K, H4, W4)
    keep_fg: torch.Tensor      # (Q,) bool, NMS survivors


def fg_instance_inference(token_logits, boxes_cxcywh, mask_logits, iou_logits, maps: ClassMaps,
                          max_detections: int = 100, nms_thresh: float = 0.7,
                          has_thing: bool = True, max_pool: bool = False) -> InstanceOutput:
    """Reference inference() fg path for one image."""
    cls_logits = grounding_to_od_logits(token_logits, maps,
                                        mode="FG" if has_thing else None, max_pool=max_pool)
    prob = cls_logits.sigmoid()
    if iou_logits is not None:
        prob = (prob * iou_logits.float().sigmoid()).sqrt()
    boxes_xyxy = box_cxcywh_to_xyxy(boxes_cxcywh.float())
    keep = nms_keep_mask(boxes_xyxy, prob.amax(1), prob.argmax(1), nms_thresh)
    flat = prob.masked_fill(~keep[:, None], float("-inf")).reshape(-1)
    top_scores, top_idx = flat.topk(max_detections)
    c = prob.shape[1]
    q_idx = torch.div(top_idx, c, rounding_mode="floor")
    return InstanceOutput(scores=top_scores, classes=(top_idx % c).int(),
                          boxes=boxes_xyxy[q_idx], mask_logits=mask_logits[q_idx].float(),
                          keep_fg=keep)


def semantic_inference(mask_cls_prob, mask_logits):
    """(N, C) prob x sigmoid((N, h, w)) -> (C, h, w)."""
    return torch.einsum("qc,qhw->chw", mask_cls_prob.float(), mask_logits.float().sigmoid())


class PanopticOutput(NamedTuple):
    panoptic_seg: torch.Tensor     # (h, w) int32 segment ids, 0 = void
    segment_valid: torch.Tensor    # (N,) bool, query opened a new segment
    segment_ids: torch.Tensor      # (N,) int32 id of each query (0 = none)
    segment_classes: torch.Tensor  # (N,) int32
    segment_isthing: torch.Tensor  # (N,) bool


def panoptic_inference(mask_cls_prob, mask_logits, is_thing, object_mask_threshold: float = 0.25,
                       overlap_threshold: float = 0.8,
                       pad_mask: Optional[torch.Tensor] = None) -> PanopticOutput:
    """Vectorised reference panoptic_inference: segment ids in ascending query order."""
    n, n_cls = mask_cls_prob.shape
    scores, labels = mask_cls_prob.float().max(-1)
    labels = labels.int()
    probs = mask_logits.float().sigmoid()
    keep = scores > object_mask_threshold
    prob_masks = torch.where(keep[:, None, None], scores[:, None, None] * probs,
                             torch.full_like(probs, -1.0))
    mask_ids = prob_masks.argmax(0)
    binary = probs >= 0.5
    one_hot = torch.nn.functional.one_hot(mask_ids, n).permute(2, 0, 1).float()
    if pad_mask is not None:
        one_hot = one_hot.masked_fill(pad_mask[None], 0.0)
    mask_area = one_hot.sum((1, 2))
    original_area = binary.float().sum((1, 2))
    final_area = (one_hot * binary.float()).sum((1, 2))
    valid = (keep & (mask_area > 0) & (original_area > 0) & (final_area > 0)
             & (mask_area / original_area.clamp(min=1.0) >= overlap_threshold))

    query_isthing = is_thing[labels.long()]
    order = torch.arange(n, device=labels.device, dtype=torch.int32)
    stuff_valid = valid & ~query_isthing
    big = torch.full_like(order, n)
    lab0 = torch.where(stuff_valid, labels, torch.zeros_like(labels)).long()
    first_stuff = torch.full((n_cls,), n, dtype=torch.int32, device=labels.device)
    first_stuff = first_stuff.scatter_reduce(0, lab0, torch.where(stuff_valid, order, big),
                                             reduce="amin")
    primary = stuff_valid & (first_stuff[labels.long()] == order)
    new_segment = valid & (query_isthing | primary)
    seg_ids_new = new_segment.int().cumsum(0).int()
    seg_id_per_query = torch.where(new_segment, seg_ids_new, torch.zeros_like(seg_ids_new))
    labp = torch.where(primary, labels, torch.zeros_like(labels)).long()
    primary_ids = torch.zeros(n_cls, dtype=torch.int32, device=labels.device).scatter_reduce(
        0, labp, torch.where(primary, seg_id_per_query, torch.zeros_like(seg_id_per_query)),
        reduce="amax")
    merged = stuff_valid & ~primary
    seg_id_per_query = torch.where(merged, primary_ids[labels.long()], seg_id_per_query)

    binary_at_pixel = binary.gather(0, mask_ids[None])[0]
    panoptic = torch.where(binary_at_pixel, seg_id_per_query[mask_ids],
                           torch.zeros_like(mask_ids, dtype=torch.int32))
    return PanopticOutput(panoptic_seg=panoptic.int(), segment_valid=new_segment,
                          segment_ids=seg_id_per_query, segment_classes=labels,
                          segment_isthing=query_isthing)


def transform_probs(cls_logits, temperature: float = 0.06, transform_eval: bool = True):
    """sigmoid [-> softmax(sigmoid / T)] score transform."""
    p = cls_logits.float().sigmoid()
    if transform_eval and cls_logits.shape[-1] > 1:
        p = (p / temperature).softmax(-1)
    return p
