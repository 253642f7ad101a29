"""Greedy NMS as a keep mask (counterpart of hipie_tpu/ops/nms.py).

Semantics of torchvision's batched_nms, which the reference calls: greedy
suppression in descending score order (ties in index order), boxes of different
classes never suppress each other. The pairwise IoU is one tensor op on the
boxes' device; the N-step greedy scan is a plain loop over its rows on the host.
"""

from __future__ import annotations

from typing import Optional

import torch

from hipie_plain.ops.box_ops import box_iou


def nms_keep_mask(boxes: torch.Tensor, scores: torch.Tensor,
                  class_ids: Optional[torch.Tensor], iou_threshold: float) -> torch.Tensor:
    """boxes (N, 4) xyxy, scores (N,), class_ids (N,) or None -> (N,) bool keep mask."""
    n = boxes.shape[0]
    order = torch.sort(-scores, stable=True).indices
    boxes_s = boxes[order]
    over = box_iou(boxes_s, boxes_s) > iou_threshold
    if class_ids is not None:
        cls_s = class_ids[order]
        over &= cls_s[:, None] == cls_s[None, :]
    over = over.triu(diagonal=1).cpu()
    suppressed = torch.zeros(n, dtype=torch.bool)
    keep_sorted = torch.zeros(n, dtype=torch.bool)
    for i in range(n):
        if not suppressed[i]:
            keep_sorted[i] = True
            suppressed |= over[i]
    keep = torch.zeros(n, dtype=torch.bool, device=boxes.device)
    keep[order] = keep_sorted.to(boxes.device)
    return keep
