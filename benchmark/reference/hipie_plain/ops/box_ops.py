"""Box utilities (counterpart of hipie_tpu/ops/box_ops.py): cxcywh / xyxy
conversion, pairwise and elementwise IoU and generalized IoU, and boxes around
binary masks. Every function broadcasts over leading batch dims."""

from __future__ import annotations

import torch


def box_cxcywh_to_xyxy(b: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], -1)


def box_xyxy_to_cxcywh(b: torch.Tensor) -> torch.Tensor:
    x0, y0, x1, y1 = b.unbind(-1)
    return torch.stack([(x0 + x1) / 2, (y0 + y1) / 2, x1 - x0, y1 - y0], -1)


def box_area(b: torch.Tensor) -> torch.Tensor:
    return (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])


def _iou_union(boxes1: torch.Tensor, boxes2: torch.Tensor):
    area1, area2 = box_area(boxes1), box_area(boxes2)
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[..., :, None] + area2[..., None, :] - inter
    return inter / union.clamp(min=1e-6), union


def box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of (N, 4) and (M, 4) xyxy boxes -> (N, M)."""
    return _iou_union(boxes1, boxes2)[0]


def generalized_box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise GIoU of (N, 4) and (M, 4) xyxy boxes -> (N, M)."""
    iou, union = _iou_union(boxes1, boxes2)
    lt = torch.minimum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.maximum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    area = wh[..., 0] * wh[..., 1]
    return iou - (area - union) / area.clamp(min=1e-6)


def _elementwise(boxes1: torch.Tensor, boxes2: torch.Tensor):
    area1, area2 = box_area(boxes1), box_area(boxes2)
    lt = torch.maximum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.minimum(boxes1[..., 2:], boxes2[..., 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1 + area2 - inter
    return inter / union.clamp(min=1e-6), union


def elementwise_box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """IoU of matching rows of two (..., 4) xyxy box arrays -> (...)."""
    return _elementwise(boxes1, boxes2)[0]


def elementwise_generalized_box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """GIoU of matching rows of two (..., 4) xyxy box arrays -> (...)."""
    iou, union = _elementwise(boxes1, boxes2)
    lt = torch.minimum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.maximum(boxes1[..., 2:], boxes2[..., 2:])
    wh = (rb - lt).clamp(min=0.0)
    area = wh[..., 0] * wh[..., 1]
    return iou - (area - union) / area.clamp(min=1e-6)


def masks_to_boxes(masks: torch.Tensor) -> torch.Tensor:
    """xyxy boxes (N, 4) around (N, H, W) binary masks, in pixels with the max
    edge exclusive; an empty mask gives (0, 0, 0, 0)."""
    n, h, w = masks.shape
    m = masks > 0
    ys = torch.arange(h, dtype=torch.float32, device=masks.device)[None, :, None]
    xs = torch.arange(w, dtype=torch.float32, device=masks.device)[None, None, :]
    big = 1e8
    x_min = torch.where(m, xs, big).amin((1, 2))
    x_max = torch.where(m, xs, -big).amax((1, 2))
    y_min = torch.where(m, ys, big).amin((1, 2))
    y_max = torch.where(m, ys, -big).amax((1, 2))
    boxes = torch.stack([x_min, y_min, x_max + 1, y_max + 1], -1)
    return torch.where(m.flatten(1).any(1)[:, None], boxes, torch.zeros_like(boxes))
