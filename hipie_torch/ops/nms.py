"""Greedy NMS as a keep mask (counterpart of hipie_tpu/ops/nms.py).

Semantics of torchvision's batched_nms, which the reference calls: greedy
suppression in descending score order (ties in index order), boxes of different
classes never suppress each other.

``nms_keep_mask`` takes a CPU tensor to the plain version and a CUDA tensor to
kernel K-F (``hipie_torch/csrc/nms.cu``); there is no fallback between the two.
The plain version computes the pairwise IoU as one tensor op and runs the N-step
greedy scan as a loop over its rows on the host (span ``post.nms_scan``),
between a copy to the host and a copy back (``host_sync.nms_*``, blocking where
the boxes live on a card). K-F builds the suppression mask and runs the scan on
the card: nothing goes to the host and nothing blocks, and its keep mask is the
plain version's bit for bit.
"""

from __future__ import annotations

from typing import Optional

import torch

from hipie_torch import kernels
from hipie_torch.ops.box_ops import box_iou
from hipie_torch.utils.trace import count, span

TILE = 64            # boxes a mask word covers; the C library's kTile


def nms_keep_mask_plain(boxes: torch.Tensor, scores: torch.Tensor,
                        class_ids: Optional[torch.Tensor], iou_threshold: float) -> torch.Tensor:
    """The plain version: IoU on the boxes' device, the scan on the host."""
    with span("post.nms"):
        n = boxes.shape[0]
        order = torch.sort(-scores, stable=True).indices
        boxes_s = boxes[order]
        over = box_iou(boxes_s, boxes_s) > iou_threshold
        if class_ids is not None:
            cls_s = class_ids[order]
            over &= cls_s[:, None] == cls_s[None, :]
        count("host_sync.nms_to_host")
        over = over.triu(diagonal=1).cpu()
        suppressed = torch.zeros(n, dtype=torch.bool)
        keep_sorted = torch.zeros(n, dtype=torch.bool)
        with span("post.nms_scan"):
            for i in range(n):
                if not suppressed[i]:
                    keep_sorted[i] = True
                    suppressed |= over[i]
        keep = torch.zeros(n, dtype=torch.bool, device=boxes.device)
        count("host_sync.nms_to_device")     # a blocking copy from pageable memory
        keep[order] = keep_sorted.to(boxes.device)
        return keep


def nms_keep_mask(boxes: torch.Tensor, scores: torch.Tensor,
                  class_ids: Optional[torch.Tensor], iou_threshold: float) -> torch.Tensor:
    """boxes (N, 4) xyxy, scores (N,), class_ids (N,) or None -> (N,) bool keep mask
    on the boxes' device. On a card: boxes f32, scores floating, class ids int64,
    all on the boxes' card."""
    if boxes.device.type == "cpu":
        return nms_keep_mask_plain(boxes, scores, class_ids, iou_threshold)
    if boxes.device.type != "cuda":
        raise ValueError(f"nms_keep_mask: unsupported device {boxes.device}")
    if boxes.dim() != 2 or boxes.shape[1] != 4 or boxes.dtype != torch.float32:
        raise ValueError(f"nms_keep_mask: boxes must be (N, 4) float32, got "
                         f"{tuple(boxes.shape)} {boxes.dtype}")
    n = boxes.shape[0]
    if tuple(scores.shape) != (n,) or not scores.is_floating_point():
        raise ValueError(f"nms_keep_mask: scores must be ({n},) floating, got "
                         f"{tuple(scores.shape)} {scores.dtype}")
    if class_ids is not None and (tuple(class_ids.shape) != (n,) or class_ids.dtype != torch.int64):
        raise ValueError(f"nms_keep_mask: class_ids must be ({n},) int64, got "
                         f"{tuple(class_ids.shape)} {class_ids.dtype}")
    for name, t in (("scores", scores), ("class_ids", class_ids)):
        if t is not None and t.device != boxes.device:
            raise ValueError(f"nms_keep_mask: {name} on {t.device}, boxes on {boxes.device}")
    keep = torch.empty(n, dtype=torch.bool, device=boxes.device)
    if n == 0:
        return keep
    from hipie_torch.kernels import build

    lib = build.load()
    if n > lib.hipie_nms_max_boxes():
        raise ValueError(f"nms_keep_mask: {n} boxes, K-F takes at most "
                         f"{lib.hipie_nms_max_boxes()}")
    with span("post.nms"):
        boxes = boxes.contiguous()
        cls = None if class_ids is None else class_ids.contiguous()
        order = torch.sort(-scores, stable=True).indices
        mask = torch.empty(((n + TILE - 1) // TILE, n), dtype=torch.int64, device=boxes.device)
        err = lib.hipie_nms(boxes.data_ptr(), order.data_ptr(),
                            None if cls is None else cls.data_ptr(), n, iou_threshold,
                            mask.data_ptr(), keep.data_ptr(),
                            torch.cuda.current_stream(boxes.device).cuda_stream)
        build.check(err, "nms_keep_mask")
        kernels.LAUNCHES["nms"] += 1
        return keep
