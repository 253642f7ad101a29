"""Host-side image/annotation transforms without cv2.

Counterpart of hipie_tpu/data/transforms.py (reference detectron2 transforms
as configured by coco_dataset_mapper_uni.py build_transform_gen: test-time
ResizeShortestEdge; training LSJ = ResizeScale 0.1..2.0 + FixedSizeCrop, or
multi-scale ResizeShortestEdge, then RandomFlip, with left/right swapped in
flipped referring expressions; CondInst mask downsampling).

Two resizes to the shortest edge, one size rule: the predictor's
``resize_shortest_edge`` is ``F.interpolate`` bilinear (half-pixel centres,
edge clamping, no antialiasing: cv2.INTER_LINEAR on a float image) and gives
float32; the mapper's ``resize_shortest_edge_np`` and ``random_resize_scale``
resize with ``image_io.resize_bilinear``, numpy, in the image's own dtype
class, as the JAX package's cv2 calls do. The rest is the JAX package's numpy,
copied.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from hipie_torch.data.image_io import resize_bilinear as _resize_image


def shortest_edge_size(h: int, w: int, short: int, max_size: int) -> Tuple[int, int]:
    """The (h, w) that ResizeShortestEdge gives an h x w image."""
    scale = short / min(h, w)
    if max(h, w) * scale > max_size:
        scale = max_size / max(h, w)
    return int(round(h * scale)), int(round(w * scale))


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Resize the last two dims of a (..., H, W) tensor; cv2.INTER_LINEAR semantics."""
    lead = x.shape[:-2]
    y = F.interpolate(x.reshape(1, -1, *x.shape[-2:]), size=size, mode="bilinear",
                      align_corners=False, antialias=False)
    return y.reshape(*lead, *size)


def resize_shortest_edge(img: np.ndarray, short: int, max_size: int):
    """(H, W, C) image -> (resized float32 (h, w, C) array, scale (sy, sx))."""
    h, w = img.shape[:2]
    nh, nw = shortest_edge_size(h, w, short, max_size)
    chw = torch.from_numpy(np.ascontiguousarray(img, dtype=np.float32)).permute(2, 0, 1)
    out = resize_bilinear(chw, (nh, nw)).permute(1, 2, 0).contiguous().numpy()
    return out, (nh / h, nw / w)


def pad_to_bucket(img: np.ndarray, bucket_hw: Tuple[int, int]):
    """Pad bottom/right to a static bucket; returns (padded, pad_mask)."""
    h, w = img.shape[:2]
    bh, bw = bucket_hw
    assert h <= bh and w <= bw, f"image {h}x{w} exceeds bucket {bh}x{bw}"
    out = np.zeros((bh, bw) + img.shape[2:], img.dtype)
    out[:h, :w] = img
    mask = np.ones((bh, bw), bool)
    mask[:h, :w] = False
    return out, mask


def resize_shortest_edge_np(img: np.ndarray, short: int, max_size: int):
    """The mapper's resize: (resized img (uint8 stays uint8, float -> float32),
    scale (sy, sx)), as hipie_tpu's cv2 ``resize_shortest_edge``."""
    h, w = img.shape[:2]
    nh, nw = shortest_edge_size(h, w, short, max_size)
    return _resize_image(img, (nh, nw)), (nh / h, nw / w)


def random_resize_scale(rng: np.random.RandomState, img: np.ndarray,
                        min_scale: float, max_scale: float, target: int):
    """detectron2 ResizeScale: random scale of the target size, keep aspect."""
    s = rng.uniform(min_scale, max_scale)
    h, w = img.shape[:2]
    out_scale = min(s * target / h, s * target / w)
    nh, nw = int(h * out_scale), int(w * out_scale)
    return _resize_image(img, (max(nh, 1), max(nw, 1))), (nh / h, nw / w)


def fixed_size_crop(rng: np.random.RandomState, img: np.ndarray, size: int,
                    boxes: Optional[np.ndarray] = None,
                    masks: Optional[np.ndarray] = None):
    """Random crop (or pad offset 0) to (size, size); crops annotations too."""
    h, w = img.shape[:2]
    y0 = rng.randint(0, max(h - size, 0) + 1)
    x0 = rng.randint(0, max(w - size, 0) + 1)
    img_c = img[y0:y0 + size, x0:x0 + size]
    out_boxes = boxes            # empty arrays pass through unchanged
    if boxes is not None and len(boxes):
        out_boxes = boxes.copy()
        out_boxes[:, [0, 2]] -= x0
        out_boxes[:, [1, 3]] -= y0
        out_boxes = np.clip(out_boxes, 0, [img_c.shape[1], img_c.shape[0]] * 2)
    out_masks = masks
    if masks is not None and len(masks):
        out_masks = masks[:, y0:y0 + size, x0:x0 + size]
    return img_c, out_boxes, out_masks, (y0, x0)


def hflip(img: np.ndarray, boxes: Optional[np.ndarray] = None,
          masks: Optional[np.ndarray] = None):
    w = img.shape[1]
    img = np.ascontiguousarray(img[:, ::-1])
    if boxes is not None and len(boxes):
        boxes = boxes.copy()
        x0 = boxes[:, 0].copy()
        boxes[:, 0] = w - boxes[:, 2]
        boxes[:, 2] = w - x0
    if masks is not None and len(masks):
        masks = np.ascontiguousarray(masks[:, :, ::-1])
    return img, boxes, masks


def flip_expression(expr: str) -> str:
    """left <-> right swap for flipped referring expressions
    (coco_dataset_mapper_uni.py:342-354)."""
    expr = expr.replace("left", "@").replace("right", "left").replace("@", "right")
    return expr


def size_buckets(h: int, w: int, divisibility: int = 32,
                 buckets: Optional[Sequence[Tuple[int, int]]] = None):
    """Pick the smallest bucket that fits (h, w); default rounds to /32.

    A fixed set of buckets bounds the shapes the model sees (the JAX package
    compiles one program per bucket; here the kernels' launch shapes).
    """
    if buckets:
        for bh, bw in buckets:
            if h <= bh and w <= bw:
                return bh, bw
        return buckets[-1]
    d = divisibility
    return ((h + d - 1) // d * d, (w + d - 1) // d * d)


def downsample_mask_condinst(masks: np.ndarray, stride: int) -> np.ndarray:
    """GT mask downsampling: pick pixels at stride//2 offset (get_target_masks)."""
    if stride == 1:
        return masks
    s = stride // 2
    return masks[:, s::stride, s::stride]
