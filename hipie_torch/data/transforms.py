"""Test-time image resize without cv2.

Counterpart of hipie_tpu/data/transforms.py::resize_shortest_edge (reference
detectron2 ResizeShortestEdge at test time). The size rule is the JAX
package's; the resize is ``F.interpolate`` bilinear with half-pixel centres,
edge clamping and no antialiasing, which is cv2.INTER_LINEAR on a float image.
``pad_to_bucket`` is hipie_tpu/data/transforms.py's numpy padding, copied.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


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
