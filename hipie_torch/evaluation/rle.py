"""COCO-compatible RLE mask codec (pure numpy; pycocotools is unavailable).

The port's copy of hipie_tpu/evaluation/rle.py.

Implements the pycocotools mask API subset the evaluators need: encode/decode
(compressed LEB128-style string RLE), area, and pairwise IoU, matching the
format of pycocotools.mask so dumped results interoperate with standard COCO
json tooling. reference: detectron2 evaluators use pycocotools.mask throughout.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Union

import numpy as np


def _counts_from_mask(mask: np.ndarray) -> List[int]:
    """Column-major run lengths, starting with a (possibly 0) run of zeros."""
    flat = np.asarray(mask, np.uint8).flatten(order="F")
    n = flat.size
    if n == 0:
        return [0]
    change = np.nonzero(np.diff(flat))[0] + 1
    runs = np.diff(np.concatenate([[0], change, [n]])).tolist()
    if flat[0] == 1:
        runs = [0] + runs
    return runs


def _leb128_encode(counts: Sequence[int]) -> str:
    """pycocotools' modified LEB128 with delta coding from the 3rd element."""
    out = []
    for i, cnt in enumerate(counts):
        x = int(cnt)
        if i > 2:
            x -= int(counts[i - 2])
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = not ((x == 0 and not (c & 0x10)) or (x == -1 and (c & 0x10)))
            if more:
                c |= 0x20
            out.append(chr(c + 48))
    return "".join(out)


def _leb128_decode(s: str) -> List[int]:
    counts = []
    i = 0
    while i < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def rle_encode(mask: np.ndarray) -> Dict:
    h, w = mask.shape
    return {"size": [int(h), int(w)],
            "counts": _leb128_encode(_counts_from_mask(mask))}


def rle_decode(rle: Dict) -> np.ndarray:
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, str):
        counts = _leb128_decode(counts)
    elif isinstance(counts, bytes):
        counts = _leb128_decode(counts.decode("ascii"))
    flat = np.zeros(h * w, np.uint8)
    pos = 0
    val = 0
    for c in counts:
        if val:
            flat[pos:pos + c] = 1
        pos += c
        val ^= 1
    return flat.reshape((w, h)).T


def rle_area(rle: Dict) -> int:
    counts = rle["counts"]
    if isinstance(counts, str):
        counts = _leb128_decode(counts)
    return int(sum(counts[1::2]))


def mask_iou_matrix(dets: List[np.ndarray], gts: List[np.ndarray],
                    iscrowd: Sequence[bool] = ()) -> np.ndarray:
    """(n_det, n_gt) mask IoU; crowd gts use intersection/det_area.

    Uses the native C++ kernel (hipie_torch/native) when it is built."""
    from hipie_torch.native import available, mask_iou_native

    nd, ng = len(dets), len(gts)
    out = np.zeros((nd, ng), np.float64)
    if nd == 0 or ng == 0:
        return out
    if available():
        crowd = np.zeros(ng, np.uint8)
        for j in range(min(ng, len(iscrowd))):
            crowd[j] = bool(iscrowd[j])
        d = np.stack([np.asarray(m, np.uint8).reshape(-1) for m in dets])
        g = np.stack([np.asarray(m, np.uint8).reshape(-1) for m in gts])
        return mask_iou_native(d, g, crowd)
    d = np.stack([m.astype(bool).reshape(-1) for m in dets])
    g = np.stack([m.astype(bool).reshape(-1) for m in gts])
    inter = d.astype(np.float64) @ g.T.astype(np.float64)
    da = d.sum(1)[:, None].astype(np.float64)
    ga = g.sum(1)[None, :].astype(np.float64)
    union = da + ga - inter
    for j in range(ng):
        if iscrowd and j < len(iscrowd) and iscrowd[j]:
            out[:, j] = inter[:, j] / np.maximum(da[:, 0], 1e-9)
        else:
            out[:, j] = inter[:, j] / np.maximum(union[:, j], 1e-9)
    return out


def box_iou_matrix(dets: np.ndarray, gts: np.ndarray,
                   iscrowd: Sequence[bool] = ()) -> np.ndarray:
    """xyxy box IoU matrix with crowd handling (pycocotools bbIou)."""
    nd, ng = len(dets), len(gts)
    out = np.zeros((nd, ng), np.float64)
    if nd == 0 or ng == 0:
        return out
    da = (dets[:, 2] - dets[:, 0]) * (dets[:, 3] - dets[:, 1])
    ga = (gts[:, 2] - gts[:, 0]) * (gts[:, 3] - gts[:, 1])
    for j in range(ng):
        x1 = np.maximum(dets[:, 0], gts[j, 0])
        y1 = np.maximum(dets[:, 1], gts[j, 1])
        x2 = np.minimum(dets[:, 2], gts[j, 2])
        y2 = np.minimum(dets[:, 3], gts[j, 3])
        inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
        if iscrowd and j < len(iscrowd) and iscrowd[j]:
            denom = np.maximum(da, 1e-9)
        else:
            denom = np.maximum(da + ga[j] - inter, 1e-9)
        out[:, j] = inter / denom
    return out
