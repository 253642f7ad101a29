"""Post-processing of the port against the JAX package on inputs built to
exercise it: overlapping boxes of several classes for NMS, confident queries
for panoptic fusion (so segments open, merge and get dropped), padded canvas.
Integer and boolean outputs must be equal; float outputs agree to f32
round-off (1e-6).
"""

import torch_threads  # noqa: F401  (first: sizes torch's CPU threads)
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from hipie_tpu.models import postprocess as J
from hipie_tpu.ops.nms import nms_keep_mask as j_nms
from chip_smoke import NMS_CASES, nms_case
from hipie_torch.models import postprocess as T
from hipie_torch.ops.nms import TILE, nms_keep_mask


def _boxes(rng, n):
    centres = rng.uniform(0.2, 0.8, (4, 2))[rng.randint(0, 4, n)]
    cxcy = centres + rng.normal(0, 0.03, (n, 2))
    wh = rng.uniform(0.1, 0.3, (n, 2))
    return np.concatenate([cxcy, wh], 1).astype(np.float32)


def _xyxy(b):
    return np.concatenate([b[:, :2] - b[:, 2:] / 2, b[:, :2] + b[:, 2:] / 2], 1)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("with_classes", [False, True])
def test_nms_keep_mask_matches_jax(seed, with_classes):
    rng = np.random.RandomState(seed)
    boxes = _xyxy(_boxes(rng, 60))
    scores = rng.uniform(0, 1, 60).astype(np.float32)
    scores[5] = scores[9]                               # a tie, kept in index order
    cls = rng.randint(0, 3, 60).astype(np.int32) if with_classes else None
    want = np.asarray(j_nms(jnp.asarray(boxes), jnp.asarray(scores),
                            None if cls is None else jnp.asarray(cls), 0.5))
    got = nms_keep_mask(torch.from_numpy(boxes), torch.from_numpy(scores),
                        None if cls is None else torch.from_numpy(cls), 0.5).numpy()
    assert 0 < want.sum() < 60
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("with_classes", [False, True])
@pytest.mark.parametrize("n", [0, 1])
def test_nms_keep_mask_plain_edges(n, with_classes):
    """The plain version at N = 0 (an empty mask) and N = 1 (the box kept)."""
    boxes = torch.tensor([[0.1, 0.2, 0.5, 0.6]])[:n]
    cls = torch.zeros(n, dtype=torch.long) if with_classes else None
    keep = nms_keep_mask(boxes, torch.full((n,), 0.3), cls, 0.7)
    assert keep.dtype == torch.bool and keep.tolist() == [True] * n


def test_nms_keep_mask_refuses_other_devices():
    with pytest.raises(ValueError):
        nms_keep_mask(torch.zeros(3, 4, device="meta"), torch.zeros(3, device="meta"), None, 0.7)


def _replay_kf(boxes, scores, cls, thr):
    """K-F's design (hipie_torch/csrc/nms.cu) in numpy: the mask kernel's words
    (word w of row i at [w, i], bit j where column 64 w + j > i agrees in class
    and its IoU, computed as the kernel computes it in f32 with NaN-propagating
    max, min and clamps, exceeds f32(thr)), then the scan kernel's blocks of 64
    rows (the chain over the diagonal words, the kept rows as the clear bits,
    their later words ORed into ``removed``)."""
    n = len(boxes)
    order = torch.sort(-torch.from_numpy(scores), stable=True).indices.numpy()
    b = boxes[order]
    c = np.zeros(n, np.int64) if cls is None else cls[order]
    f32 = np.float32
    nan_max = lambda x, y: np.where((x > y) | np.isnan(x), x, y)
    nan_min = lambda x, y: np.where((x < y) | np.isnan(x), x, y)
    clamp = lambda x, lo: np.where(x < lo, f32(lo), x)
    area = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    w = clamp(nan_min(b[:, None, 2], b[None, :, 2]) - nan_max(b[:, None, 0], b[None, :, 0]), 0)
    h = clamp(nan_min(b[:, None, 3], b[None, :, 3]) - nan_max(b[:, None, 1], b[None, :, 1]), 0)
    inter = w * h
    iou = inter / clamp((area[:, None] + area[None, :]) - inter, f32(1e-6))
    assert iou.dtype == np.float32
    over = (iou > f32(thr)) & (c[:, None] == c[None, :]) & np.triu(np.ones((n, n), bool), 1)
    nb = -(-n // TILE)
    words = np.zeros((nb, n), dtype=object)
    for wd in range(nb):
        for j in range(min(TILE, n - wd * TILE)):
            words[wd] += over[:, wd * TILE + j].astype(object) << j
    removed, keep = [0] * nb, np.zeros(n, bool)
    for blk in range(nb):
        r0, rows = blk * TILE, min(TILE, n - blk * TILE)
        rem = removed[blk]
        for t in range(rows):
            if not (rem >> t) & 1:
                rem |= words[blk, r0 + t]
        kept = ~rem & ((1 << rows) - 1)
        for t in range(rows):
            keep[order[r0 + t]] = (kept >> t) & 1
            if (kept >> t) & 1:
                for wd in range(blk + 1, nb):
                    removed[wd] |= words[wd, r0 + t]
    return keep


@pytest.mark.parametrize("with_classes", [False, True])
@pytest.mark.parametrize("case,n", [("serve", 1), ("serve", 64), ("serve", 65), ("serve", 900)]
                         + [(c, 300) for c in NMS_CASES])
def test_nms_kernel_design_replayed(case, n, with_classes):
    """K-F's arithmetic and its blocked scan, replayed on the CPU, give the
    plain version's keep mask bit for bit (the card tests hold the kernel
    itself to it)."""
    boxes, scores, cls = nms_case(case, n, 11, with_classes)
    want = nms_keep_mask(torch.from_numpy(boxes), torch.from_numpy(scores),
                         None if cls is None else torch.from_numpy(cls), 0.7).numpy()
    np.testing.assert_array_equal(_replay_kf(boxes, scores, cls, 0.7), want)


def _maps(rng, c=6, L=12):
    mw = np.zeros((c, L), np.float32)
    tm = np.zeros((c, L), bool)
    for k in range(c - 1):                               # the last class has no tokens
        toks = rng.choice(L, 2, replace=False)
        tm[k, toks] = True
        mw[k, toks] = 0.5
    is_thing = np.array([True, False, True, False, False, True])
    return (J.ClassMaps(*map(jnp.asarray, (mw, tm, is_thing))),
            T.ClassMaps(*map(torch.from_numpy, (mw, tm, is_thing))))


@pytest.mark.parametrize("max_pool", [False, True])
@pytest.mark.parametrize("mode", [None, "FG", "BG"])
def test_grounding_to_od_logits_matches_jax(max_pool, mode):
    rng = np.random.RandomState(2)
    jmaps, tmaps = _maps(rng)
    logits = rng.randn(9, 12).astype(np.float32)
    want = np.asarray(J.grounding_to_od_logits(jnp.asarray(logits), jmaps, mode, max_pool))
    got = T.grounding_to_od_logits(torch.from_numpy(logits), tmaps, mode, max_pool).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_fg_instance_inference_matches_jax():
    rng = np.random.RandomState(3)
    jmaps, tmaps = _maps(rng)
    q = 40
    args = (rng.randn(q, 12).astype(np.float32) * 3, _boxes(rng, q),
            rng.randn(q, 8, 8).astype(np.float32), rng.randn(q, 1).astype(np.float32))
    want = J.fg_instance_inference(*map(jnp.asarray, args), jmaps, max_detections=15,
                                   nms_thresh=0.5)
    got = T.fg_instance_inference(*map(torch.from_numpy, args), tmaps, max_detections=15,
                                  nms_thresh=0.5)
    for name in ("scores", "boxes", "mask_logits"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    for name in ("classes", "keep_fg"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)


def test_semantic_and_panoptic_match_jax():
    rng = np.random.RandomState(4)
    n, c, h, w = 16, 6, 24, 20
    logits = rng.randn(n, c).astype(np.float32) * 4
    logits[np.arange(n), rng.randint(0, c, n)] += 8      # confident queries
    # disc masks on a jittered 4x4 grid, so most queries win their own region
    # and pass the overlap test; a few larger ones overlap their neighbours
    yy, xx = np.mgrid[:h, :w]
    grid = np.stack(np.meshgrid(np.arange(4), np.arange(4), indexing="ij"), -1).reshape(-1, 2)
    centres = (grid + 0.5 + rng.uniform(-0.2, 0.2, (n, 2))) * (h / 4, w / 4)
    radius = np.where(rng.uniform(0, 1, n) < 0.25, 6.0, 2.5)
    d2 = (yy[None] - centres[:, 0, None, None]) ** 2 + (xx[None] - centres[:, 1, None, None]) ** 2
    masks = (radius[:, None, None] - np.sqrt(d2)).astype(np.float32)
    pad = np.zeros((h, w), bool)
    pad[18:] = True
    jprob = J.transform_probs(jnp.asarray(logits))
    tprob = T.transform_probs(torch.from_numpy(logits))
    np.testing.assert_allclose(tprob.numpy(), np.asarray(jprob), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(T.semantic_inference(tprob, torch.from_numpy(masks)).numpy(),
                               np.asarray(J.semantic_inference(jprob, jnp.asarray(masks))),
                               rtol=1e-5, atol=1e-5)
    is_thing = np.array([True, False, True, False, False, True])
    want = J.panoptic_inference(jprob, jnp.asarray(masks), jnp.asarray(is_thing),
                                pad_mask=jnp.asarray(pad))
    got = T.panoptic_inference(tprob, torch.from_numpy(masks), torch.from_numpy(is_thing),
                               pad_mask=torch.from_numpy(pad))
    assert int(np.asarray(want.segment_valid).sum()) >= 3
    for name in want._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)
