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
from hipie_torch.models import postprocess as T
from hipie_torch.ops.nms import nms_keep_mask


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
