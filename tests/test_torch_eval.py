"""The port's evaluation (hipie_torch/evaluation/, hipie_torch/native/) against
the JAX package's.

The evaluators are the same numpy algorithms over the same inputs, so every
metric must be exactly equal: RLE, COCO box and mask AP, PQ, mIoU and RefCOCO
oIoU on random detections and ground truth (a few seeds, as
tests/test_coco_eval_fuzz.py and tests/test_panoptic_fuzz.py fuzz JAX's), with
the mask IoUs from the port's native library (evalcore, built with g++ into
hipie_torch/_build/native/) and from its numpy fallback.

The dataset drivers run on a fixture the port's make_tiny_coco writes (6 train
and 4 val 128x128 PNG images): ``evaluate_detection_dataset`` and
``evaluate_refcoco_dataset`` on the port's CPU predictor give JAX's functions'
results on the same predictor exactly; and each package's predictor at
``tiny_test_config`` with the same weights (JAX's parameter tree, filled from
a numpy seed, exported and loaded with strict=True) through its own evaluator
gives metrics within 1e-6.
"""

import torch_threads  # noqa: F401  (first: sizes torch's CPU threads)
import numpy as np
import pytest

import hipie_tpu.evaluation.coco_eval as jcoco
import hipie_tpu.evaluation.rle as jrle
import hipie_tpu.evaluation.seg_eval as jseg
import hipie_torch.evaluation.coco_eval as tcoco
import hipie_torch.evaluation.rle as trle
import hipie_torch.evaluation.seg_eval as tseg
from hipie_torch import native
from test_torch_train_common import _fill

SEEDS = [0, 1, 2]


@pytest.fixture(params=["evalcore", "numpy"])
def mask_iou_path(request, monkeypatch):
    """The port's mask IoU from its native library, or from numpy."""
    if request.param == "evalcore":
        assert native.available(), native.status()
    else:
        monkeypatch.setattr(native, "available", lambda: False)
    return request.param


def _equal_results(got, want):
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], float) and np.isnan(want[k]):
            assert np.isnan(got[k]), k
        else:
            assert got[k] == want[k], (k, got[k], want[k])


@pytest.mark.parametrize("seed", SEEDS)
def test_rle_equals_jax(seed):
    rng = np.random.RandomState(seed)
    for shape in [(1, 1), (7, 13), (64, 48), (33, 1)]:
        m = (rng.rand(*shape) > rng.uniform(0.1, 0.9)).astype(np.uint8)
        r = trle.rle_encode(m)
        assert r == jrle.rle_encode(m)
        np.testing.assert_array_equal(trle.rle_decode(r), m)
        np.testing.assert_array_equal(trle.rle_decode(r), jrle.rle_decode(r))
        assert trle.rle_area(r) == jrle.rle_area(r) == int(m.sum())


def _masks_problem(rng, n_images, hw=(48, 64)):
    """Per image: GT and detections with boxes, masks (a rectangle with noise)
    and areas; detections are jittered GT plus noise, scores quantized (ties)."""
    h, w = hw
    images = []

    def rect_mask(b):
        m = np.zeros(hw, np.uint8)
        x0, y0, x1, y1 = np.clip(np.round(b).astype(int), 0, [w, h, w, h])
        m[y0:y1, x0:x1] = 1
        flip = rng.rand(*hw) < 0.05
        return np.where(flip, 1 - m, m).astype(np.uint8)

    for _ in range(n_images):
        gts, dets = [], []
        for _ in range(rng.randint(0, 5)):
            x0, y0 = rng.uniform(0, [w - 8, h - 8])
            bw, bh = rng.uniform(4, [w - x0, h - y0])
            b = np.array([x0, y0, x0 + bw, y0 + bh])
            m = rect_mask(b)
            gts.append({"bbox": b, "mask": m, "area": float(m.sum()) or float(bw * bh),
                        "category_id": int(rng.randint(1, 4)), "iscrowd": int(rng.rand() < 0.1)})
        for g in gts + [None] * rng.randint(0, 3):
            b = (g["bbox"] + rng.uniform(-4, 4, 4)) if g is not None else np.sort(
                rng.uniform(0, [w, h, w, h]).reshape(2, 2), 0).T.reshape(-1)[[0, 2, 1, 3]]
            b = np.array([min(b[0], b[2] - 1), min(b[1], b[3] - 1),
                          max(b[2], b[0] + 1), max(b[3], b[1] + 1)])
            m = rect_mask(b)
            dets.append({"bbox": b, "mask": m, "area": float(m.sum()),
                         "category_id": g["category_id"] if g is not None and rng.rand() < 0.85
                         else int(rng.randint(1, 4)), "score": round(float(rng.rand()), 1)})
        images.append((gts, dets))
    return images


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("iou_type", ["bbox", "segm"])
def test_coco_ap_equals_jax(seed, iou_type, mask_iou_path):
    rng = np.random.RandomState(seed)
    tev, jev = tcoco.COCOApEvaluator(iou_type), jcoco.COCOApEvaluator(iou_type)
    for i, (gts, dets) in enumerate(_masks_problem(rng, 6)):
        tev.add_image(i, gts, dets)
        jev.add_image(i, gts, dets)
    _equal_results(tev.evaluate(), jev.evaluate())


def test_mask_iou_native_equals_numpy_and_jax():
    rng = np.random.RandomState(7)
    dets = [(rng.rand(20, 30) > 0.5).astype(np.uint8) for _ in range(5)]
    gts = [(rng.rand(20, 30) > 0.4).astype(np.uint8) for _ in range(4)]
    crowd = [0, 1, 0, 1]
    assert native.available(), native.status()
    got = trle.mask_iou_matrix(dets, gts, crowd)
    np.testing.assert_array_equal(got, jrle.mask_iou_matrix(dets, gts, crowd))
    d = np.stack([m.reshape(-1) for m in dets])
    g = np.stack([m.reshape(-1) for m in gts])
    inter = d.astype(np.float64) @ g.T
    union = d.sum(1)[:, None] + g.sum(1)[None] - inter
    want = np.where(np.array(crowd, bool)[None], inter / d.sum(1)[:, None], inter / union)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-15)


def _panoptic_problem(rng, n_images, hw=(32, 40), n_classes=5):
    images = []
    for _ in range(n_images):
        gt = np.zeros(hw, np.int32)
        pred = np.zeros(hw, np.int32)
        gsegs, psegs = [], []
        for sid in range(1, rng.randint(2, 7)):
            y0, x0 = rng.randint(0, hw[0] - 4), rng.randint(0, hw[1] - 4)
            y1, x1 = y0 + rng.randint(3, hw[0] - y0 + 1), x0 + rng.randint(3, hw[1] - x0 + 1)
            gt[y0:y1, x0:x1] = sid
            cat = int(rng.randint(n_classes))
            gsegs.append({"id": sid, "category_id": cat, "iscrowd": int(rng.rand() < 0.1)})
            dy, dx = rng.randint(-2, 3, 2)
            pred[max(y0 + dy, 0):max(y1 + dy, 0), max(x0 + dx, 0):max(x1 + dx, 0)] = sid + 10
            psegs.append({"id": sid + 10, "category_id": cat if rng.rand() < 0.8
                          else int(rng.randint(n_classes))})
        gsegs = [s for s in gsegs if (gt == s["id"]).any()]
        psegs = [s for s in psegs if (pred == s["id"]).any()]
        images.append((pred, psegs, gt, gsegs))
    return images


@pytest.mark.parametrize("seed", SEEDS)
def test_panoptic_quality_equals_jax(seed):
    rng = np.random.RandomState(seed)
    is_thing = [True, True, True, False, False]
    tev, jev = tseg.PanopticEvaluator(5, is_thing), jseg.PanopticEvaluator(5, is_thing)
    for args in _panoptic_problem(rng, 5):
        tev.add_image(*args)
        jev.add_image(*args)
    got, want = tev.evaluate(), jev.evaluate()
    _equal_results(got, want)
    assert got["PQ"] > 0


@pytest.mark.parametrize("seed", SEEDS)
def test_semseg_and_refcoco_equal_jax(seed):
    rng = np.random.RandomState(seed)
    tsem, jsem = tseg.SemSegEvaluator(6), jseg.SemSegEvaluator(6)
    tref, jref = tseg.RefCOCOEvaluator(), jseg.RefCOCOEvaluator()
    for _ in range(4):
        gt = rng.randint(0, 6, (24, 20))
        gt[rng.rand(24, 20) < 0.1] = 255
        pred = np.where(rng.rand(24, 20) < 0.7, np.minimum(gt, 5), rng.randint(0, 6, (24, 20)))
        tsem.add_image(pred, gt)
        jsem.add_image(pred, gt)
        pm, gm = rng.rand(24, 20) > 0.5, rng.rand(24, 20) > 0.4
        tref.add_image(pm, gm)
        jref.add_image(pm, gm)
    _equal_results(tsem.evaluate(), jsem.evaluate())
    _equal_results(tref.evaluate(), jref.evaluate())


# -- the dataset drivers on the fixture, through the CPU predictors ---------------

BUCKET = (128, 128)
OVERRIDES = {"data.min_size_test": 96, "data.max_size_test": 128, "data.max_text_len": 16,
             "model.text.max_query_len": 16}
WORDS = ["circle", "square", "triangle", "sky", "grass", "the", "at", "top", "bottom", "left",
         "right", "middle", "on", "side", "near", "big", "small"]


@pytest.fixture(scope="module")
def predictors(tmp_path_factory):
    """The fixture on disk (both registries rooted there) and both packages'
    predictors with the same weights."""
    import jax
    import jax.numpy as jnp

    import hipie_tpu.config as jconfig
    import hipie_tpu.data.datasets as jds
    import hipie_torch.config as tconfig
    import hipie_torch.data.datasets as tds
    from hipie_tpu.models.hipie import HIPIEModel as JModel
    from hipie_tpu.predictor import HIPIEPredictor as JPredictor
    from hipie_torch.models.hipie import HIPIEModel
    from hipie_torch.models.text.tokenizer import WordPieceTokenizer
    from hipie_torch.predictor import HIPIEPredictor
    from hipie_torch.tools import make_tiny_coco
    from hipie_torch.utils.weights import load_from_jax

    root = str(tmp_path_factory.mktemp("tiny_coco_eval"))
    make_tiny_coco.main(["--root", root, "--n-train", "6", "--n-val", "4", "--size", "128",
                         "--refcoco"])
    with pytest.MonkeyPatch.context() as mp:
        for var in ("HIPIE_MSDA_METHOD", "HIPIE_GELU", "HIPIE_VIT_FLASH", "HIPIE_VIT_ATTN"):
            mp.delenv(var, raising=False)
        mp.setenv("HIPIE_DATASETS", root)
        jds._register_builtin()
        tds._register_builtin()
        cfg = tconfig.apply_overrides(tconfig.tiny_test_config(), OVERRIDES)
        jcfg = jconfig.apply_overrides(jconfig.tiny_test_config(), OVERRIDES)
        tok = WordPieceTokenizer.toy(words=WORDS)
        L = cfg.data.max_text_len
        # the inference parameters' shapes by jax.eval_shape (no compile),
        # their values from a numpy seed as the training parity tests fill them
        shapes = jax.eval_shape(
            JModel(jcfg.model).init, jax.random.PRNGKey(0), jnp.zeros((1,) + BUCKET + (3,)),
            jnp.zeros((1,) + BUCKET, bool), jnp.zeros((1, L), jnp.int32),
            jnp.ones((1, L), jnp.int32), jnp.asarray([BUCKET]))
        r = np.random.RandomState(0)
        params = jax.tree_util.tree_map_with_path(
            lambda kp, sh: _fill("/".join(str(getattr(k, "key", k)) for k in kp), sh.shape, r),
            shapes)
        model = HIPIEModel(cfg.model).eval()
        load_from_jax(model, params["params"], cfg)
        yield (HIPIEPredictor(cfg, model, tok, bucket=BUCKET, device="cpu"),
               JPredictor(jcfg, params, tok, bucket=BUCKET))
    jds._register_builtin()
    tds._register_builtin()


def test_dataset_drivers_equal_jax_on_one_predictor(predictors):
    """The port's predictor through both packages' drivers: the same results."""
    import hipie_tpu.data.datasets as jds
    import hipie_tpu.evaluation.evaluator as jev
    import hipie_torch.data.datasets as tds
    import hipie_torch.evaluation.evaluator as tev

    pred, _ = predictors
    recs = tds.get_dataset("coco_panoptic_val")
    meta = recs[0]
    args = (len(meta["class_names"]), meta["class_is_thing"])
    tasks = ("bbox", "segm", "panoptic", "sem_seg")
    got = tev.evaluate_detection_dataset(pred, recs, *args, tasks=tasks, max_images=2)
    want = jev.evaluate_detection_dataset(pred, jds.get_dataset("coco_panoptic_val"), *args,
                                          tasks=tasks, max_images=2)
    assert got.pop("sec_per_image") >= 0 and want.pop("sec_per_image") >= 0
    _equal_results(got, want)
    assert got["images"] == 2 and "panoptic/PQ" in got and "sem_seg/mIoU" in got
    got = tev.evaluate_refcoco_dataset(pred, tds.get_dataset("refcoco-unc-val"), 2)
    want = jev.evaluate_refcoco_dataset(pred, jds.get_dataset("refcoco-unc-val"), 2)
    _equal_results(got, want)


def test_each_package_with_the_same_weights(predictors):
    """Each package's predictor (the same weights) through its own driver:
    box and mask AP, PQ and the semantic metrics within 1e-6."""
    import hipie_tpu.data.datasets as jds
    import hipie_tpu.evaluation.evaluator as jev
    import hipie_torch.data.datasets as tds
    import hipie_torch.evaluation.evaluator as tev

    pred, jpred = predictors
    recs = tds.get_dataset("coco_panoptic_val")
    meta = recs[0]
    args = (len(meta["class_names"]), meta["class_is_thing"])
    tasks = ("bbox", "segm", "panoptic", "sem_seg")
    got = tev.evaluate_detection_dataset(pred, recs, *args, tasks=tasks, max_images=2)
    want = jev.evaluate_detection_dataset(jpred, jds.get_dataset("coco_panoptic_val"), *args,
                                          tasks=tasks, max_images=2)
    got.pop("sec_per_image"), want.pop("sec_per_image")
    # at random weights AP and PQ are 0; the semantic maps' metrics are not
    assert got.keys() == want.keys() and got["images"] == 2 and got["sem_seg/mIoU"] > 0
    for k in want:
        assert np.isnan(got[k]) == np.isnan(want[k]), k
        if not np.isnan(want[k]):
            assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])
