"""The port's predictor (hipie_torch/predictor.py) against the JAX package's.

tiny_test_config builds a ResNet-50 in both packages (every backbone name that
starts with "resnet" does). The JAX parameters of an inference ``init`` load
into the port with strict=True. The canvas is a non-square 64x96 bucket, and a
50x80 image resizes to 48x77, so the pad mask covers rows 48.. and columns
77.. of it: strided per-level masks, valid ratios below 1 and masked MSDA
values all take part.

``_run`` (resize, pad, model, ``hipie_inference``) is compared with JAX's on
the same image, labels and weights, for detection and grounding. Both sides
get the port's resize (cv2 is held against it below), so the comparison sees
the model and the post-processing alone. f32 throughout; tolerances are f32
round-off through the encoder and decoder stacks: 1e-4 on scores, boxes and
semantic maps of scale ~1, and 1e-3 of the largest magnitude on CondInst mask
logits (scale ~40), which amplify controller round-off through un-normalised
coordinates. At these random weights the round-off is large: run in float64,
the port's f32 mask logits and JAX's sit 6e-3 and 8e-3 from the float64
result, and 1.4e-2 from each other.
"""

import torch_threads  # noqa: F401  (first: sizes torch's CPU threads)
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import hipie_tpu.config as jconfig
import hipie_tpu.data.prompts as jprompts
import hipie_torch.config as tconfig
import hipie_torch.data.prompts as tprompts
from hipie_torch.models.text.tokenizer import WordPieceTokenizer

BUCKET = (64, 96)
CATS = ["person", "dog", "sky:stuff", "grass:stuff"]
WORDS = ["person", "dog", "sky", "grass", "head", "tail"]
OVERRIDES = {"data.min_size_test": 48, "data.max_size_test": 96,
             "data.max_text_len": 16, "model.text.max_query_len": 16}


def predictor_config(pkg=tconfig):
    """The port's config (or, with ``pkg=jconfig``, the JAX package's), same overrides."""
    return pkg.apply_overrides(pkg.tiny_test_config(), OVERRIDES)


def image(seed, h=50, w=80):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3)).astype(np.uint8)


@pytest.fixture(scope="module")
def both():
    import hipie_tpu.data.transforms as jT
    from hipie_tpu.models.hipie import HIPIEModel as JModel
    from hipie_tpu.predictor import HIPIEPredictor as JPredictor
    from hipie_tpu.utils.export import export_hipie_checkpoint
    from hipie_torch.data.transforms import resize_shortest_edge
    from hipie_torch.models.hipie import HIPIEModel
    from hipie_torch.predictor import HIPIEPredictor
    from hipie_torch.utils.weights import load_from_jax

    with pytest.MonkeyPatch.context() as mp:
        for var in ("HIPIE_MSDA_METHOD", "HIPIE_GELU", "HIPIE_VIT_FLASH", "HIPIE_VIT_ATTN"):
            mp.delenv(var, raising=False)
        cfg, jcfg = predictor_config(), predictor_config(jconfig)
        tok = WordPieceTokenizer.toy(words=WORDS)
        L = cfg.data.max_text_len
        jm = JModel(jcfg.model)
        params = jax.jit(jm.init)(
            jax.random.PRNGKey(0), jnp.zeros((1,) + BUCKET + (3,)), jnp.zeros((1,) + BUCKET, bool),
            jnp.zeros((1, L), jnp.int32), jnp.ones((1, L), jnp.int32), jnp.asarray([BUCKET]))
        jpred = JPredictor(jcfg, params, tok, bucket=BUCKET)

        model = HIPIEModel(cfg.model).eval()
        params_np = jax.device_get(params)["params"]
        keys = (set(export_hipie_checkpoint(params_np, jcfg)), set(model.state_dict()))
        load_from_jax(model, params_np, cfg)
        pred = HIPIEPredictor(cfg, model, tok, bucket=BUCKET, device="cpu")

        # JAX's _run on the port's resize: the comparison sees the model alone
        mp.setattr(jT, "resize_shortest_edge", resize_shortest_edge)
        runs = {}
        for task, spec_args in (("detection", dict(test_categories=CATS)),
                                ("grounding", dict(expressions="the dog on the grass"))):
            spec, has_thing = _spec(pred, task, **spec_args)
            jspec, _ = _spec(pred, task, prompts=jprompts, **spec_args)
            img = image(7)
            jres, jhw = jpred._run(jspec, img, task, has_thing)
            tres, thw = pred._run(spec, img, task, has_thing)
            runs[task] = (jres, jhw, tres, thw)
    return cfg, tok, model, pred, keys, runs, params, jcfg


def _spec(pred, task, test_categories=None, expressions=None, prompts=tprompts):
    """The port's prompt spec, or with ``prompts=jprompts`` the JAX package's."""
    from hipie_torch.predictor import parse_def_string

    L = pred.cfg.data.max_text_len
    if task == "grounding":
        return prompts.grounding_prompt_spec(expressions, pred.tok, L), True
    names, is_thing = parse_def_string(test_categories)
    return prompts.build_prompt_spec(names, is_thing, pred.tok, L), any(is_thing)


def test_strict_load_has_the_same_keys(both):
    """ResNet-50 with FrozenBN buffers and all heads: no missing or unexpected key."""
    exported, ported = both[4]
    assert exported == ported, (sorted(exported - ported)[:10], sorted(ported - exported)[:10])
    assert "detr.detr.backbone.0.backbone.res5.2.conv3.norm.running_var" in ported
    assert "detr.detr.backbone.0.backbone.stem.conv1.norm.weight" in ported


def _close(got, want, tol, name, of_scale=False):
    """|got - want| <= tol * (1 + |want|), or <= tol * max|want| with of_scale."""
    want = np.asarray(want, np.float32)
    atol = tol * np.abs(want).max() if of_scale else tol
    np.testing.assert_allclose(np.asarray(got.float()), want, rtol=0 if of_scale else tol,
                               atol=atol, err_msg=name)


@pytest.mark.parametrize("task", ["detection", "grounding"])
def test_run_matches_jax(both, task):
    """Padded, non-square canvas. Results are sorted by score, so equal scores
    give the same slots; classes, boxes and masks are compared in that order."""
    jres, jhw, tres, thw = both[5][task]
    assert thw == tuple(jhw) == (48, 77)
    k = 1 if task == "grounding" else both[0].test.detections_per_image
    assert tres.scores.shape == (k,)
    _close(tres.scores, jres.scores, 1e-4, "scores")
    np.testing.assert_array_equal(tres.classes.numpy(), np.asarray(jres.classes), "classes")
    _close(tres.boxes, jres.boxes, 1e-4, "boxes")
    _close(tres.mask_logits, jres.mask_logits, 1e-3, "mask_logits", of_scale=True)
    if task == "grounding":
        for name in ("sem_seg", "panoptic", "segment_valid", "segment_classes"):
            assert getattr(tres, name) is None and getattr(jres, name) is None, name
        return
    _close(tres.sem_seg, jres.sem_seg, 1e-4, "sem_seg")
    for name in ("panoptic", "segment_valid", "segment_classes", "segment_isthing"):
        np.testing.assert_array_equal(getattr(tres, name).numpy(), np.asarray(getattr(jres, name)),
                                      err_msg=name)


def test_grounding_language_content_matches_jax(both, monkeypatch):
    """Grounding with still_tgt_for_both=False: every query slot takes the
    resized pooled expression as its content (JAX transformer.py:366-372).
    The same weights (the branch adds none); tolerances as above."""
    import hipie_tpu.data.transforms as jT
    from hipie_tpu.predictor import HIPIEPredictor as JPredictor
    from hipie_torch.data.transforms import resize_shortest_edge
    from hipie_torch.models.hipie import HIPIEModel
    from hipie_torch.predictor import HIPIEPredictor

    for var in ("HIPIE_MSDA_METHOD", "HIPIE_GELU", "HIPIE_VIT_FLASH", "HIPIE_VIT_ATTN"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(jT, "resize_shortest_edge", resize_shortest_edge)
    cfg, tok, model, _, _, _, params, jcfg = both
    override = {"model.transformer.still_tgt_for_both": False}
    cfg, jcfg = tconfig.apply_overrides(cfg, override), jconfig.apply_overrides(jcfg, override)
    lang = HIPIEModel(cfg.model).eval()
    lang.load_state_dict(model.state_dict(), strict=True)
    pred = HIPIEPredictor(cfg, lang, tok, bucket=BUCKET, device="cpu")
    spec, has_thing = _spec(pred, "grounding", expressions="the dog on the grass")
    jspec, _ = _spec(pred, "grounding", expressions="the dog on the grass", prompts=jprompts)
    img = image(7)                  # the fixture's grounding image
    jres, _ = JPredictor(jcfg, params, tok, bucket=BUCKET)._run(jspec, img, "grounding", has_thing)
    tres, _ = pred._run(spec, img, "grounding", has_thing)
    _, _, ref, _ = both[5]["grounding"]
    assert not np.allclose(tres.boxes.numpy(), ref.boxes.numpy()), "the branch changed nothing"
    _close(tres.scores, jres.scores, 1e-4, "scores")
    _close(tres.boxes, jres.boxes, 1e-4, "boxes")
    _close(tres.mask_logits, jres.mask_logits, 1e-3, "mask_logits", of_scale=True)


def test_flat4_model_matches_fused(both):
    """The same weights with msda_method="flat4" in all 21 MSDeformAttn layers
    (2 encoder, 2 decoder, 2 MaskDINO in this config): both sample in f32 on the
    CPU, so they agree to f32 round-off (1e-4 through the stacks)."""
    from hipie_torch.models.hipie import HIPIEModel
    from hipie_torch.models.msda_module import MSDeformAttn
    from hipie_torch.predictor import HIPIEPredictor

    cfg, tok, model, pred = both[:4]
    flat4 = HIPIEModel(cfg.model, msda_method="flat4").eval()
    flat4.load_state_dict(model.state_dict(), strict=True)
    methods = [m.msda_method for m in flat4.modules() if isinstance(m, MSDeformAttn)]
    n = (cfg.model.transformer.num_encoder_layers + cfg.model.transformer.num_decoder_layers
         + cfg.model.maskdino.dec_layers)
    assert methods == ["flat4"] * n
    spec, has_thing = _spec(pred, "detection", test_categories=CATS)
    img = image(8)
    a, _ = pred._run(spec, img, "detection", has_thing)
    b, _ = HIPIEPredictor(cfg, flat4, tok, bucket=BUCKET, device="cpu")._run(
        spec, img, "detection", has_thing)
    for name in ("scores", "boxes", "sem_seg"):
        _close(getattr(b, name), getattr(a, name).numpy(), 1e-4, name)
    _close(b.mask_logits, a.mask_logits.numpy(), 1e-3, "mask_logits", of_scale=True)
    np.testing.assert_array_equal(b.panoptic.numpy(), a.panoptic.numpy())


def test_detection_call(both):
    pred = both[3]
    res = pred(image(0), test_categories=["person", "dog", "sky:stuff"], score_thresh=-1.0)
    inst = res["instances"]
    assert inst["boxes"].shape == (both[0].test.detections_per_image, 4)
    assert inst["masks"].shape[1:] == (50, 80) and inst["masks"].dtype == bool
    assert len(inst["scores"]) == len(inst["classes"]) == len(inst["masks"])
    assert np.isfinite(inst["boxes"]).all() and np.isfinite(inst["scores"]).all()
    pan, segments = res["panoptic_seg"]
    assert pan.shape == (50, 80)
    for s in segments:
        assert set(s) == {"id", "category_id", "isthing"}
    assert res["sem_seg"].shape == (50, 80)
    assert res["sem_seg"].max() < 3


def test_grounding_call(both):
    res = both[3](image(1, 40, 48), task="grounding", expressions="the dog")
    assert len(res["instances"]["scores"]) == 1
    assert res["instances"]["masks"].shape == (1, 40, 48)
    assert "panoptic_seg" not in res and "sem_seg" not in res


def test_call_rescales_run(both):
    """__call__ = _run + boxes scaled to the original pixels + masks resized
    bilinearly (x4, crop, resize) and thresholded, + nearest-resized maps."""
    import cv2

    cfg, tok, _, pred = both[:4]
    img = image(9)
    spec, has_thing = _spec(pred, "detection", test_categories=CATS)
    res, (h, w) = pred._run(spec, img, "detection", has_thing)
    out = pred(img, test_categories=CATS, score_thresh=-1.0)
    boxes = res.boxes.double().numpy() * np.array([w, h, w, h]) * np.array([80 / w, 50 / h] * 2)
    np.testing.assert_allclose(out["instances"]["boxes"], boxes, rtol=1e-12)
    logits = res.mask_logits.numpy()
    up = np.stack([cv2.resize(m, (m.shape[1] * 4, m.shape[0] * 4), interpolation=cv2.INTER_LINEAR)
                   for m in logits])[:, :h, :w]
    want = np.stack([cv2.resize(m, (80, 50), interpolation=cv2.INTER_LINEAR) for m in up])
    # cv2 and F.interpolate agree to f32 round-off; pixels with |logit| < 1e-3 may flip
    agree = (out["instances"]["masks"] == (want > 0)) | (np.abs(want) < 1e-3)
    assert agree.all()
    pan = cv2.resize(res.panoptic.numpy()[:12, :20], (80, 50), interpolation=cv2.INTER_NEAREST)
    np.testing.assert_array_equal(out["panoptic_seg"][0], pan)


def test_part_segm_demo(both):
    from hipie_torch.predictor import PartSegmDemo

    img = image(2)
    demo = PartSegmDemo(both[3], part_labels=["head", "tail"])
    res = demo.forward_panoptic(img, ["person", "dog"], ["sky"], do_part=True)
    parts = res["parts"]
    assert parts["part_sem_seg"].shape == (50, 80)
    assert len(parts["instance_part_maps"]) == len(res["instances"]["masks"])
    for m, pm in zip(res["instances"]["masks"], parts["instance_part_maps"]):
        np.testing.assert_array_equal(pm, np.where(m, parts["part_sem_seg"] + 1, 0))
    ref = demo.forward_reference(img, "the dog", part="head")
    assert "part_mask" in ref or len(ref["instances"]["masks"]) == 0


def test_async_predictor_matches_sync(both):
    from hipie_torch.predictor import AsyncPredictor

    pred = both[3]
    rng = np.random.RandomState(3)
    images = [rng.randint(0, 255, (48, 64, 3), np.uint8) for _ in range(3)]
    cats = ["person", "sky:stuff"]
    sync = [pred(im, test_categories=cats) for im in images]
    ap = AsyncPredictor(pred, workers=2)
    try:
        out = list(ap.map(images, test_categories=cats))
    finally:
        ap.shutdown()
    assert len(out) == len(sync)
    for a, b in zip(out, sync):
        np.testing.assert_allclose(a["instances"]["scores"], b["instances"]["scores"], rtol=1e-5)
        np.testing.assert_array_equal(a["panoptic_seg"][0], b["panoptic_seg"][0])


def test_parse_def_string():
    from hipie_torch.predictor import parse_def_string

    names, things = parse_def_string(["person", "sky:stuff", "dog", " grass : Stuff "])
    assert names == ["person", "sky", "dog", "grass"]
    assert things == [True, False, True, False]


@pytest.mark.parametrize("override", ["model.bg_query_from_lang"])
def test_predictor_refuses_unported_options(both, override, monkeypatch):
    """The predictor once refused these options; now each runs and matches JAX's
    predictor on the fixture's detection image and weights (the options add
    none). With model.bg_query_from_lang, a detection call puts one bg query
    per stuff label of CATS (2) in front, from its token weights, and reads fg
    after both bg blocks. Tolerances as test_run_matches_jax."""
    import hipie_tpu.data.transforms as jT
    from hipie_tpu.predictor import HIPIEPredictor as JPredictor
    from hipie_torch.data.transforms import resize_shortest_edge
    from hipie_torch.models.hipie import HIPIEModel
    from hipie_torch.predictor import HIPIEPredictor

    for var in ("HIPIE_MSDA_METHOD", "HIPIE_GELU", "HIPIE_VIT_FLASH", "HIPIE_VIT_ATTN"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(jT, "resize_shortest_edge", resize_shortest_edge)
    cfg, tok, model, _, _, _, params, jcfg = both
    cfg, jcfg = (tconfig.apply_overrides(cfg, {override: True}),
                 jconfig.apply_overrides(jcfg, {override: True}))
    ported = HIPIEModel(cfg.model).eval()
    ported.load_state_dict(model.state_dict(), strict=True)
    pred = HIPIEPredictor(cfg, ported, tok, bucket=BUCKET, device="cpu")
    spec, has_thing = _spec(pred, "detection", test_categories=CATS)
    jspec, _ = _spec(pred, "detection", test_categories=CATS, prompts=jprompts)
    img = image(7)                  # the fixture's detection image
    jres, _ = JPredictor(jcfg, params, tok, bucket=BUCKET)._run(jspec, img, "detection", has_thing)
    tres, _ = pred._run(spec, img, "detection", has_thing)
    _, _, ref, _ = both[5]["detection"]
    assert not np.allclose(tres.scores.numpy(), ref.scores.numpy()), "the option changed nothing"
    _close(tres.scores, jres.scores, 1e-4, "scores")
    np.testing.assert_array_equal(tres.classes.numpy(), np.asarray(jres.classes), "classes")
    _close(tres.boxes, jres.boxes, 1e-4, "boxes")
    _close(tres.mask_logits, jres.mask_logits, 1e-3, "mask_logits", of_scale=True)
    _close(tres.sem_seg, jres.sem_seg, 1e-4, "sem_seg")
    for name in ("panoptic", "segment_valid", "segment_classes", "segment_isthing"):
        np.testing.assert_array_equal(getattr(tres, name).numpy(), np.asarray(getattr(jres, name)),
                                      err_msg=name)


@pytest.mark.parametrize("hw", [(480, 640), (50, 80), (1200, 900), (37, 23)])
def test_resize_matches_cv2(hw):
    """Size rule = JAX's resize_shortest_edge; pixels = cv2.INTER_LINEAR on the
    float image. cv2 rounds its interpolation weights (measured: up to 0.02 on
    0..255 values), so the bound is 0.05; the JAX package's own bilinear helper
    agrees with the port to f32 round-off in the interior."""
    import cv2
    from hipie_tpu.data.transforms import resize_shortest_edge as jresize
    from hipie_torch.data.transforms import resize_shortest_edge

    img = np.random.RandomState(hw[0]).randint(0, 256, hw + (3,)).astype(np.uint8)
    got, scale = resize_shortest_edge(img, 800, 1333)
    want, want_scale = jresize(img.astype(np.float32), 800, 1333)
    assert got.shape == want.shape and got.dtype == np.float32 and scale == want_scale
    np.testing.assert_allclose(got, want, rtol=0, atol=0.05)
    small, _ = resize_shortest_edge(img, 48, 96)
    ref = cv2.resize(img.astype(np.float32), small.shape[1::-1], interpolation=cv2.INTER_LINEAR)
    np.testing.assert_allclose(small, ref, rtol=0, atol=0.05)


@pytest.mark.parametrize("src,dst", [((5, 7), (20, 28)), ((12, 20), (50, 80)), ((9, 13), (4, 5))])
def test_bilinear_matches_cv2_and_batched_bilinear(src, dst):
    """The mask rescale's bilinear resize is cv2.INTER_LINEAR to f32 round-off.
    JAX's _batched_bilinear matches it too, except in the first output rows and
    columns when upsampling: there it clamps the lower source index before
    adding 1, which blends rows 0 and 1 where cv2 takes row 0 (ROADMAP C)."""
    import cv2
    from hipie_tpu.predictor import _batched_bilinear
    from hipie_torch.data.transforms import resize_bilinear

    a = np.random.RandomState(src[0]).randn(3, *src).astype(np.float32)
    got = resize_bilinear(torch.from_numpy(a), dst).numpy()
    ref = np.stack([cv2.resize(m, dst[::-1], interpolation=cv2.INTER_LINEAR) for m in a])
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    jb = _batched_bilinear(a, dst)
    edge = int(np.ceil(0.5 * max(dst[0] / src[0], dst[1] / src[1]))) if dst[0] > src[0] else 0
    np.testing.assert_allclose(got[:, edge:, edge:], jb[:, edge:, edge:], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dst", [(50, 80), (480, 640), (37, 41), (7, 5)])
def test_nearest_matches_cv2(dst):
    import cv2
    from hipie_torch.predictor import resize_nearest

    ids = np.random.RandomState(dst[0]).randint(0, 9, (13, 19)).astype(np.int32)
    got = resize_nearest(torch.from_numpy(ids), dst).numpy()
    np.testing.assert_array_equal(got, cv2.resize(ids, dst[::-1], interpolation=cv2.INTER_NEAREST))
