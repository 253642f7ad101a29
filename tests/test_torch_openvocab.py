"""Open-vocabulary serving, the port against the JAX package: long prompts
encoded in chunks (``hipie_torch/models/text/frontend.py``) and MaskCLIP score
fusion through ``HIPIEPredictor``.

tiny_test_config (a ResNet-50, a 2-layer BERT 32 wide with 512 positions)
with ``open_vocab_eval``'s test options (max-pooled token scores,
class-agnostic bg, the all pass over fg + MaskDINO masks) and CLIP on, the
narrow CLIP towers of tests/test_torch_clip.py on the same synthetic open_clip
weights, f32 on the CPU, the 64x96 bucket of tests/test_torch_predictor.py.

JAX's own model gives NaN text features past 512 tokens (ROADMAP C-4), and
its predictor never chunks; so the long-prompt predictor is held against
JAX's detector given the states of JAX's ``encode_long_prompt`` through
``lang_hidden``, and JAX's ``hipie_inference`` with JAX's ``clip_fn``.
Tolerances as in tests/test_torch_predictor.py: 1e-4 on scores, boxes and
semantic maps, 1e-3 of the largest magnitude on CondInst mask logits; 1e-5 in
relative norm on BERT states.
"""

import torch_threads  # noqa: F401  (first: sizes torch's CPU threads)
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import hipie_tpu.config as jconfig
import hipie_torch.config as tconfig
from hipie_torch.models.text.tokenizer import WordPieceTokenizer
from test_torch_clip import jax_scorer, open_clip_state_dict, port_scorer

BUCKET = (64, 96)
WORDS = ["person", "dog", "sky", "grass", "puppy", "lawn", "tree"]
CATS = ["person", "dog,puppy", "sky:stuff", "grass,lawn:stuff", "tree:stuff"]
OVERRIDES = {"data.min_size_test": 48, "data.max_size_test": 96, "data.max_text_len": 16,
             "model.text.max_query_len": 16, "model.clip.enabled": True,
             "model.clip.beta": 0.45, "test.max_pool_tokens": True,
             "test.bg_cls_agnostic": True, "test.use_bg_for_pano": False}
LONG = 640                        # tokens: past BERT's 512 positions, two chunks
JAX_VARS = ("HIPIE_MSDA_METHOD", "HIPIE_GELU", "HIPIE_VIT_FLASH", "HIPIE_VIT_ATTN")


def ov_config(pkg=tconfig, **extra):
    return pkg.apply_overrides(pkg.tiny_test_config(), {**OVERRIDES, **extra})


def image(seed, h=50, w=80):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3)).astype(np.uint8)


def long_categories():
    """Enough class names that the toy tokenizer's prompt passes LONG tokens."""
    return [f"{w}{i}" + (":stuff" if i % 3 == 0 else "") for i in range(100) for w in WORDS[:2]]


@pytest.fixture(scope="module")
def ov():
    from hipie_tpu.models.hipie import HIPIEModel as JModel
    from hipie_tpu.utils.converter import convert_clip
    from hipie_torch.models.hipie import HIPIEModel
    from hipie_torch.utils.weights import load_from_jax
    from test_torch_clip import HEADS, LAYERS
    from test_torch_train_common import _fill

    with pytest.MonkeyPatch.context() as mp:
        for var in JAX_VARS:
            mp.delenv(var, raising=False)
        cfg, jcfg = ov_config(), ov_config(jconfig)
        tok = WordPieceTokenizer.toy(words=WORDS)
        sep = tok.dot_token_id
        jm = JModel(jcfg.model, sep_token_id=sep)
        # the inference parameters' shapes by jax.eval_shape (no compile),
        # their values from a numpy seed as the training parity tests fill them
        shapes = jax.eval_shape(
            jm.init, jax.random.PRNGKey(0), jnp.zeros((1,) + BUCKET + (3,)),
            jnp.zeros((1,) + BUCKET, bool), jnp.zeros((1, 16), jnp.int32),
            jnp.ones((1, 16), jnp.int32), jnp.asarray([BUCKET]))
        r = np.random.RandomState(0)
        params = jax.tree_util.tree_map_with_path(
            lambda kp, sh: _fill("/".join(str(getattr(k, "key", k)) for k in kp), sh.shape, r),
            shapes)
        model = HIPIEModel(cfg.model, sep_token_id=sep).eval()
        load_from_jax(model, params["params"], cfg)
        sd = open_clip_state_dict()
        bert = jax.jit(lambda p, i, m: jm.apply(p, i, m, method=JModel.encode_text))
        yield dict(cfg=cfg, jcfg=jcfg, tok=tok, jm=jm, params=params, model=model, bert=bert,
                   jsc=jax_scorer(convert_clip(sd, LAYERS, HEADS, LAYERS, HEADS)),
                   sc=port_scorer(sd), sep=sep)


def _close(got, want, tol, name, of_scale=False):
    want = np.asarray(want, np.float32)
    atol = tol * np.abs(want).max() if of_scale else tol
    np.testing.assert_allclose(np.asarray(got.float()), want, rtol=0 if of_scale else tol,
                               atol=atol, err_msg=name)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _compare(tres, jres):
    assert torch.isfinite(tres.scores).all() and torch.isfinite(tres.sem_seg).all()
    _close(tres.scores, jres.scores, 1e-4, "scores")
    np.testing.assert_array_equal(tres.classes.numpy(), np.asarray(jres.classes), "classes")
    _close(tres.boxes, jres.boxes, 1e-4, "boxes")
    _close(tres.mask_logits, jres.mask_logits, 1e-3, "mask_logits", of_scale=True)
    _close(tres.sem_seg, jres.sem_seg, 1e-4, "sem_seg")
    for name in ("panoptic", "segment_valid", "segment_classes", "segment_isthing"):
        np.testing.assert_array_equal(getattr(tres, name).numpy(), np.asarray(getattr(jres, name)),
                                      err_msg=name)


def _spec(tok, cats, max_len, prompts=None):
    import hipie_torch.data.prompts as tprompts
    from hipie_torch.predictor import parse_def_string

    names, is_thing = parse_def_string(cats)
    return (prompts or tprompts).build_prompt_spec(names, is_thing, tok, max_len), any(is_thing)


def test_predictor_with_clip_matches_jax(ov, monkeypatch):
    """A short prompt (16 tokens): both predictors' ``_run`` with CLIP on, on the
    same image, labels (synonym groups split on commas) and CLIP weights."""
    import hipie_tpu.data.prompts as jprompts
    import hipie_tpu.data.transforms as jT
    from hipie_tpu.predictor import HIPIEPredictor as JPredictor
    from hipie_torch.data.transforms import resize_shortest_edge
    from hipie_torch.predictor import HIPIEPredictor

    for var in JAX_VARS:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(jT, "resize_shortest_edge", resize_shortest_edge)
    tok = ov["tok"]
    jpred = JPredictor(ov["jcfg"], ov["params"], tok, bucket=BUCKET, clip_scorer=ov["jsc"])
    pred = HIPIEPredictor(ov["cfg"], ov["model"], tok, bucket=BUCKET, device="cpu",
                          clip_scorer=ov["sc"])
    spec, has_thing = _spec(tok, CATS, 16)
    jspec, _ = _spec(tok, CATS, 16, jprompts)
    img = image(7)
    jres, _ = jpred._run(jspec, img, "detection", has_thing)
    tres, _ = pred._run(spec, img, "detection", has_thing)
    assert tres.sem_seg.shape[0] == len(CATS)
    _compare(tres, jres)
    # CLIP changed the result: the same call without it differs
    plain = HIPIEPredictor(tconfig.apply_overrides(ov["cfg"], {"model.clip.enabled": False}),
                           ov["model"], tok, bucket=BUCKET, device="cpu")
    base, _ = plain._run(spec, img, "detection", has_thing)
    assert not np.allclose(base.scores.numpy(), tres.scores.numpy())


def test_long_prompt_encoding_matches_jax(ov):
    """A LONG-token prompt through HIPIEModel.encode_text against JAX's
    ``encode_long_prompt`` on the JAX model's BERT: the same plan (chunks of at
    most 510 tokens cut at '.', [CLS] in front of continuations), the same
    states at 1e-5, zeros after the last separator."""
    from hipie_tpu.models.text.frontend import encode_long_prompt as j_encode
    from hipie_tpu.models.text.frontend import plan_chunks as j_plan

    spec, _ = _spec(ov["tok"], long_categories(), LONG)
    ids, am = spec.input_ids, spec.attention_mask
    assert am.sum() == LONG                   # the label set fills the prompt
    plan = j_plan(ids, am, ov["sep"])
    assert len(plan.src_spans) == 2 and plan.tgt_spans[-1][1] < LONG
    bert, params = ov["bert"], ov["params"]
    want = np.asarray(j_encode(bert, params, plan, LONG, 32))
    with torch.no_grad():
        got = ov["model"].encode_text(torch.from_numpy(ids[None]).long(),
                                      torch.from_numpy(am[None])).numpy()
    assert got.shape == want.shape == (1, LONG, 32) and np.isfinite(got).all()
    end = plan.tgt_spans[-1][1]
    assert not got[0, end:].any() and np.abs(got[0, :end]).min(-1).max() > 0
    assert _rel(got, want) < 1e-5
    # JAX's model itself, past its 512 positions, gives NaN everywhere (C-4)
    nan = np.asarray(bert(params, jnp.asarray(ids[None]), jnp.asarray(am[None])))
    assert np.isnan(nan).all()


def test_short_prompt_keeps_the_one_call_path(ov):
    """A prompt within BERT's positions goes through the text encoder once, as before."""
    model = ov["model"]
    ids = torch.randint(0, 78, (2, 40), generator=torch.Generator().manual_seed(1))
    am = torch.ones(2, 40, dtype=torch.long)
    am[1, 30:] = 0
    with torch.no_grad():
        np.testing.assert_array_equal(model.encode_text(ids, am).numpy(),
                                      model.text_encoder(ids, am).numpy())


def test_long_prompt_with_parallel_det_raises(ov):
    from hipie_torch.models.hipie import HIPIEModel

    model = HIPIEModel(ov["cfg"].model, parallel_det=True, sep_token_id=ov["sep"]).eval()
    ids = torch.full((1, LONG), 5)
    with pytest.raises(NotImplementedError):
        model.encode_text(ids, torch.ones_like(ids))
    model.encode_text(ids, torch.ones_like(ids), task="grounding")   # no block mask there


def test_long_prompt_predictor_matches_jax(ov, monkeypatch):
    """The port's predictor with a LONG-token prompt (chunked BERT) and CLIP,
    against JAX's detector given JAX's ``encode_long_prompt`` states through
    ``lang_hidden``, then JAX's ``hipie_inference`` with JAX's ``clip_fn``, on
    the same padded canvas."""
    from hipie_tpu.models.hipie import hipie_inference as j_inference
    from hipie_tpu.models.postprocess import ClassMaps as JMaps
    from hipie_tpu.models.text.frontend import encode_long_prompt as j_encode
    from hipie_tpu.models.text.frontend import plan_chunks as j_plan
    from hipie_torch.data.transforms import pad_to_bucket, resize_shortest_edge
    from hipie_torch.predictor import HIPIEPredictor

    for var in JAX_VARS:
        monkeypatch.delenv(var, raising=False)
    cfg = tconfig.apply_overrides(ov["cfg"], {"data.max_text_len": LONG})
    jcfg = jconfig.apply_overrides(ov["jcfg"], {"data.max_text_len": LONG})
    tok, jm, params = ov["tok"], ov["jm"], ov["params"]
    cats = long_categories()
    spec, has_thing = _spec(tok, cats, LONG)
    img = image(8)
    pred = HIPIEPredictor(cfg, ov["model"], tok, bucket=BUCKET, device="cpu",
                          clip_scorer=ov["sc"])
    tres, (h, w) = pred._run(spec, img, "detection", has_thing)

    resized, _ = resize_shortest_edge(img, cfg.data.min_size_test, cfg.data.max_size_test)
    padded, pad_mask = pad_to_bucket(resized, BUCKET)
    hidden = j_encode(ov["bert"], params, j_plan(spec.input_ids, spec.attention_mask, ov["sep"]),
                      LONG, 32)
    clip_fn, overlap = ov["jsc"].make_clip_fn([n.split(",") for n in spec.class_names])

    @jax.jit
    def run(p, images, pad, ids, am, sizes, maps, hidden):
        out = jm.apply(p, images, pad, ids, am, sizes, lang_hidden=hidden)
        return j_inference(out, JMaps(*maps), jcfg.test, jcfg.model, has_thing=has_thing,
                           pad_mask_s4=pad[0][::4, ::4], clip_fn=clip_fn, clip_overlap=overlap,
                           images01=jnp.clip(images / 255.0, 0.0, 1.0))

    maps = tuple(jnp.asarray(np.asarray(m)) for m in spec.class_maps())
    jres = jax.device_get(run(params, jnp.asarray(padded[None]), jnp.asarray(pad_mask[None]),
                              jnp.asarray(spec.input_ids[None]),
                              jnp.asarray(spec.attention_mask[None]), jnp.asarray([[h, w]]),
                              maps, hidden))
    assert tres.sem_seg.shape[0] == len(cats)
    _compare(tres, jres)


def test_predictor_builds_random_clip_towers(ov, capsys, monkeypatch):
    """With CLIP on and no scorer, the predictor builds random-init towers
    (narrowed here through the module's defaults) with the toy CLIP
    tokenizer, says so, and a detection call runs two MaskCLIP passes: the fg
    masks, then the fg + MaskDINO masks; grounding calls do not use CLIP."""
    import hipie_torch.models.postprocess_clip as pc
    from hipie_torch.models.text.clip_tokenizer import CLIPTokenizer
    from hipie_torch.predictor import HIPIEPredictor
    from test_torch_clip import port_towers

    vis, txt = port_towers()
    monkeypatch.setattr(pc, "CLIPVisual", lambda: vis)
    monkeypatch.setattr(pc, "CLIPText", lambda: txt)
    pred = HIPIEPredictor(ov["cfg"], ov["model"], ov["tok"], bucket=BUCKET, device="cpu")
    assert "RANDOM-INIT CLIP" in capsys.readouterr().out
    sc = pred.clip_scorer
    assert sc.visual is vis and sc.text is txt and isinstance(sc.tok, CLIPTokenizer)
    calls = []
    inner = sc.maskclip.forward
    monkeypatch.setattr(sc.maskclip, "forward",
                        lambda *a, **k: calls.append(a[1].shape) or inner(*a, **k))
    n_fg = ov["cfg"].model.transformer.num_queries
    n_md = ov["cfg"].model.maskdino.num_queries
    res = pred(image(3), test_categories=CATS[:3], score_thresh=-1.0)
    assert res["sem_seg"].shape == (50, 80) and np.isfinite(res["instances"]["scores"]).all()
    assert [c[1] for c in calls] == [n_fg, n_fg + n_md]
    pred(image(3), task="grounding", expressions="the dog")
    assert len(calls) == 2
