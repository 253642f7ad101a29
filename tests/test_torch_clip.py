"""The port's CLIP (hipie_torch/models/clip.py, postprocess_clip.py and
utils/export.py::inv_clip) against the JAX package's.

Narrow towers (visual: 32 wide, 2 blocks, 2 heads, patch 8 at 32; text: 32
wide, 2 blocks, vocabulary 600), f32 on the CPU. The weights are a synthetic
open_clip state dict made from a numpy seed (norms and biases random too):
JAX gets it through its ``convert_clip``, the port loads it as it is, with
strict=True. Tolerances: the towers and MaskCLIP differ by f32 summation
order only (relative norm 1e-5); ``mask_attn_from_logits`` is a threshold of
the same resize, so it must agree exactly; the fusions are a few elementwise
f32 ops (1e-6).
"""

import torch_threads  # noqa: F401  (first: sizes torch's CPU threads)
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

W, LAYERS, HEADS, OUT, VOCAB = 32, 2, 2, 16, 600
IMAGE, PATCH = 32, 8


def open_clip_state_dict(seed=0):
    """An open_clip-layout state dict of the narrow towers, from a numpy seed."""
    r = np.random.RandomState(seed)
    f = lambda *s, scale=1.0: (r.randn(*s) * scale).astype(np.float32)
    n_patch = (IMAGE // PATCH) ** 2
    sd = {"visual.conv1.weight": f(W, 3, PATCH, PATCH, scale=0.1),
          "visual.class_embedding": f(W), "visual.positional_embedding": f(n_patch + 1, W),
          "visual.proj": f(W, OUT, scale=0.2), "token_embedding.weight": f(VOCAB, W),
          "positional_embedding": f(77, W, scale=0.1), "text_projection": f(W, OUT, scale=0.2),
          "logit_scale": np.asarray(2.5, np.float32)}
    for ln in ("visual.ln_pre", "visual.ln_post", "ln_final"):
        sd[f"{ln}.weight"], sd[f"{ln}.bias"] = 1 + f(W, scale=0.1), f(W, scale=0.1)
    for side in ("visual.transformer", "transformer"):
        for i in range(LAYERS):
            p = f"{side}.resblocks.{i}"
            for ln in ("ln_1", "ln_2"):
                sd[f"{p}.{ln}.weight"], sd[f"{p}.{ln}.bias"] = 1 + f(W, scale=0.1), f(W, scale=0.1)
            sd[f"{p}.attn.in_proj_weight"] = f(3 * W, W, scale=W ** -0.5)
            sd[f"{p}.attn.in_proj_bias"] = f(3 * W, scale=0.1)
            sd[f"{p}.attn.out_proj.weight"] = f(W, W, scale=W ** -0.5)
            sd[f"{p}.attn.out_proj.bias"] = f(W, scale=0.1)
            sd[f"{p}.mlp.c_fc.weight"] = f(4 * W, W, scale=W ** -0.5)
            sd[f"{p}.mlp.c_fc.bias"] = f(4 * W, scale=0.1)
            sd[f"{p}.mlp.c_proj.weight"] = f(W, 4 * W, scale=(4 * W) ** -0.5)
            sd[f"{p}.mlp.c_proj.bias"] = f(W, scale=0.1)
    return sd


def jax_towers():
    from hipie_tpu.models.clip import CLIPText, CLIPVisual

    return (CLIPVisual(image_size=IMAGE, patch_size=PATCH, width=W, layers=LAYERS, heads=HEADS,
                       output_dim=OUT),
            CLIPText(vocab_size=VOCAB, width=W, layers=LAYERS, heads=HEADS, output_dim=OUT))


def port_towers():
    from hipie_torch.models.clip import CLIPText, CLIPVisual

    return (CLIPVisual(IMAGE, PATCH, W, LAYERS, HEADS, OUT),
            CLIPText(VOCAB, 77, W, LAYERS, HEADS, OUT))


def jax_scorer(params):
    """JAX's CLIPScorer over the narrow towers with the converted ``params``,
    built as its ``__init__`` builds one but without the random init (which
    compiles) and with the trees where MaskCLIP reads them: JAX's params= path
    files the visual tower under "vis", but MaskCLIP's scope for it is
    "visual" (ROADMAP C-5)."""
    from hipie_tpu.config import ClipConfig
    from hipie_tpu.models.clip import MaskCLIP
    from hipie_tpu.models.postprocess_clip import CLIPScorer
    from hipie_tpu.models.text.clip_tokenizer import CLIPTokenizer

    sc = CLIPScorer.__new__(CLIPScorer)
    sc.cfg, sc.tok = ClipConfig(enabled=True), CLIPTokenizer.toy()
    sc.visual, sc.text = jax_towers()
    sc.maskclip = MaskCLIP(visual=sc.visual)
    sc._text_cache = {}
    sc.text_params = {"params": params["text"]}
    sc.maskclip_params = {"params": {"visual": params["visual"],
                                     "logit_scale": params["logit_scale"]}}
    sc._text_apply = jax.jit(sc.text.apply)
    return sc


def port_scorer(sd):
    from hipie_torch.config import ClipConfig
    from hipie_torch.models.postprocess_clip import CLIPScorer
    from hipie_torch.models.text.clip_tokenizer import CLIPTokenizer

    vis, txt = port_towers()
    return CLIPScorer(ClipConfig(enabled=True), CLIPTokenizer.toy(), state_dict=sd,
                      visual=vis, text=txt, device="cpu")


@pytest.fixture(scope="module")
def weights():
    from hipie_tpu.utils.converter import convert_clip

    sd = open_clip_state_dict()
    return sd, convert_clip(sd, LAYERS, HEADS, LAYERS, HEADS)


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def inputs(seed=1, q=5, hw=(10, 12), img_hw=(40, 48)):
    """An image in [0, 1] and mask logits constant over blocks of a fifth of
    the map, so that each mask blocks some patches and sees others."""
    r = np.random.RandomState(seed)
    b = -(-min(hw) // 5)
    cells = r.randn(1, q, -(-hw[0] // b), -(-hw[1] // b)) * 4
    masks = np.repeat(np.repeat(cells, b, 2), b, 3)[:, :, :hw[0], :hw[1]]
    return r.rand(1, *img_hw, 3).astype(np.float32), masks.astype(np.float32)


@pytest.mark.parametrize("with_masks", [False, True])
def test_visual_tower_matches_jax(weights, with_masks):
    """CLS embedding, or the mask-token embeddings with masks that block
    patches; 1e-5 in relative norm."""
    from hipie_tpu.models.clip import clip_preprocess
    from hipie_tpu.models.clip import mask_attn_from_logits as j_mask_attn

    sd, conv = weights
    jvis, _ = jax_towers()
    vis, _ = port_towers()
    vis.load_state_dict({k[len("visual."):]: torch.from_numpy(v) for k, v in sd.items()
                         if k.startswith("visual.")}, strict=True)
    img01, masks = inputs()
    x = np.array(clip_preprocess(jnp.asarray(img01), IMAGE))
    attn = np.array(j_mask_attn(jnp.asarray(masks), IMAGE, PATCH)) if with_masks else None
    assert attn is None or (attn.any() and not attn.all())
    want = np.asarray(jvis.apply({"params": conv["visual"]}, jnp.asarray(x),
                                 None if attn is None else jnp.asarray(attn)))
    with torch.no_grad():
        got = vis(torch.from_numpy(x), None if attn is None else torch.from_numpy(attn)).numpy()
    assert got.shape == want.shape == ((1, 5, OUT) if with_masks else (1, OUT))
    assert rel_err(got, want) < 1e-5


def test_text_tower_matches_jax(weights):
    """Causal, end-of-text token (the highest id) pooled; 1e-5 in relative norm."""
    from hipie_torch.models.text.clip_tokenizer import CLIPTokenizer

    sd, conv = weights
    _, jtxt = jax_towers()
    _, txt = port_towers()
    txt.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()
                         if not k.startswith("visual.") and k != "logit_scale"}, strict=True)
    ids = CLIPTokenizer.toy()(["a photo of a dog.", "There is the cat in the scene",
                               "a large person"])
    want = np.asarray(jtxt.apply({"params": conv["text"]}, jnp.asarray(ids)))
    with torch.no_grad():
        got = txt(torch.from_numpy(ids).long()).numpy()
    assert got.shape == want.shape == (3, OUT)
    assert rel_err(got, want) < 1e-5


@pytest.mark.parametrize("mask_hw,image", [((10, 12), 32), ((40, 52), 32), ((200, 304), 336)])
def test_mask_attn_from_logits_matches_jax(mask_hw, image):
    """Upsampled and antialiased-downsampled mask probabilities (the last case
    is the 800x1216 canvas's stride-4 masks to CLIP's 336): the same blocked
    patches exactly."""
    from hipie_tpu.models.clip import mask_attn_from_logits as j_mask_attn
    from hipie_torch.models.clip import mask_attn_from_logits

    patch = 8 if image == 32 else 14
    _, masks = inputs(q=2 if image == 336 else 6, hw=mask_hw)
    want = np.asarray(j_mask_attn(jnp.asarray(masks), image, patch))
    got = mask_attn_from_logits(torch.from_numpy(masks), image, patch).numpy()
    assert got.dtype == bool and got.shape == want.shape
    assert want.any() and not want.all()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("img_hw", [(40, 48), (80, 120)])
def test_clip_preprocess_matches_jax(img_hw):
    """jax.image.resize's bilinear weights, antialiased when shrinking."""
    from hipie_tpu.models.clip import clip_preprocess as j_pre
    from hipie_torch.models.clip import clip_preprocess

    img01, _ = inputs(img_hw=img_hw)
    want = np.asarray(j_pre(jnp.asarray(img01), IMAGE))
    got = clip_preprocess(torch.from_numpy(img01), IMAGE).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("method", ["max", "mean"])
def test_ensemble_logits_matches_jax(method):
    from hipie_tpu.models.clip import ensemble_logits_with_labels as j_ens
    from hipie_torch.models.clip import ensemble_logits_with_labels

    logits = np.random.RandomState(3).randn(2, 7, 9).astype(np.float32)
    groups = (2, 1, 3, 1, 2)
    want = np.asarray(j_ens(jnp.asarray(logits), groups, method))
    got = ensemble_logits_with_labels(torch.from_numpy(logits), groups, method).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mode,c", [("MUL", 4), ("ADD", 4), ("MUL", 1), ("ADD", 1)])
def test_clip_score_fusion_matches_jax(mode, c):
    """Both modes, softmax over classes or sigmoid for one class; 1e-6."""
    from hipie_tpu.models.clip import clip_score_fusion as j_fuse
    from hipie_torch.models.clip import clip_score_fusion

    r = np.random.RandomState(4)
    pred = r.uniform(0.01, 1, (6, c)).astype(np.float32)
    clip_logits = r.randn(6, c).astype(np.float32)
    overlap = (np.arange(c) % 2).astype(np.float32)
    want = np.asarray(j_fuse(jnp.asarray(pred), jnp.asarray(clip_logits), jnp.asarray(overlap),
                             0.35, 0.45, mode))
    got = clip_score_fusion(torch.from_numpy(pred), torch.from_numpy(clip_logits),
                            torch.from_numpy(overlap), 0.35, 0.45, mode).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("transform_eval,with_iou", [(True, True), (False, False)])
def test_fuse_probs_match_jax(transform_eval, with_iou):
    from hipie_tpu.config import ClipConfig as JClip
    from hipie_tpu.models.postprocess_clip import fuse_all_probs as j_all
    from hipie_tpu.models.postprocess_clip import fuse_fg_probs as j_fg
    from hipie_torch.config import ClipConfig
    from hipie_torch.models.postprocess_clip import fuse_all_probs, fuse_fg_probs

    r = np.random.RandomState(5)
    cls, clip_logits = r.randn(7, 4).astype(np.float32), r.randn(7, 4).astype(np.float32)
    iou = r.randn(7, 1).astype(np.float32) if with_iou else None
    overlap = np.array([1, 0, 1, 0], np.float32)
    thing = np.array([True, True, False, True])
    prob = r.dirichlet(np.ones(4), 7).astype(np.float32)
    jcfg, cfg = JClip(enabled=True, beta=0.45), ClipConfig(enabled=True, beta=0.45)
    j = lambda a: None if a is None else jnp.asarray(a)
    t = lambda a: None if a is None else torch.from_numpy(a)
    want = np.asarray(j_fg(j(cls), j(clip_logits), j(overlap), j(thing), j(iou), jcfg,
                           transform_eval))
    got = fuse_fg_probs(t(cls), t(clip_logits), t(overlap), t(thing), t(iou), cfg,
                        transform_eval).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    want = np.asarray(j_all(j(prob), j(clip_logits), j(overlap), jcfg))
    got = fuse_all_probs(t(prob), t(clip_logits), t(overlap), cfg).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_prompt_labels_and_overlap_match_jax():
    import hipie_tpu.models.postprocess_clip as jpc
    import hipie_torch.models.postprocess_clip as tpc
    from hipie_torch.data.datasets_extra import openseg_names_and_things

    names, _ = openseg_names_and_things("pascal_context_459")
    labels = [n.split(",") for n in names]
    for prompt in ("a", "photo", "scene", None):
        assert tpc.prompt_labels(labels, prompt) == jpc.prompt_labels(labels, prompt)
    np.testing.assert_array_equal(tpc.category_overlap_mask(labels),
                                  jpc.category_overlap_mask(labels))
    assert 0 < tpc.category_overlap_mask(labels).sum() < len(labels)


def test_make_clip_fn_matches_jax(weights):
    """The scorer's (clip_fn, overlap) on the same weights: MaskCLIP's logits
    over synonym groups (max), logit scale exp(2.5); the text cache is built
    once per label set and skipped for one class."""
    sd, conv = weights
    jsc = jax_scorer(conv)
    sc = port_scorer(sd)
    labels = [["person"], ["dog", "puppy"], ["sky"], ["grass", "lawn", "turf"]]
    jfn, joverlap = jsc.make_clip_fn(labels)
    fn, overlap = sc.make_clip_fn(labels)
    np.testing.assert_array_equal(overlap.numpy(), np.asarray(joverlap))
    img01, masks = inputs(q=7)
    want = np.asarray(jfn(jnp.asarray(img01), jnp.asarray(masks)))
    got = fn(torch.from_numpy(img01), torch.from_numpy(masks)).numpy()
    assert got.shape == want.shape == (7, 4)
    assert rel_err(got, want) < 1e-5
    te, gs = sc.build_text_embed(labels)
    assert sc.build_text_embed(labels)[0] is te and gs == (1, 2, 1, 3)
    assert rel_err(te.numpy(), np.asarray(jsc.build_text_embed(labels)[0])) < 1e-5
    sc.build_text_embed([["the dog on the left"]])
    assert len(sc._text_cache) == 1


def test_maskclip_logit_scale_is_clamped_at_100(weights):
    """exp(logit_scale) above 100 scales the cosines by 100 on both sides."""
    sd, conv = weights
    sd = dict(sd, logit_scale=np.asarray(5.0, np.float32))
    conv = dict(conv, logit_scale=np.asarray(5.0, np.float32))
    labels = [["person"], ["dog", "puppy"], ["sky"]]
    img01, masks = inputs(q=3)
    jfn, _ = jax_scorer(conv).make_clip_fn(labels)
    fn, _ = port_scorer(sd).make_clip_fn(labels)
    want = np.asarray(jfn(jnp.asarray(img01), jnp.asarray(masks)))
    got = fn(torch.from_numpy(img01), torch.from_numpy(masks)).numpy()
    assert np.abs(got).max() <= 100.0 + 1e-4 and rel_err(got, want) < 1e-5


def test_bridge_round_trip(weights):
    """open_clip state dict -> JAX's convert_clip -> the port's inv_clip gives
    the same state dict back, key for key and value for value."""
    from hipie_torch.utils.export import inv_clip

    sd, conv = weights
    back = inv_clip(jax.device_get(conv))
    assert set(back) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k], sd[k], err_msg=k)


def test_bridge_from_jax_random_init():
    """JAX's CLIPScorer at its own random init, its parameters through
    inv_clip into the port's scorer (strict load): the same clip_fn logits."""
    from hipie_tpu.config import ClipConfig
    from hipie_tpu.models.postprocess_clip import CLIPScorer
    from hipie_tpu.models.text.clip_tokenizer import CLIPTokenizer
    from hipie_torch.utils.export import inv_clip

    vis, txt = jax_towers()
    jsc = CLIPScorer(ClipConfig(enabled=True), CLIPTokenizer.toy(), visual=vis, text=txt)
    params = jax.device_get({"visual": jsc.maskclip_params["params"]["visual"],
                             "text": jsc.text_params["params"],
                             "logit_scale": jsc.maskclip_params["params"]["logit_scale"]})
    sc = port_scorer(inv_clip(params))
    labels = [["person"], ["dog", "cat"]]
    img01, masks = inputs(q=4)
    want = np.asarray(jsc.make_clip_fn(labels)[0](jnp.asarray(img01), jnp.asarray(masks)))
    got = sc.make_clip_fn(labels)[0](torch.from_numpy(img01), torch.from_numpy(masks)).numpy()
    assert rel_err(got, want) < 1e-5


def test_random_scorer_is_seeded_and_finite():
    """Without weights the towers come from a seeded torch.Generator: the same
    seed gives the same logits, in f32 by default."""
    from hipie_torch.config import ClipConfig
    from hipie_torch.models.postprocess_clip import CLIPScorer
    from hipie_torch.models.text.clip_tokenizer import CLIPTokenizer

    outs = []
    for seed in (3, 3, 4):
        vis, txt = port_towers()
        sc = CLIPScorer(ClipConfig(enabled=True), CLIPTokenizer.toy(), visual=vis, text=txt,
                        generator=torch.Generator().manual_seed(seed), device="cpu")
        assert sc.visual.proj.dtype == torch.float32
        img01, masks = inputs(q=3)
        outs.append(sc.make_clip_fn([["person"], ["dog"]])[0](
            torch.from_numpy(img01), torch.from_numpy(masks)))
    assert torch.isfinite(outs[0]).all()
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
