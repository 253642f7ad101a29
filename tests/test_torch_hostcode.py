"""The port's copies of the JAX package's host modules give what the originals give.

hipie_torch keeps its own config, presets, tokenizer, prompt builders, label
spaces, ``pad_to_bucket``, checkpoint export and event storage, so that it imports nothing of
hipie_tpu. Each check here runs a copy and its original on the same inputs and
asks for equality: exact, since both are the same host code over numpy.
"""

import dataclasses
import os

import numpy as np
import pytest

import hipie_tpu.config as jconfig
import hipie_tpu.presets as jpresets
import hipie_torch.config as tconfig
import hipie_torch.presets as tpresets

# The override dicts the port's tests and chip_smoke.py build configs with.
OVERRIDES = {
    "slice": {"model.backbone.name": "vit_narrow", "model.backbone.vit_img_size": 128,
              "model.backbone.vit_window_size": 4, "model.still_cls_for_encoder": True},
    "predictor": {"data.min_size_test": 48, "data.max_size_test": 96,
                  "data.max_text_len": 16, "model.text.max_query_len": 16},
    "grounding_content": {"model.transformer.still_tgt_for_both": False},
    "clip": {"model.clip.enabled": True},
    "bg_lang": {"model.bg_query_from_lang": True},
}
PRESETS = ["r50_coco_panoptic", "vit_huge_coco_panoptic", "swin_large_coco_panoptic",
           "convnext_large_coco_panoptic", "r50_refcoco", "open_vocab_eval", "parts_finetune"]
WORDS = ["person", "dog", "sky", "grass", "head", "tail", "umbrella", "left"]
TEXTS = ["person. dog. sky. grass.", "the dog on the grass", "The PERSON, left of the dog!",
         "an umbrella-holding person", "unknownword and dog", "", "  sky\tgrass\n  "]


def test_tiny_config_is_the_same():
    assert dataclasses.asdict(tconfig.tiny_test_config()) == dataclasses.asdict(
        jconfig.tiny_test_config())
    assert dataclasses.asdict(tconfig.HIPIEConfig()) == dataclasses.asdict(jconfig.HIPIEConfig())


def test_config_fields_are_the_same():
    """Same dataclasses, same field names and annotations, in the same order."""
    classes = lambda mod: {n for n, c in vars(mod).items()
                           if isinstance(c, type) and dataclasses.is_dataclass(c)}
    names = classes(jconfig)
    assert names == classes(tconfig) and {"HIPIEConfig", "ModelConfig", "TestConfig"} <= names
    for name in names:
        fields = lambda mod: [(f.name, f.type) for f in dataclasses.fields(getattr(mod, name))]
        assert fields(tconfig) == fields(jconfig), name


@pytest.mark.parametrize("name", PRESETS)
def test_presets_are_the_same(name):
    assert dataclasses.asdict(getattr(tpresets, name)()) == dataclasses.asdict(
        getattr(jpresets, name)())


def test_every_preset_is_copied():
    public = lambda mod: {n for n, f in vars(mod).items()
                          if callable(f) and getattr(f, "__module__", None) == mod.__name__}
    assert public(tpresets) == public(jpresets) == set(PRESETS)


@pytest.mark.parametrize("key", sorted(OVERRIDES))
def test_overrides_give_the_same_config(key):
    ov = OVERRIDES[key]
    got = tconfig.apply_overrides(tconfig.tiny_test_config(), ov)
    want = jconfig.apply_overrides(jconfig.tiny_test_config(), ov)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(got) != dataclasses.asdict(tconfig.tiny_test_config())


def test_unknown_override_raises_in_both():
    for pkg in (tconfig, jconfig):
        with pytest.raises(Exception):
            pkg.apply_overrides(pkg.tiny_test_config(), {"model.no_such_field": 1})


def _tokenizers():
    from hipie_torch.models.text.tokenizer import WordPieceTokenizer
    from hipie_tpu.models.text.tokenizer import WordPieceTokenizer as JTok

    return WordPieceTokenizer.toy(words=WORDS), JTok.toy(words=WORDS)


@pytest.mark.parametrize("text", TEXTS)
def test_toy_tokenizer_gives_the_same_ids(text):
    tok, jtok = _tokenizers()
    assert tok.vocab == jtok.vocab
    assert tok.tokenize(text) == jtok.tokenize(text)
    got, want = tok.encode(text, max_len=16), jtok.encode(text, max_len=16)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


def _assert_same_spec(got, want):
    assert got.prompt == want.prompt and got.class_names == want.class_names
    for k in ("input_ids", "attention_mask", "mean_weights", "token_mask", "is_thing"):
        a, b = np.asarray(getattr(got, k)), np.asarray(getattr(want, k))
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("names,is_thing,part_words", [
    (["person", "dog", "sky", "grass"], [True, True, False, False], ()),
    (["person", "dog"], [True, True], ("head", "tail")),
    (["umbrella", "person", "left dog", "sky"], [True, True, True, False], ()),
])
def test_build_prompt_spec_gives_the_same_arrays(names, is_thing, part_words):
    import hipie_torch.data.prompts as tprompts
    import hipie_tpu.data.prompts as jprompts

    tok, jtok = _tokenizers()
    for max_len in (16, 32):
        _assert_same_spec(tprompts.build_prompt_spec(names, is_thing, tok, max_len, part_words),
                          jprompts.build_prompt_spec(names, is_thing, jtok, max_len, part_words))


@pytest.mark.parametrize("expression", ["the dog on the grass", "person", "a sky left of it"])
def test_grounding_prompt_spec_gives_the_same_arrays(expression):
    import hipie_torch.data.prompts as tprompts
    import hipie_tpu.data.prompts as jprompts

    tok, jtok = _tokenizers()
    _assert_same_spec(tprompts.grounding_prompt_spec(expression, tok, 16),
                      jprompts.grounding_prompt_spec(expression, jtok, 16))


def test_prompt_spec_class_maps_are_torch():
    import torch

    import hipie_torch.data.prompts as tprompts
    from hipie_torch.models.postprocess import ClassMaps

    tok, _ = _tokenizers()
    spec = tprompts.build_prompt_spec(["person", "sky"], [True, False], tok, 16)
    maps = spec.class_maps()
    assert isinstance(maps, ClassMaps) and all(torch.is_tensor(t) for t in maps)
    np.testing.assert_array_equal(maps.mean_weights.numpy(), spec.mean_weights)
    assert maps.token_mask.dtype == torch.bool and maps.is_thing.tolist() == [True, False]


@pytest.mark.parametrize("shape,bucket", [((48, 77, 3), (64, 96)), ((800, 1067, 3), (800, 1216)),
                                          ((5, 7), (5, 7)), ((3, 9, 2), (8, 16))])
def test_pad_to_bucket_is_the_same(shape, bucket):
    from hipie_torch.data.transforms import pad_to_bucket
    from hipie_tpu.data.transforms import pad_to_bucket as jpad

    img = np.random.RandomState(shape[0]).uniform(0, 255, shape).astype(np.float32)
    (got, gmask), (want, wmask) = pad_to_bucket(img, bucket), jpad(img, bucket)
    assert got.dtype == want.dtype and gmask.dtype == wmask.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(gmask, wmask)


def test_label_spaces_are_the_same():
    import hipie_torch.data.label_spaces as tls
    import hipie_tpu.data.label_spaces as jls

    names = {n for n in vars(jls) if n.isupper()}
    assert names == {n for n in vars(tls) if n.isupper()}
    assert {"COCO_80", "COCO_PANOPTIC_133", "COCO_PANOPTIC_IS_THING"} <= names
    for n in names:
        assert getattr(tls, n) == getattr(jls, n), n


@pytest.mark.parametrize("key", ["tiny", "slice"])
def test_export_is_the_same(key, monkeypatch):
    """The tiny model's parameter tree, shaped by the JAX model's init and filled
    from a seed, exports to the same state_dict key for key, array for array."""
    import jax
    import jax.numpy as jnp

    import hipie_tpu.models.backbone.vit as jvit
    from hipie_torch.utils.export import export_hipie_checkpoint
    from hipie_tpu.models.hipie import HIPIEModel as JModel
    from hipie_tpu.utils.export import export_hipie_checkpoint as j_export

    monkeypatch.setitem(jvit.VIT_VARIANTS, "vit_narrow", (64, 4, 4, 0.0))
    ov = OVERRIDES["slice"] if key == "slice" else {}
    cfg = tconfig.apply_overrides(tconfig.tiny_test_config(), ov)
    jcfg = jconfig.apply_overrides(jconfig.tiny_test_config(), ov)
    hw, L = (128, 128), jcfg.model.text.max_query_len
    shapes = jax.eval_shape(
        JModel(jcfg.model).init, jax.random.PRNGKey(0), jnp.zeros((1,) + hw + (3,)),
        jnp.zeros((1,) + hw, bool), jnp.zeros((1, L), jnp.int32), jnp.ones((1, L), jnp.int32),
        jnp.asarray([hw]))["params"]
    rng = np.random.RandomState(0)
    params = jax.tree_util.tree_map(lambda s: rng.randn(*s.shape).astype(s.dtype), shapes)
    got, want = export_hipie_checkpoint(params, cfg), j_export(params, jcfg)
    assert len(want) > 100 and list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_event_storage_is_the_same(tmp_path, capsys):
    """The port's EventStorage is the JAX package's, line for line, and the same
    calls write the same metrics.json and console lines (the profiler differs
    by design: torch.profiler in place of jax.profiler)."""
    import inspect

    import hipie_tpu.utils.events as jev
    import hipie_torch.utils.events as tev

    assert inspect.getsource(tev.EventStorage) == inspect.getsource(jev.EventStorage)
    out = []
    for mod in (jev, tev):
        d = tmp_path / mod.__name__
        st = mod.EventStorage(str(d), window=3)
        for i in range(5):
            st.put_scalars(loss_ce=1.0 / (i + 1), total_loss=2.0 + i, data_time=0.0)
            st.iter += 1
            st.write_json()
            st.log_console(lr=1e-4)
        out.append(((d / "metrics.json").read_text(), capsys.readouterr().out))
    assert out[0] == out[1] and out[0][0].count("\n") == 5


def test_dataset_registry_and_label_files_are_the_same():
    """datasets.py + datasets_extra.py register the same names with the same
    metadata in both packages, and the port's copy of the open-vocab label
    files gives the same label sets."""
    import hipie_tpu.data.datasets as jds
    import hipie_tpu.data.datasets_extra as jdx
    import hipie_torch.data.datasets as tds
    import hipie_torch.data.datasets_extra as tdx

    assert set(tds.DATASET_REGISTRY) == set(jds.DATASET_REGISTRY)
    assert tds.DATASET_METADATA == jds.DATASET_METADATA
    assert {"coco_panoptic_train", "refcoco-mixed", "ade20k_sem_seg_val", "pascal_parts_val",
            "seginw_Elephants_val"} <= set(tds.DATASET_REGISTRY)
    assert any(n.startswith("odinw_") for n in tds.DATASET_REGISTRY)
    names = sorted(os.path.basename(p)[:-4] for p in os.listdir(jdx.OPENSEG_LABELS_DIR)
                   if p.endswith(".txt"))
    assert names == sorted(os.path.basename(p)[:-4] for p in os.listdir(tdx.OPENSEG_LABELS_DIR)
                           if p.endswith(".txt"))
    for name in names:
        if name.endswith("_with_prompt_eng"):
            continue
        assert tdx.get_openseg_labels(name) == jdx.get_openseg_labels(name), name
        assert tdx.openseg_names_and_things(name) == jdx.openseg_names_and_things(name), name
