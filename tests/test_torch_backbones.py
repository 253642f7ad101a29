"""The port's Swin and ConvNeXt backbones against the JAX package's.

Narrow variants, inserted into both packages' variant tables for the module
(``build_backbone`` reaches these backbones only through their names): Swin
16 wide with 2 blocks a stage, window 4 (shift 2), so that the later stages'
maps are smaller than a window and pad; ConvNeXt 8 to 64 wide. Parameters come
from ``jax.eval_shape`` of the JAX init, filled from a numpy seed (norms,
biases, the relative position tables and layer scales random too); the port
loads them through ``hipie_torch.utils.export`` (``inv_swin``,
``inv_convnext``, ``export_hipie_checkpoint``) with strict=True. f32 on the
CPU. Tolerances: the backbones alone differ by f32 summation order (relative
norm 1e-5 on each output map); the tiny whole model on each, as
tests/test_torch_slice.py holds it (1e-4, slots aligned after the two-stage
top-k; 1e-3 on CondInst mask logits).
"""

import torch_threads  # noqa: F401  (first: sizes torch's CPU threads)
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import hipie_tpu.config as jconfig
import hipie_torch.config as tconfig

SWIN_NARROW = (16, (2, 2, 2, 2), (2, 2, 4, 4), 4)
CONVNEXT_NARROW = ((1, 1, 2, 1), (8, 16, 32, 64))
JAX_VARS = ("HIPIE_MSDA_METHOD", "HIPIE_GELU", "HIPIE_VIT_FLASH", "HIPIE_VIT_ATTN")


@pytest.fixture(autouse=True, scope="module")
def narrow_variants():
    import hipie_tpu.models.backbone.convnext as jconvnext
    import hipie_tpu.models.backbone.swin as jswin
    import hipie_torch.models.backbone.convnext as tconvnext
    import hipie_torch.models.backbone.swin as tswin

    with pytest.MonkeyPatch.context() as mp:
        for var in JAX_VARS:
            mp.delenv(var, raising=False)
        for mod in (jswin, tswin):
            mp.setitem(mod.SWIN_VARIANTS, "swin_narrow", SWIN_NARROW)
        for mod in (jconvnext, tconvnext):
            mp.setitem(mod.CONVNEXT_VARIANTS, "narrow", CONVNEXT_NARROW)
        yield


def fill_params(shapes, seed=0):
    """JAX parameter leaves from a numpy seed (tests/test_torch_train_common
    ``_fill``), with ConvNeXt's layer scales near 1 so that every block counts."""
    from test_torch_train_common import _fill

    r = np.random.RandomState(seed)

    def leaf(kp, sh):
        path = "/".join(str(getattr(k, "key", k)) for k in kp)
        if path.endswith("gamma"):
            return r.uniform(0.5, 1.5, sh.shape).astype(np.float32)
        return _fill(path, sh.shape, r)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _backbones(name):
    """(JAX module, port module) from each package's build_backbone."""
    from hipie_tpu.models.backbone import build_backbone as j_build
    from hipie_torch.models.backbone import build_backbone

    ov = {"model.backbone.name": name}
    jmod, jch = j_build(jconfig.apply_overrides(jconfig.tiny_test_config(), ov).model.backbone,
                        jnp.float32)
    mod, ch = build_backbone(tconfig.apply_overrides(tconfig.tiny_test_config(), ov).model.backbone)
    assert ch == jch
    return jmod, mod.eval()


@pytest.mark.parametrize("name", ["swin_narrow", "convnext_narrow"])
@pytest.mark.parametrize("hw", [(64, 96), (66, 90)])
def test_backbone_matches_jax(name, hw):
    """res3..res5 on a 64x96 image (the later Swin stages pad to whole
    windows) and on 66x90 (not a multiple of 4: SAME padding of the strided
    convolutions, odd maps cropped by Swin's patch merging)."""
    from hipie_torch.utils.export import inv_convnext, inv_swin

    jmod, mod = _backbones(name)
    x = np.random.RandomState(1).randn(1, *hw, 3).astype(np.float32)
    params = fill_params(jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jnp.asarray(x)))
    sd = {}
    (inv_swin if name.startswith("swin") else inv_convnext)(params["params"], "", sd)
    mod.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, strict=True)
    want = jax.device_get(jax.jit(jmod.apply)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = mod(torch.from_numpy(x))
    assert sorted(got) == sorted(want) == ["res3", "res4", "res5"]
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert rel_err(got[k].numpy(), want[k]) < 1e-5, k


@pytest.mark.parametrize("name,want", [("swin_xyz", "swin_tiny"), ("swin_large", "swin_large"),
                                       ("convnext_xyz", "tiny"), ("convnext", "tiny"),
                                       ("convnext_large", "large")])
def test_build_backbone_variant_rules(name, want):
    """JAX's rules: an unknown swin* name builds swin_tiny, an unknown
    convnext_* name the tiny ConvNeXt; both packages agree on the channels."""
    from hipie_torch.models.backbone import build_backbone
    from hipie_torch.models.backbone.convnext import CONVNEXT_VARIANTS, ConvNeXt
    from hipie_torch.models.backbone.swin import SWIN_VARIANTS, SwinTransformer

    from hipie_tpu.models.backbone import build_backbone as j_build

    cfg = tconfig.apply_overrides(tconfig.tiny_test_config(), {"model.backbone.name": name})
    jcfg = jconfig.apply_overrides(jconfig.tiny_test_config(), {"model.backbone.name": name})
    mod, ch = build_backbone(cfg.model.backbone)
    assert ch == j_build(jcfg.model.backbone, jnp.float32)[1]
    if name.startswith("swin"):
        assert isinstance(mod, SwinTransformer)
        embed, depths, _, _ = SWIN_VARIANTS[want]
        assert len(mod.layers) == 4 and sum(len(s.blocks) for s in mod.layers) == sum(depths)
        assert mod.patch_embed.proj.out_channels == embed
    else:
        assert isinstance(mod, ConvNeXt)
        depths, dims = CONVNEXT_VARIANTS[want]
        assert [len(s) for s in mod.stages] == list(depths)
        assert mod.downsample_layers[0][0].out_channels == dims[0]


def test_unknown_backbone_raises():
    from hipie_torch.models.backbone import build_backbone

    cfg = tconfig.apply_overrides(tconfig.tiny_test_config(), {"model.backbone.name": "vgg16"})
    with pytest.raises(ValueError):
        build_backbone(cfg.model.backbone)


def test_swin_drop_path_masks():
    """Training drop path: one keep mask per block and branch and sample,
    rates linear from 0 to 0.2 over the blocks; none at rate 0."""
    from hipie_torch.models.backbone.swin import SwinTransformer
    from hipie_torch.utils.rng import GeneratorKeys

    keys = lambda: GeneratorKeys(torch.Generator().manual_seed(0))
    mod = SwinTransformer(*SWIN_NARROW)
    masks = mod.draw_drop_masks(keys(), 3)
    assert masks.shape == (8, 2, 3) and masks[0].all()
    x = torch.randn(3, 64, 64, 3)
    with torch.no_grad():
        dropped = mod(x, drop_masks=torch.zeros(8, 2, 3))
        plain = mod(x)
    assert not torch.allclose(dropped["res5"], plain["res5"])
    assert SwinTransformer(*SWIN_NARROW, drop_path_rate=0.0).draw_drop_masks(keys(), 3) is None


B, H, W, L, C = 1, 128, 128, 16, 5


@pytest.fixture(scope="module", params=["swin_narrow", "convnext_narrow"])
def whole(request):
    """The tiny HIPIEModel on each backbone, JAX and the port on the same
    weights (export_hipie_checkpoint, strict load), one 128x128 canvas with a
    padded band (as tests/test_torch_slice.py: on a smaller one the stride-64
    level is 1x2, and its GroupNorm over two positions amplifies round-off)."""
    from hipie_tpu.models.hipie import HIPIEModel as JModel
    from hipie_tpu.models.hipie import hipie_inference as j_inference
    from hipie_tpu.models.postprocess import ClassMaps as JMaps
    from hipie_tpu.models.transformer import VLDeformableTransformer
    from hipie_tpu.utils.export import export_hipie_checkpoint
    from hipie_torch.models.hipie import HIPIEModel, hipie_inference
    from hipie_torch.models.postprocess import ClassMaps

    ov = {"model.backbone.name": request.param}
    cfg = tconfig.apply_overrides(tconfig.tiny_test_config(), ov)
    jcfg = jconfig.apply_overrides(jconfig.tiny_test_config(), ov)
    r = np.random.RandomState(0)
    img = r.uniform(0, 255, (B, H, W, 3)).astype(np.float32)
    pad = np.zeros((B, H, W), bool)
    pad[:, 96:] = True
    ids = (np.arange(L)[None] % 16).astype(np.int32)
    am = np.ones((B, L), np.int32)
    sizes = np.array([[96, W]], np.int32)
    args = (img, pad, ids, am, sizes)
    mw = np.zeros((C, L), np.float32)
    tm = np.zeros((C, L), bool)
    for c in range(C):
        mw[c, 2 * c + 1] = 1.0
        tm[c, 2 * c + 1] = True
    is_thing = np.array([True, True, False, False, True])
    pad_s4 = pad[0][::4, ::4]

    jm = JModel(jcfg.model)
    params = fill_params(jax.eval_shape(jm.init, jax.random.PRNGKey(0), *args))

    def run(p, *a):
        out, state = jm.apply(
            p, *a, mutable=["intermediates"],
            capture_intermediates=lambda mdl, method: (
                isinstance(mdl, VLDeformableTransformer) and method == "__call__"))
        out["memory"] = state["intermediates"]["detr"]["transformer"]["__call__"][0]["memory"]
        res = j_inference(out, JMaps(jnp.asarray(mw), jnp.asarray(tm), jnp.asarray(is_thing)),
                          jcfg.test, jcfg.model, pad_mask_s4=jnp.asarray(pad_s4))
        return out, res

    jout, jres = jax.device_get(jax.jit(run)(params, *args))
    model = HIPIEModel(cfg.model).eval()
    sd = export_hipie_checkpoint(jax.device_get(params)["params"], jcfg)
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, strict=True)
    with torch.inference_mode():
        tout = model(*map(torch.from_numpy, args))
        tres = hipie_inference(tout, ClassMaps(*map(torch.from_numpy, (mw, tm, is_thing))),
                               cfg.test, cfg.model, pad_mask_s4=torch.from_numpy(pad_s4))
    return request.param, jout, jres, tout, tres


def _close(got, want, tol, name):
    np.testing.assert_allclose(np.asarray(got.float()), np.asarray(want), rtol=tol, atol=tol,
                               err_msg=name)


def test_whole_model_encoder_matches_jax(whole):
    _, jout, _, tout, _ = whole
    _close(tout["memory"], jout["memory"], 1e-4, "encoder memory")
    _close(tout["enc_outputs_class"], jout["enc_outputs_class"], 1e-4, "enc_outputs_class")


def test_whole_model_decoders_match_jax_slot_aligned(whole):
    _, jout, _, tout, _ = whole
    ref = np.asarray(jout["init_reference"])[0]
    ours = tout["init_reference"].numpy()[0]
    perm = np.abs(ref[:, None, :] - ours[None, :, :]).max(-1).argmin(1)
    assert len(set(perm.tolist())) == len(perm), "slot alignment is not bijective"
    for key, tol in (("pred_logits", 1e-4), ("pred_boxes", 1e-4), ("pred_masks", 1e-3)):
        _close(tout[key][:, perm], jout[key], tol, key)
    for key in ("pred_logits", "pred_boxes", "pred_masks"):
        _close(tout["maskdino"][key], jout["maskdino"][key], 1e-4 if key != "pred_masks" else 1e-3,
               f"maskdino {key}")


def test_whole_model_inference_matches_jax(whole):
    _, _, jres, _, tres = whole
    for name in ("scores", "boxes", "sem_seg"):
        _close(getattr(tres, name), getattr(jres, name), 1e-4, name)
    for name in ("classes", "panoptic", "segment_valid", "segment_classes"):
        np.testing.assert_array_equal(getattr(tres, name).numpy(), np.asarray(getattr(jres, name)),
                                      err_msg=name)
