"""The whole serving slice, JAX against the port: HIPIEModel + hipie_inference.

tiny_test_config with a narrow ViT (64 wide, 4 blocks: 3 windowed, 1 global;
``build_backbone`` only reaches ViTs through VIT_VARIANTS, so the variant is
inserted into both packages' tables for this module), still-cls encoder head
as in the ViT-H preset, shared-encoder MaskDINO, f32, one 128x128 image with a
padded band. The JAX parameters from an inference ``init`` load into the port
with strict=True. Outputs after the two-stage top-k are compared slot-aligned
(the alignment must come out bijective) as tools/parity_full.py does, since
near-tied proposal scores may swap slots between two f32 implementations.
Tolerances: f32 round-off through the encoder and decoder stacks (1e-4 on
values of scale ~1-10; 1e-3 on CondInst mask logits of scale ~50, which
amplify controller round-off through un-normalised coordinates).
"""

import torch_threads  # noqa: F401  (first: sizes torch's CPU threads)
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import hipie_tpu.config as jconfig
import hipie_torch.config as tconfig

NARROW = (64, 4, 4, 0.0)
B, H, W, L, C = 1, 128, 128, 16, 5


def slice_config(pkg=tconfig):
    """The port's config (or, with ``pkg=jconfig``, the JAX package's), same overrides."""
    return pkg.apply_overrides(pkg.tiny_test_config(), {
        "model.backbone.name": "vit_narrow", "model.backbone.vit_img_size": 128,
        "model.backbone.vit_window_size": 4, "model.still_cls_for_encoder": True})


def class_maps():
    mw = np.zeros((C, L), np.float32)
    tm = np.zeros((C, L), bool)
    for c in range(C):
        mw[c, 2 * c + 1] = 1.0
        tm[c, 2 * c + 1] = True
    return mw, tm, np.array([True, True, False, False, True])


def slice_inputs():
    r = np.random.RandomState(0)
    img = r.uniform(0, 255, (B, H, W, 3)).astype(np.float32)
    pad = np.zeros((B, H, W), bool)
    pad[:, 96:, :] = True
    ids = (np.arange(L)[None] % 16).astype(np.int32)
    am = np.ones((B, L), np.int32)
    sizes = np.array([[96, 128]], np.int32)
    return img, pad, ids, am, sizes


@pytest.fixture(scope="module")
def both():
    import hipie_tpu.models.backbone.vit as jvit
    import hipie_torch.models.backbone.vit as tvit
    from hipie_tpu.models.hipie import HIPIEModel as JModel
    from hipie_tpu.models.hipie import hipie_inference as j_inference
    from hipie_tpu.models.postprocess import ClassMaps as JMaps
    from hipie_tpu.models.transformer import VLDeformableTransformer
    from hipie_torch.models.hipie import HIPIEModel, hipie_inference
    from hipie_torch.models.postprocess import ClassMaps
    from hipie_tpu.utils.export import export_hipie_checkpoint
    from hipie_torch.utils.weights import load_from_jax

    with pytest.MonkeyPatch.context() as mp:
        for var in ("HIPIE_MSDA_METHOD", "HIPIE_GELU", "HIPIE_VIT_FLASH", "HIPIE_VIT_ATTN"):
            mp.delenv(var, raising=False)
        mp.setitem(jvit.VIT_VARIANTS, "vit_narrow", NARROW)
        mp.setitem(tvit.VIT_VARIANTS, "vit_narrow", NARROW)
        cfg, jcfg = slice_config(), slice_config(jconfig)
        args = slice_inputs()
        mw, tm, is_thing = class_maps()
        pad_s4 = args[1][0][::4, ::4]

        jm = JModel(jcfg.model)
        params = jax.jit(jm.init)(jax.random.PRNGKey(0), *args)

        def run(p, *a):
            # capture the transformer's outputs for the encoder memory
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
        params_np = jax.device_get(params)["params"]
        keys = (set(export_hipie_checkpoint(params_np, jcfg)), set(model.state_dict()))
        load_from_jax(model, params_np, cfg)
        with torch.inference_mode():
            tout = model(*map(torch.from_numpy, args))
            tres = hipie_inference(tout, ClassMaps(*map(torch.from_numpy, (mw, tm, is_thing))),
                                   cfg.test, cfg.model, pad_mask_s4=torch.from_numpy(pad_s4))
    return cfg, jout, jres, tout, tres, keys


def _close(got, want, tol, name):
    np.testing.assert_allclose(np.asarray(got.float() if torch.is_tensor(got) else got),
                               np.asarray(want), rtol=tol, atol=tol, err_msg=name)


def test_strict_load_has_the_same_keys(both):
    """The port builds exactly the parameters an inference init creates."""
    exported, ported = both[-1]
    assert exported == ported, (sorted(exported - ported)[:10], sorted(ported - exported)[:10])
    assert any(".blocks.2.attn.rel_pos_h" in k for k in ported)       # the global block


def test_encoder_and_proposals(both):
    _, jout, _, tout, _, _ = both
    _close(tout["memory"], jout["memory"], 1e-4, "encoder memory")
    _close(tout["enc_outputs_class"], jout["enc_outputs_class"], 1e-4, "enc_outputs_class")
    _close(tout["enc_outputs_coord_unact"], jout["enc_outputs_coord_unact"], 1e-3,
           "enc_outputs_coord_unact")


def _slot_perm(jout, tout):
    ref = np.asarray(jout["init_reference"])[0]
    ours = tout["init_reference"].numpy()[0]
    perm = np.abs(ref[:, None, :] - ours[None, :, :]).max(-1).argmin(1)
    assert len(set(perm.tolist())) == len(perm), "slot alignment is not bijective"
    return perm


def test_decoder_outputs_slot_aligned(both):
    _, jout, _, tout, _, _ = both
    perm = _slot_perm(jout, tout)
    _close(tout["init_reference"][:, perm], jout["init_reference"], 1e-4, "init_reference")
    _close(tout["hs"][:, :, perm], jout["hs"], 1e-4, "decoder hs")
    _close(tout["pred_logits"][:, perm], jout["pred_logits"], 1e-4, "pred_logits")
    _close(tout["pred_boxes"][:, perm], jout["pred_boxes"], 1e-4, "pred_boxes")
    _close(tout["pred_boxious"][:, perm], jout["pred_boxious"], 1e-4, "pred_boxious")
    _close(tout["pred_masks"][:, perm], jout["pred_masks"], 1e-3, "pred_masks")


def test_maskdino_outputs(both):
    _, jout, _, tout, _, _ = both
    for key in ("pred_logits", "pred_boxes", "pred_masks"):
        _close(tout["maskdino"][key], jout["maskdino"][key], 1e-4, f"maskdino {key}")


def test_inference_result(both):
    cfg, _, jres, _, tres, _ = both
    assert tres.scores.shape == (cfg.test.detections_per_image,)
    for name in ("scores", "boxes", "sem_seg"):
        _close(getattr(tres, name), getattr(jres, name), 1e-4, name)
    _close(tres.mask_logits, jres.mask_logits, 1e-3, "mask_logits")
    for name in ("classes", "panoptic", "segment_valid", "segment_classes", "segment_isthing"):
        np.testing.assert_array_equal(getattr(tres, name).numpy(), np.asarray(getattr(jres, name)),
                                      err_msg=name)
