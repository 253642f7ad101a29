"""The port's training model against the JAX package's, on the CPU in f32 at
the tiny training config (test_torch_train_common.py): the parameters of
``create_train_state`` load strictly, every parameter carries the optimizer
label JAX gives it, and the train-mode outputs agree.
"""

import torch_threads  # noqa: F401  (first: sizes torch's CPU threads)
import numpy as np
import pytest
import jax
import torch

from test_torch_train_common import (batch_arrays, jax_batch, jax_train_state,
                                     port_model_from_jax, to_numpy_tree, torch_batch,
                                     train_config)


@pytest.fixture(scope="module")
def jax_state():
    arrays = batch_arrays()
    model, params, jcfg = jax_train_state(arrays)
    return arrays, model, params, jcfg


def test_train_parameters_load_strictly(jax_state):
    """create_train_state's tree (train=True: label_enc, every layer's class and
    IoU heads, every MaskDINO projection, MaskDINO's seg-DN resizer) loads into
    HIPIEModel(train=True) with strict=True; an inference model lacks exactly
    the train-only entries."""
    from hipie_torch.models.hipie import HIPIEModel

    _, _, params, _ = jax_state
    model, cfg = port_model_from_jax(params)
    train_only = set(model.state_dict()) - set(HIPIEModel(cfg.model).state_dict())
    assert "detr.label_enc.weight" in train_only
    assert "detr.mask_dino.predictor.resizer.fc.weight" in train_only
    assert "detr.detr.class_embed.0.bias0" in train_only
    assert "detr.mask_dino_cls_embed.0.bias0" in train_only


def test_parameter_labels_equal_jax(jax_state):
    """Every state_dict entry's group equals the JAX label of the leaf (or
    leaves) it is exported from: each JAX leaf is filled with its own index,
    so the exported values name their sources."""
    from hipie_tpu.train.optimizer import param_labels as jlabels
    from hipie_torch.train.optimizer import param_labels
    from hipie_torch.utils.export import export_hipie_checkpoint

    _, _, params, _ = jax_state
    leaves, treedef = jax.tree_util.tree_flatten(params)
    ids = jax.tree_util.tree_unflatten(
        treedef, [np.full(x.shape, i + 1, np.float32) for i, x in enumerate(leaves)])
    jl = jax.tree_util.tree_leaves(jlabels(params))
    cfg = train_config()
    sd = export_hipie_checkpoint(to_numpy_tree(ids)["params"], cfg)
    model, _ = port_model_from_jax(params)
    labels = param_labels(model)
    assert set(labels) == set(sd)
    seen = set()
    for name, arr in sd.items():
        src = {int(v) - 1 for v in np.unique(arr)}
        seen |= src
        assert {jl[i] for i in src} == {labels[name]}, name
    assert seen == set(range(len(leaves)))
    assert {"frozen", "lang", "vl", "backbone", "offsets", "base"} <= set(labels.values())


def _cdn(arrays, jcfg):
    from hipie_tpu.models.dn import prepare_cdn

    mc = jcfg.model
    t = jax_batch(arrays).targets
    key = jax.random.PRNGKey(4)
    cdn = prepare_cdn(key, t.labels, t.boxes, t.valid, mc.num_classes,
                      mc.transformer.num_queries + mc.transformer.num_bg_queries,
                      dn_number=mc.dn.dn_number)
    md = prepare_cdn(jax.random.fold_in(key, 7), t.labels, t.boxes, t.valid, mc.num_classes,
                     mc.maskdino.num_queries, dn_number=mc.maskdino.dn_queries,
                     label_noise_ratio=0.0, box_noise_scale=mc.maskdino.noise_scale)
    return dict(dn_labels=cdn.noised_labels, dn_valid=cdn.slot_valid,
                dn_refs_unact=cdn.refs_unact, self_attn_mask=cdn.attn_mask,
                maskdino_dn_refs=md.refs_unact, maskdino_dn_valid=md.slot_valid,
                maskdino_attn_mask=md.attn_mask)


def test_train_outputs_match_jax(jax_state):
    """forward(..., train=True) with the same CDN queries: every layer's class
    logits, boxes, IoU logits, controller parameters and references, the
    encoder outputs, mask features, and MaskDINO's per-layer classes, boxes
    and mask embeddings, interm outputs and pixel features. f32 round-off
    through the stacks: 1e-4 relative in norm."""
    arrays, jmodel, params, jcfg = jax_state
    dn = _cdn(arrays, jcfg)
    jb = jax_batch(arrays)
    want = jax.jit(lambda p, b, d: jmodel.apply(
        p, b.images, b.pad_mask, b.input_ids, b.lang_mask, b.image_sizes, train=True, **d))(
        params, jb, dn)
    model, _ = port_model_from_jax(params)
    tb = torch_batch(arrays)
    with torch.no_grad():
        got = model(tb.images, tb.pad_mask, tb.input_ids, tb.lang_mask, tb.image_sizes,
                    train=True, **{k: torch.from_numpy(np.asarray(v)) for k, v in dn.items()})
    pairs = [(k, got[k], want[k]) for k in (
        "outputs_class", "outputs_coord", "outputs_iou", "ctrl_params", "layer_refs",
        "enc_outputs_class", "enc_outputs_coord_unact", "mask_feats")]
    gm, jm = got["maskdino"], want["maskdino"]
    pairs += [(f"maskdino {k}", gm[k], jm[k]) for k in
              ("pred_logits", "pred_boxes", "pred_mask_embed", "mask_features")]
    for k in ("classes", "boxes", "mask_embeds"):
        assert len(gm["aux"][k]) == len(jm["aux"][k]) == jcfg.model.maskdino.dec_layers
        pairs += [(f"maskdino aux {k} {i}", g, w) for i, (g, w) in
                  enumerate(zip(gm["aux"][k], jm["aux"][k]))]
    pairs += [(f"maskdino interm {k}", gm["interm_outputs"][k], jm["interm_outputs"][k])
              for k in ("pred_logits", "pred_boxes", "pred_mask_embed")]
    for name, g, w in pairs:
        g, w = g.numpy().astype(np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape, name
        err = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
        assert err <= 1e-4, (name, err)
