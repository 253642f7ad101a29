"""flax-params -> PyTorch-style state_dict export (inverse of hipie_converter).

Counterpart of hipie_tpu/utils/export.py (numpy only, the same names; it also
exports the MaskDINO decoder's seg-DN ``resizer`` that the JAX package's
training init creates), kept in the port so that ``hipie_torch.utils.weights.load_from_jax`` turns the JAX
package's parameters, as numpy arrays, into the port's without importing it.

Two purposes:
  * Interop: export a trained hipie_tpu model to the reference's checkpoint
    naming so reference-side tooling can consume it (the reference ships its
    own weight-surgery precedent, projects/HIPIE/convert_pth2pkl.py).
  * Round-trip validation: `export -> convert` must reproduce the parameter
    tree exactly. tests/test_converter_roundtrip.py drives the FULL model tree
    through this and asserts coverage_report finds nothing missing or
    mismatched — the strongest converter exercise available without a released
    .pth in this environment (no network egress).

Every inv_* below is the exact layout inverse of the same-named t_* transform
in utils/converter.py.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

SD = Dict[str, np.ndarray]


def _np(x) -> np.ndarray:
    return np.asarray(x)


def inv_linear(tree: Dict[str, Any], p: str, sd: SD) -> None:
    sd[f"{p}.weight"] = _np(tree["kernel"]).T
    if "bias" in tree:
        sd[f"{p}.bias"] = _np(tree["bias"])


def inv_dense_general(tree: Dict[str, Any], p: str, sd: SD) -> None:
    k = _np(tree["kernel"])                    # (C, H, D)
    c = k.shape[0]
    sd[f"{p}.weight"] = k.reshape(c, -1).T     # (H*D, C)
    if "bias" in tree:
        sd[f"{p}.bias"] = _np(tree["bias"]).reshape(-1)


def inv_dense_general_out(tree: Dict[str, Any], p: str, sd: SD) -> None:
    k = _np(tree["kernel"])                    # (H, D, C)
    c = k.shape[-1]
    sd[f"{p}.weight"] = k.reshape(-1, c).T     # (C, H*D)
    if "bias" in tree:
        sd[f"{p}.bias"] = _np(tree["bias"])


def inv_conv(tree: Dict[str, Any], p: str, sd: SD) -> None:
    sd[f"{p}.weight"] = np.transpose(_np(tree["kernel"]), (3, 2, 0, 1))
    if "bias" in tree:
        sd[f"{p}.bias"] = _np(tree["bias"])


def inv_conv_transpose(tree: Dict[str, Any], p: str, sd: SD) -> None:
    # inverse of t_conv_transpose: undo the spatial flip, then permute
    # (kh, kw, in, out) -> torch (in, out, kh, kw)
    sd[f"{p}.weight"] = np.transpose(_np(tree["kernel"])[::-1, ::-1], (2, 3, 0, 1))
    if "bias" in tree:
        sd[f"{p}.bias"] = _np(tree["bias"])


def inv_norm(tree: Dict[str, Any], p: str, sd: SD) -> None:
    sd[f"{p}.weight"] = _np(tree["scale"])
    sd[f"{p}.bias"] = _np(tree["bias"])


def inv_frozen_bn(tree: Dict[str, Any], p: str, sd: SD) -> None:
    for k in ("weight", "bias", "running_mean", "running_var"):
        sd[f"{p}.{k}"] = _np(tree[k])


def inv_embed(tree: Dict[str, Any], p: str, sd: SD) -> None:
    sd[f"{p}.weight"] = _np(tree["embedding"])


def inv_mha(tree: Dict[str, Any], p: str, sd: SD) -> None:
    qkv = []
    qkv_b = []
    for name in ("q_proj", "k_proj", "v_proj"):
        k = _np(tree[name]["kernel"])          # (C, H, D)
        c = k.shape[0]
        qkv.append(k.reshape(c, -1).T)         # (C, C)
        qkv_b.append(_np(tree[name]["bias"]).reshape(-1))
    sd[f"{p}.in_proj_weight"] = np.concatenate(qkv, 0)
    sd[f"{p}.in_proj_bias"] = np.concatenate(qkv_b, 0)
    ko = _np(tree["out_proj"]["kernel"])       # (H, D, C)
    sd[f"{p}.out_proj.weight"] = ko.reshape(-1, ko.shape[-1]).T
    sd[f"{p}.out_proj.bias"] = _np(tree["out_proj"]["bias"])


def inv_mlp(tree: Dict[str, Any], p: str, sd: SD) -> None:
    for name, sub in tree.items():             # layers_{i}
        i = name.rsplit("_", 1)[1]
        inv_linear(sub, f"{p}.layers.{i}", sd)


def inv_conv_gn(tree: Dict[str, Any], conv_p: str, gn_p: str, sd: SD) -> None:
    inv_conv(tree["conv"], conv_p, sd)
    inv_norm(tree["gn"], gn_p, sd)


def inv_vl_align(tree: Dict[str, Any], p: str, sd: SD) -> None:
    inv_linear(tree["dot_product_projection_text"],
               f"{p}.dot_product_projection_text", sd)
    sd[f"{p}.log_scale"] = _np(tree["log_scale"])
    sd[f"{p}.bias_lang"] = _np(tree["bias_lang"])
    sd[f"{p}.bias0"] = _np(tree["bias0"])


def inv_msda(tree: Dict[str, Any], p: str, sd: SD) -> None:
    for name in ("sampling_offsets", "attention_weights", "value_proj",
                 "output_proj"):
        inv_linear(tree[name], f"{p}.{name}", sd)


def inv_enc_layer(tree: Dict[str, Any], p: str, sd: SD) -> None:
    inv_msda(tree["self_attn"], f"{p}.self_attn", sd)
    inv_norm(tree["norm1"], f"{p}.norm1", sd)
    inv_linear(tree["linear1"], f"{p}.linear1", sd)
    inv_linear(tree["linear2"], f"{p}.linear2", sd)
    inv_norm(tree["norm2"], f"{p}.norm2", sd)


def inv_dec_layer(tree: Dict[str, Any], p: str, sd: SD) -> None:
    inv_msda(tree["cross_attn"], f"{p}.cross_attn", sd)
    inv_norm(tree["norm1"], f"{p}.norm1", sd)
    inv_mha(tree["self_attn"], f"{p}.self_attn", sd)
    inv_norm(tree["norm2"], f"{p}.norm2", sd)
    inv_linear(tree["linear1"], f"{p}.linear1", sd)
    inv_linear(tree["linear2"], f"{p}.linear2", sd)
    inv_norm(tree["norm3"], f"{p}.norm3", sd)


def inv_bi_attention(tree: Dict[str, Any], p: str, sd: SD) -> None:
    inv_norm(tree["layer_norm_v"], f"{p}.layer_norm_v", sd)
    inv_norm(tree["layer_norm_l"], f"{p}.layer_norm_l", sd)
    sd[f"{p}.gamma_v"] = _np(tree["gamma_v"])
    sd[f"{p}.gamma_l"] = _np(tree["gamma_l"])
    a = tree["attn"]
    for name in ("v_proj", "l_proj", "values_v_proj", "values_l_proj"):
        inv_dense_general(a[name], f"{p}.attn.{name}", sd)
    for name in ("out_v_proj", "out_l_proj"):
        inv_dense_general_out(a[name], f"{p}.attn.{name}", sd)


def unstack_trees(tree: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Inverse of converter.stack_trees: split leading axis into a tree list."""
    if isinstance(tree, dict):
        per_key = {k: unstack_trees(v) for k, v in tree.items()}
        n = len(next(iter(per_key.values())))
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    arr = _np(tree)
    return [arr[i] for i in range(arr.shape[0])]


def inv_hf_bert(tree: Dict[str, Any], prefix: str, sd: SD) -> None:
    inv_embed(tree["word_embeddings"], f"{prefix}embeddings.word_embeddings", sd)
    inv_embed(tree["position_embeddings"],
              f"{prefix}embeddings.position_embeddings", sd)
    inv_embed(tree["token_type_embeddings"],
              f"{prefix}embeddings.token_type_embeddings", sd)
    inv_norm(tree["embeddings_norm"], f"{prefix}embeddings.LayerNorm", sd)
    for i, layer in enumerate(unstack_trees(tree["layers"]["layer"])):
        inv_bert_layer(layer, f"{prefix}encoder.layer.{i}", sd)


def inv_bert_layer(layer: Dict[str, Any], lp: str, sd: SD) -> None:
    """One JAX BertLayer -> Hugging Face BertLayer names under ``lp``."""
    att = layer["attention"]
    for name in ("query", "key", "value"):
        inv_dense_general(att[name], f"{lp}.attention.self.{name}", sd)
    inv_dense_general_out(att["output_dense"], f"{lp}.attention.output.dense", sd)
    inv_norm(layer["attention_norm"], f"{lp}.attention.output.LayerNorm", sd)
    inv_linear(layer["intermediate"], f"{lp}.intermediate.dense", sd)
    inv_linear(layer["output"], f"{lp}.output.dense", sd)
    inv_norm(layer["output_norm"], f"{lp}.output.LayerNorm", sd)


def inv_d2_resnet(tree: Dict[str, Any], prefix: str, sd: SD) -> None:
    inv_conv(tree["stem_conv1"], f"{prefix}stem.conv1", sd)
    inv_frozen_bn(tree["stem_conv1_norm"], f"{prefix}stem.conv1.norm", sd)
    for name, blk in tree.items():
        if not name.startswith("res"):
            continue
        stage, i = name.split("_")
        bp = f"{prefix}{stage}.{i}"
        for ci in (1, 2, 3):
            inv_conv(blk[f"conv{ci}"], f"{bp}.conv{ci}", sd)
            inv_frozen_bn(blk[f"conv{ci}_norm"], f"{bp}.conv{ci}.norm", sd)
        if "shortcut" in blk:
            inv_conv(blk["shortcut"], f"{bp}.shortcut", sd)
            inv_frozen_bn(blk["shortcut_norm"], f"{bp}.shortcut.norm", sd)


def inv_vit(tree: Dict[str, Any], prefix: str, sd: SD) -> None:
    inv_conv(tree["patch_embed"], f"{prefix}patch_embed.proj", sd)
    sd[f"{prefix}pos_embed"] = _np(tree["pos_embed"])
    inv_conv_transpose(tree["fpn1"], f"{prefix}fpn1.0", sd)
    runs = sorted((int(k.split("_")[1]), k) for k in tree if k.startswith("run_"))
    for start, key in runs:
        for off, blk in enumerate(unstack_trees(tree[key]["block"])):
            bp = f"{prefix}blocks.{start + off}"
            inv_norm(blk["norm1"], f"{bp}.norm1", sd)
            inv_norm(blk["norm2"], f"{bp}.norm2", sd)
            inv_linear(blk["attn"]["qkv"], f"{bp}.attn.qkv", sd)
            inv_linear(blk["attn"]["proj"], f"{bp}.attn.proj", sd)
            if "rel_pos_h" in blk["attn"]:
                sd[f"{bp}.attn.rel_pos_h"] = _np(blk["attn"]["rel_pos_h"])
                sd[f"{bp}.attn.rel_pos_w"] = _np(blk["attn"]["rel_pos_w"])
            inv_linear(blk["mlp_fc1"], f"{bp}.mlp.fc1", sd)
            inv_linear(blk["mlp_fc2"], f"{bp}.mlp.fc2", sd)


_MERGE_PERM = [0, 2, 1, 3]   # involution; see converter.convert_swin


def inv_swin(tree: Dict[str, Any], prefix: str, sd: SD) -> None:
    """Inverse of converter.convert_swin (timm/d2 Swin naming)."""
    inv_conv(tree["patch_embed"], f"{prefix}patch_embed.proj", sd)
    inv_norm(tree["patch_norm"], f"{prefix}patch_embed.norm", sd)
    stages: Dict[int, int] = {}
    for k in tree:
        if k.startswith("stage"):
            s, i = k[len("stage"):].split("_block")
            stages[int(s)] = max(stages.get(int(s), 0), int(i) + 1)
    for s in sorted(stages):
        for i in range(stages[s]):
            blk = tree[f"stage{s}_block{i}"]
            p = f"{prefix}layers.{s}.blocks.{i}"
            inv_norm(blk["norm1"], f"{p}.norm1", sd)
            inv_norm(blk["norm2"], f"{p}.norm2", sd)
            inv_linear(blk["attn"]["qkv"], f"{p}.attn.qkv", sd)
            inv_linear(blk["attn"]["proj"], f"{p}.attn.proj", sd)
            sd[f"{p}.attn.relative_position_bias_table"] = _np(
                blk["attn"]["relative_position_bias_table"])
            inv_linear(blk["mlp_fc1"], f"{p}.mlp.fc1", sd)
            inv_linear(blk["mlp_fc2"], f"{p}.mlp.fc2", sd)
        if f"merge_norm{s}" in tree:
            mn = tree[f"merge_norm{s}"]
            c = _np(mn["scale"]).shape[0] // 4

            def unperm(v):
                v = _np(v)
                return np.concatenate(
                    [v[k * c:(k + 1) * c] for k in _MERGE_PERM])

            dp = f"{prefix}layers.{s}.downsample"
            sd[f"{dp}.norm.weight"] = unperm(mn["scale"])
            sd[f"{dp}.norm.bias"] = unperm(mn["bias"])
            kern = _np(tree[f"merge_reduce{s}"]["kernel"])     # (4c, 2c)
            kern = np.concatenate(
                [kern[k * c:(k + 1) * c] for k in _MERGE_PERM], axis=0)
            sd[f"{dp}.reduction.weight"] = kern.T              # torch (out,in)
    for s in sorted(stages):
        if f"out_norm{s}" in tree:
            inv_norm(tree[f"out_norm{s}"], f"{prefix}norm{s}", sd)


def inv_convnext(tree: Dict[str, Any], prefix: str, sd: SD) -> None:
    """Inverse of converter.convert_convnext (facebook ConvNeXt naming)."""
    inv_conv(tree["stem_conv"], f"{prefix}downsample_layers.0.0", sd)
    inv_norm(tree["stem_norm"], f"{prefix}downsample_layers.0.1", sd)
    stages: Dict[int, int] = {}
    for k in tree:
        if k.startswith("stage"):
            s, i = k[len("stage"):].split("_block")
            stages[int(s)] = max(stages.get(int(s), 0), int(i) + 1)
    for s in sorted(stages):
        if f"down_norm{s}" in tree:
            inv_norm(tree[f"down_norm{s}"],
                     f"{prefix}downsample_layers.{s}.0", sd)
            inv_conv(tree[f"down_conv{s}"],
                     f"{prefix}downsample_layers.{s}.1", sd)
        for i in range(stages[s]):
            blk = tree[f"stage{s}_block{i}"]
            p = f"{prefix}stages.{s}.{i}"
            inv_conv(blk["dwconv"], f"{p}.dwconv", sd)
            inv_norm(blk["norm"], f"{p}.norm", sd)
            inv_linear(blk["pwconv1"], f"{p}.pwconv1", sd)
            inv_linear(blk["pwconv2"], f"{p}.pwconv2", sd)
            sd[f"{p}.gamma"] = _np(blk["gamma"])
        if f"out_norm{s}" in tree:
            inv_norm(tree[f"out_norm{s}"], f"{prefix}norm{s}", sd)


def _inv_clip_block(tree: Dict[str, Any], p: str, sd: SD) -> None:
    inv_norm(tree["ln_1"], f"{p}.ln_1", sd)
    inv_mha(tree["attn"], f"{p}.attn", sd)
    inv_norm(tree["ln_2"], f"{p}.ln_2", sd)
    inv_linear(tree["mlp_fc"], f"{p}.mlp.c_fc", sd)
    inv_linear(tree["mlp_proj"], f"{p}.mlp.c_proj", sd)


def _blocks(tree: Dict[str, Any]) -> List[Any]:
    return [tree[f"blocks_{i}"] for i in range(sum(k.startswith("blocks_") for k in tree))]


def inv_clip(params: Dict[str, Any]) -> SD:
    """Inverse of converter.convert_clip: {visual, text, logit_scale} (the JAX
    package's CLIPVisual and CLIPText parameter trees) -> an open_clip state
    dict (visual.conv1, visual.transformer.resblocks.N.*, token_embedding,
    transformer.resblocks.N.*, ln_final, text_projection, logit_scale)."""
    sd: SD = {}
    v = params["visual"]
    inv_conv(v["conv1"], "visual.conv1", sd)
    for name in ("class_embedding", "positional_embedding", "proj"):
        sd[f"visual.{name}"] = _np(v[name])
    inv_norm(v["ln_pre"], "visual.ln_pre", sd)
    inv_norm(v["ln_post"], "visual.ln_post", sd)
    for i, blk in enumerate(_blocks(v)):
        _inv_clip_block(blk, f"visual.transformer.resblocks.{i}", sd)
    t = params["text"]
    inv_embed(t["token_embedding"], "token_embedding", sd)
    sd["positional_embedding"] = _np(t["positional_embedding"])
    sd["text_projection"] = _np(t["text_projection"])
    inv_norm(t["ln_final"], "ln_final", sd)
    for i, blk in enumerate(_blocks(t)):
        _inv_clip_block(blk, f"transformer.resblocks.{i}", sd)
    sd["logit_scale"] = _np(params["logit_scale"])
    return sd


def export_lang_layers(params: Dict[str, Any], cfg) -> SD:
    """The in-encoder BERT layers (``transformer.use_extra_bert_layers``) of a
    hipie_tpu param tree, which ``export_hipie_checkpoint`` (like the JAX
    package's, and its converter) leaves out: encoder layer i's ``lang_layer``
    -> ``detr.detr.transformer.encoder.lang_layers.{i}.`` + Hugging Face
    BertLayer's own names (``attention.self.query``, ``attention.output.dense``,
    ``intermediate.dense``, ``output.LayerNorm``, ...), the port's module tree.
    The reference nests one BertLayer per encoder layer
    (deformable_transformer_dino.py:302-351), but no reference checkpoint or
    converter in this repository fixes the names of those weights; these are
    the port's choice. Empty without the option."""
    sd: SD = {}
    if not cfg.model.transformer.use_extra_bert_layers:
        return sd
    tr = params["detr"]["transformer"]
    steps = []
    while f"encoder_vl{len(steps)}" in tr:
        steps.append(tr[f"encoder_vl{len(steps)}"])
    if "encoder" in tr:
        steps += unstack_trees(tr["encoder"])
    for i, step in enumerate(steps):
        inv_bert_layer(step["lang_layer"], f"detr.detr.transformer.encoder.lang_layers.{i}", sd)
    return sd


def export_hipie_checkpoint(params: Dict[str, Any], cfg) -> SD:
    """Full hipie_tpu param tree -> reference-named torch-layout state_dict.

    `params` is the tree under "params" (i.e. model.init(...)["params"]).
    Mirrors utils/hipie_converter.convert_hipie_checkpoint exactly; any
    converter change must keep the round-trip test green.
    """
    sd: SD = {}
    mc = cfg.model
    tc = mc.transformer

    if "text_encoder" in params:
        inv_hf_bert(params["text_encoder"], "text_encoder.model.", sd)

    detr = params["detr"]
    d = "detr.detr"

    bb = f"{d}.backbone.0.backbone."
    if "backbone" in detr:
        bt = detr["backbone"]
        if "stem_conv1" in bt:
            inv_d2_resnet(bt, bb, sd)
        elif "patch_embed" in bt and "pos_embed" in bt:
            inv_vit(bt, bb, sd)
        elif "patch_norm" in bt:
            inv_swin(bt, bb, sd)
        elif "stem_conv" in bt:
            inv_convnext(bt, bb, sd)
        else:
            raise NotImplementedError(
                f"unrecognized backbone param tree: {sorted(bt)[:5]}")

    for i in range(tc.num_feature_levels):
        if f"input_proj_{i}" in detr:
            p = f"{d}.input_proj.{i}"
            inv_conv_gn(detr[f"input_proj_{i}"], f"{p}.0", f"{p}.1", sd)

    t = f"{d}.transformer"
    tr = detr["transformer"]
    sd[f"{t}.level_embed"] = _np(tr["level_embed"])
    sd[f"{t}.tgt_embed.weight"] = _np(tr["tgt_embed"])
    inv_linear(tr["enc_output"], f"{t}.enc_output", sd)
    inv_norm(tr["enc_output_norm"], f"{t}.enc_output_norm", sd)
    inv_linear(tr["resizer"]["fc"], f"{t}.resizer.fc", sd)
    inv_norm(tr["resizer"]["layer_norm"], f"{t}.resizer.layer_norm", sd)
    if "tgt_embed_bg" in tr:
        sd[f"{t}.tgt_embed_bg.weight"] = _np(tr["tgt_embed_bg"])
        sd[f"{t}.bg_query_refs.weight"] = _np(tr["bg_query_refs"])
    # unrolled VL-carrying head layers, then the scanned vision-only tail
    n_vl = 0
    while f"encoder_vl{n_vl}" in tr:
        step = tr[f"encoder_vl{n_vl}"]
        inv_enc_layer(step["layer"], f"{t}.encoder.layers.{n_vl}", sd)
        if "vl_layer" in step:
            inv_bi_attention(step["vl_layer"],
                             f"{t}.encoder.vl_layers.{n_vl}.b_attn", sd)
        n_vl += 1
    if "encoder" in tr:
        for i, step in enumerate(unstack_trees(tr["encoder"])):
            inv_enc_layer(step["layer"], f"{t}.encoder.layers.{n_vl + i}", sd)
            if "vl_layer" in step:
                inv_bi_attention(step["vl_layer"],
                                 f"{t}.encoder.vl_layers.{n_vl + i}.b_attn", sd)
    for i in range(tc.num_decoder_layers):
        inv_dec_layer(tr[f"dec_layers_{i}"], f"{t}.decoder.layers.{i}", sd)
        inv_mlp(tr[f"bbox_embed_{i}"], f"{d}.bbox_embed.{i}", sd)
    inv_mlp(tr["ref_point_head"], f"{t}.decoder.ref_point_head", sd)
    n_dec = tc.num_decoder_layers
    inv_mlp(tr["enc_bbox_embed"], f"{d}.bbox_embed.{n_dec}", sd)
    if "enc_class_embed" in tr:
        ec = tr["enc_class_embed"]
        if "body" in ec:                       # Still_Classifier
            inv_linear(ec["body"], f"{d}.class_embed.{n_dec}.body", sd)
        else:
            inv_vl_align(ec, f"{d}.class_embed.{n_dec}", sd)

    for i in range(tc.num_decoder_layers):
        if f"class_embed_{i}" in detr:
            inv_vl_align(detr[f"class_embed_{i}"], f"{d}.class_embed.{i}", sd)
        if f"iou_head_{i}" in detr:
            inv_linear(detr[f"iou_head_{i}"], f"{d}.iou_head.{i}", sd)

    inv_mlp(detr["controller"], "detr.controller", sd)
    for name, sub in detr["mask_head"].items():
        inv_conv(sub, f"detr.mask_head.{name}", sd)
    if "label_enc" in detr:
        inv_embed(detr["label_enc"], "detr.label_enc", sd)

    if "mask_dino" in detr:
        md = "detr.mask_dino"
        mdc = mc.maskdino
        pd = detr["mask_dino"]["pixel_decoder"]
        pix = f"{md}.pixel_decoder"
        if "level_embed" in pd:       # absent in shared-encoder mode
            sd[f"{pix}.transformer.level_embed"] = _np(pd["level_embed"])
        for i in range(4):
            if f"input_proj_{i}" in pd:
                p = f"{pix}.input_proj.{i}"
                inv_conv_gn(pd[f"input_proj_{i}"], f"{p}.0", f"{p}.1", sd)
        if "enc_layers" in pd:            # scanned stack (absent in shared-encoder mode)
            for i, step in enumerate(unstack_trees(pd["enc_layers"])):
                inv_enc_layer(step["layer"],
                              f"{pix}.transformer.encoder.layers.{i}", sd)
        if "adapter_1" in pd:
            inv_conv_gn(pd["adapter_1"], f"{pix}.adapter_1",
                        f"{pix}.adapter_1.norm", sd)
            inv_conv_gn(pd["layer_1"], f"{pix}.layer_1",
                        f"{pix}.layer_1.norm", sd)
        if "mask_features_up" in pd:
            inv_conv_transpose(pd["mask_features_up"], f"{pix}.mask_features.0", sd)
            inv_norm(pd["mask_features_gn"], f"{pix}.mask_features.1", sd)
            inv_conv(pd["mask_features_out"], f"{pix}.mask_features.3", sd)
        pr = detr["mask_dino"]["predictor"]
        pred = f"{md}.predictor"
        inv_linear(pr["class_embed"], f"{pred}.class_embed", sd)
        inv_mlp(pr["mask_embed"], f"{pred}.mask_embed", sd)
        inv_mlp(pr["bbox_embed"], f"{pred}._bbox_embed", sd)
        inv_norm(pr["decoder_norm"], f"{pred}.decoder_norm", sd)
        inv_linear(pr["enc_output"], f"{pred}.enc_output", sd)
        inv_norm(pr["enc_output_norm"], f"{pred}.enc_output_norm", sd)
        inv_mlp(pr["ref_point_head"], f"{pred}.decoder.ref_point_head", sd)
        if "resizer" in pr:           # seg-DN label encoding, built by training init
            inv_linear(pr["resizer"]["fc"], f"{pred}.resizer.fc", sd)
            inv_norm(pr["resizer"]["layer_norm"], f"{pred}.resizer.layer_norm", sd)
        for i in range(mdc.dec_layers):
            if f"dec_layers_{i}" in pr:
                inv_dec_layer(pr[f"dec_layers_{i}"],
                              f"{pred}.decoder.layers.{i}", sd)
        for i in range(mdc.dec_layers + 2):
            if f"mask_dino_cls_embed_{i}" in detr:
                inv_vl_align(detr[f"mask_dino_cls_embed_{i}"],
                             f"detr.mask_dino_cls_embed.{i}", sd)

    return sd
