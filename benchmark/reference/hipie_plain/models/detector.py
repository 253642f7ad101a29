"""Detector: backbone -> input projections -> VL transformer -> heads ->
CondInst mask head -> MaskDINO stuff branch.

Counterpart of hipie_tpu/models/detector.py (reference ddetrs_dn.py and
deformable_detr.py). The module tree carries the reference's state_dict
names: ``detr.backbone.0.backbone``, ``detr.input_proj.N``,
``detr.transformer``, ``detr.bbox_embed.N``, ``detr.class_embed.N``,
``detr.iou_head.N`` under the outer ``detr``, beside ``controller``,
``mask_head``, ``label_enc``, ``mask_dino`` and ``mask_dino_cls_embed.N``. An
inference model builds only the heads that inference calls (the last decoder
layer's class and IoU heads, the encoder heads, the last MaskDINO class
projection), as the JAX package's inference ``init`` creates exactly those;
``train=True`` builds the rest, as its training ``init`` does: every layer's
class and IoU heads, the CDN label embedding ``label_enc``, every MaskDINO
class projection and MaskDINO's dn ``resizer``. ``msda_method`` ("fused" or
"flat4") reaches every MSDeformAttn: 6 encoder, 6 decoder and 9 MaskDINO
decoder layers in the presets, and 6 more in MaskDINO's own encoder where
``maskdino.shared_encoder`` is off (MaskDINO then takes the backbone's maps
alone, not the main encoder's).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from hipie_plain.config import ModelConfig
from hipie_plain.layers import MLP, ConvGN, sine_position_embedding_2d
from hipie_plain.models.backbone import build_backbone, masked_features
from hipie_plain.models.heads import StillClassifier, VLAlign, agg_lang_feat
from hipie_plain.models.mask_head import (MaskFeatureHead, dynamic_conv_param_sizes,
                                          dynamic_mask_with_coords)
from hipie_plain.models.maskdino.model import MaskDINOHead
from hipie_plain.models.transformer import VLDeformableTransformer


class _Joiner(nn.Module):
    """Holds the backbone under ``backbone``, as the reference's MaskedBackbone."""

    def __init__(self, backbone: nn.Module):
        super().__init__()
        self.backbone = backbone


class DeformableDETR(nn.Module):
    """The reference's ``detr.detr``: backbone, projections, transformer, heads."""

    def __init__(self, c: ModelConfig, msda_method: str = "fused", train: bool = False):
        super().__init__()
        tc = c.transformer
        backbone, chans = build_backbone(c.backbone)
        self.feature_channels = chans
        self.backbone = nn.ModuleList([_Joiner(backbone)])
        in_ch = [chans[n] for n in c.backbone.out_features]
        n_extra = tc.num_feature_levels - len(in_ch)
        projs = [ConvGN(ch, tc.d_model, 1) for ch in in_ch]
        projs += [ConvGN(in_ch[-1] if i == 0 else tc.d_model, tc.d_model, 3, stride=2)
                  for i in range(n_extra)]
        self.input_proj = nn.ModuleList(projs)
        self.transformer = VLDeformableTransformer(
            tc, lang_dim=c.text.hidden_size, msda_method=msda_method,
            lang_heads=c.text.num_heads, lang_intermediate=c.text.intermediate_size)
        n_dec = tc.num_decoder_layers
        self.bbox_embed = nn.ModuleList(MLP(tc.d_model, tc.d_model, 4, 3)
                                        for _ in range(n_dec + 1))
        layers = [str(i) for i in range(n_dec)] if train else [str(n_dec - 1)]
        enc_cls = (StillClassifier(tc.d_model) if c.still_cls_for_encoder
                   else VLAlign(c.text.hidden_size, tc.d_model))
        self.class_embed = nn.ModuleDict({**{i: VLAlign(c.text.hidden_size, tc.d_model)
                                             for i in layers}, str(n_dec): enc_cls})
        if c.use_iou_head:
            self.iou_head = nn.ModuleDict({i: nn.Linear(tc.d_model, 1) for i in layers})


class HIPIEDetector(nn.Module):
    def __init__(self, c: ModelConfig, msda_method: str = "fused", train: bool = False):
        super().__init__()
        if c.transformer.dropout != 0.0:
            raise NotImplementedError("transformer.dropout is not implemented")
        self.cfg = c
        self.train_heads = train
        tc = c.transformer
        self.detr = DeformableDETR(c, msda_method, train)
        mh = c.mask_head
        self.weight_nums, self.bias_nums = dynamic_conv_param_sizes(
            tc.d_model // 32, mh.dynamic_mask_channels, mh.num_dynamic_layers, mh.use_rel_coord)
        self.controller = MLP(tc.d_model, tc.d_model,
                              sum(self.weight_nums) + sum(self.bias_nums), 3)
        self.mask_head = MaskFeatureHead(tc.d_model)
        if train:
            # CDN label embedding (ddetrs_dn.py label_enc; DYNAMIC_LABEL_ENC off)
            self.label_enc = nn.Embedding(c.num_classes, tc.d_model)
        if c.maskdino.enabled:
            chans = self.detr.feature_channels
            self.mask_dino = MaskDINOHead(c.maskdino, chans, msda_method,
                                          train, c.text.hidden_size)
            n_cls = c.maskdino.dec_layers + 2
            self.mask_dino_cls_embed = nn.ModuleDict({
                str(i): VLAlign(c.text.hidden_size, c.maskdino.hidden_dim)
                for i in (range(n_cls) if train else [n_cls - 1])})

    def _project_levels(self, features, pad_mask):
        d = self.cfg.transformer.d_model
        levels = masked_features(features, pad_mask, num_pos_feats=d // 2)
        projs = self.detr.input_proj
        srcs = [projs[i](f) for i, (_, f, _, _) in enumerate(levels)]
        masks = [m for (_, _, m, _) in levels]
        dtype = srcs[0].dtype
        poses = [p.to(dtype) for (_, _, _, p) in levels]
        prev = levels[-1][1]
        for proj in list(projs)[len(levels):]:
            src = proj(prev)
            m = masks[-1][:, ::2, ::2][:, :src.shape[1], :src.shape[2]]
            srcs.append(src)
            masks.append(m)
            poses.append(sine_position_embedding_2d(m, num_pos_feats=d // 2).to(dtype))
            prev = src
        return srcs, masks, poses

    def forward(self, images, pad_mask, lang_hidden, lang_masks, image_sizes,
                task: str = "detection", train: bool = False,
                dn_labels: Optional[torch.Tensor] = None,
                dn_valid: Optional[torch.Tensor] = None,
                dn_refs_unact: Optional[torch.Tensor] = None,
                self_attn_mask: Optional[torch.Tensor] = None,
                maskdino_dn_refs: Optional[torch.Tensor] = None,
                maskdino_dn_valid: Optional[torch.Tensor] = None,
                maskdino_attn_mask: Optional[torch.Tensor] = None,
                drop_path_masks: Optional[torch.Tensor] = None,
                bg_lang_weights: Optional[torch.Tensor] = None) -> Dict[str, Any]:
        """images (B, H, W, 3) normalised NHWC; pad_mask (B, H, W) True = pad;
        lang_hidden (B, L, lang_dim); lang_masks (B, L); image_sizes (B, 2) (h, w);
        task "detection" (class logits per token) or "grounding" (one logit
        against the pooled expression).

        ``train=True`` (a model built with ``train=True``) returns the training
        outputs instead of the inference ones: every layer's class logits
        ("outputs_class"), IoU logits ("outputs_iou"), controller parameters
        ("ctrl_params", f32) and input references ("layer_refs"), and
        MaskDINO's training outputs with every prediction projected against the
        prompt. The CDN arguments (from hipie_plain.models.dn.prepare_cdn) put
        the noised queries in front of both decoders' queries. ``bg_lang_weights``
        (K, B, L) in training (``hipie_plain.train.bg_lang``) or (K, L) at
        inference (a stuff class's token weights a row) adds K language-derived
        bg queries after the dn slots (see models/transformer.py). ``drop_path_masks``
        (a ViT backbone's ``draw_drop_masks``) turns on its drop path; training
        only, as JAX's ``backbone(images, deterministic=not train)``."""
        c = self.cfg
        detr = self.detr
        if train and not self.train_heads:
            raise ValueError("HIPIEDetector: train=True needs a model built with train=True")
        backbone = detr.backbone[0].backbone
        if drop_path_masks is None:
            features = backbone(images)
        elif train:
            features = backbone(images, drop_masks=drop_path_masks)
        else:
            raise ValueError("HIPIEDetector: drop_path_masks are for train=True")
        srcs, masks, poses = self._project_levels(features, pad_mask)
        n_dec = c.transformer.num_decoder_layers
        dn_tgt = None
        if dn_labels is not None:
            dn_tgt = self.label_enc(dn_labels)
            if dn_valid is not None:
                dn_tgt = dn_tgt.masked_fill(~dn_valid[..., None], 0.0)
        t = detr.transformer(srcs, masks, poses, lang_hidden, lang_masks,
                             enc_class_head=detr.class_embed[str(n_dec)],
                             enc_bbox_head=detr.bbox_embed[n_dec],
                             bbox_heads=detr.bbox_embed[:n_dec], task=task, dn_tgt=dn_tgt,
                             dn_refs_unact=dn_refs_unact, self_attn_mask=self_attn_mask,
                             bg_lang_weights=bg_lang_weights)
        hs = t["hs"]
        l_hidden = t["lang_hidden"]
        if task == "grounding":
            lang_for_cls = agg_lang_feat(l_hidden, lang_masks)[:, None, :]
        else:
            lang_for_cls = l_hidden
        outputs: Dict[str, Any] = {
            "outputs_coord": t["outputs_coord"],
            "enc_outputs_class": t["enc_outputs_class"],
            "enc_outputs_coord_unact": t["enc_outputs_coord_unact"],
            "spatial_shapes": t["spatial_shapes"],
            "lang_hidden": l_hidden,
            "memory": t["memory"],
        }
        if train:
            outputs["outputs_class"] = torch.stack(
                [detr.class_embed[str(i)](hs[i], lang_for_cls) for i in range(n_dec)])
            if c.use_iou_head:
                outputs["outputs_iou"] = torch.stack(
                    [detr.iou_head[str(i)](hs[i]).float() for i in range(n_dec)])
            outputs["ctrl_params"] = torch.stack(
                [self.controller(hs[i]).float() for i in range(n_dec)])
            outputs["layer_refs"] = torch.cat([t["init_reference"][None],
                                               t["inter_references"][:-1]])
        else:
            last = str(n_dec - 1)
            outputs["pred_logits"] = detr.class_embed[last](hs[-1], lang_for_cls)
            outputs["pred_boxes"] = t["outputs_coord"][-1]
            if c.use_iou_head:
                outputs["pred_boxious"] = detr.iou_head[last](hs[-1]).float()

        # mask features from the first three encoder levels
        b = t["memory"].shape[0]
        mem_maps, start = [], 0
        for (h, w) in t["spatial_shapes"][:3]:
            mem_maps.append(t["memory"][:, start:start + h * w].reshape(b, h, w, -1))
            start += h * w
        _, mask_feats = self.mask_head(mem_maps)
        outputs["mask_feats"] = mask_feats
        if not train:
            ctrl = self.controller(hs[-1])
            # the last layer's input references (JAX's [-2] clamps to 0 at one layer)
            refs = t["inter_references"]
            ref2 = refs[max(refs.shape[0] - 2, 0)][..., :2]
            scale = torch.stack([image_sizes[:, 1], image_sizes[:, 0]], -1).float()
            outputs["pred_masks"] = dynamic_mask_with_coords(
                mask_feats, ref2 * scale[:, None, :], ctrl, self.weight_nums, self.bias_nums,
                c.mask_head.dynamic_mask_channels, mask_feat_stride=8,
                mask_out_stride=c.mask_head.mask_out_stride, rel_coord=c.mask_head.use_rel_coord)
        outputs["hs"] = hs
        outputs["inter_references"] = t["inter_references"]
        outputs["init_reference"] = t["init_reference"]

        if c.maskdino.enabled:
            n_cls = c.maskdino.dec_layers + 2
            cls_heads = self.mask_dino_cls_embed
            if not c.maskdino.shared_encoder:
                mem_maps = None            # MaskDINO runs its own encoder
            if not train:
                md = self.mask_dino(features, shared_memory_levels=mem_maps)
                md["pred_logits"] = cls_heads[str(n_cls - 1)](md["pred_logits"].to(hs.dtype),
                                                             lang_for_cls)
            else:
                md = self.mask_dino(features, shared_memory_levels=mem_maps,
                                    dn_refs_unact=maskdino_dn_refs, dn_valid=maskdino_dn_valid,
                                    self_attn_mask=maskdino_attn_mask,
                                    lang_pool=agg_lang_feat(l_hidden, lang_masks),
                                    emit_embeds=True)
                md["pred_logits"] = cls_heads[str(n_cls - 1)](md["pred_logits"], lang_for_cls)
                md["aux"]["classes"] = [cls_heads[str(i)](x, lang_for_cls)
                                        for i, x in enumerate(md["aux"]["classes"])]
                # the two-stage ("interm") head takes the second-to-last projection
                interm = md["interm_outputs"]
                interm["pred_logits"] = cls_heads[str(n_cls - 2)](interm["pred_logits"],
                                                                 lang_for_cls)
            outputs["maskdino"] = md
        return outputs
