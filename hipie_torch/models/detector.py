"""Detector, inference branch: backbone -> input projections -> VL transformer ->
heads -> CondInst mask head -> MaskDINO stuff branch.

Counterpart of hipie_tpu/models/detector.py (reference ddetrs_dn.py and
deformable_detr.py). The module tree carries the reference's state_dict
names: ``detr.backbone.0.backbone``, ``detr.input_proj.N``,
``detr.transformer``, ``detr.bbox_embed.N``, ``detr.class_embed.N``,
``detr.iou_head.N`` under the outer ``detr``, beside ``controller``,
``mask_head``, ``mask_dino`` and ``mask_dino_cls_embed.N``. Only the heads that
inference calls are built: the last decoder layer's class and IoU heads, the
encoder heads, and the last MaskDINO class projection, as the JAX package's
inference ``init`` creates exactly those. ``msda_method`` ("fused" or "flat4")
reaches every MSDeformAttn: 6 encoder, 6 decoder and 9 MaskDINO decoder layers
in the presets.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn as nn

from hipie_torch.config import ModelConfig
from hipie_torch.layers import MLP, ConvGN, sine_position_embedding_2d
from hipie_torch.models.backbone import build_backbone, masked_features
from hipie_torch.models.heads import StillClassifier, VLAlign, agg_lang_feat
from hipie_torch.models.mask_head import (MaskFeatureHead, dynamic_conv_param_sizes,
                                          dynamic_mask_with_coords)
from hipie_torch.models.maskdino.model import MaskDINOHead
from hipie_torch.models.transformer import VLDeformableTransformer


class _Joiner(nn.Module):
    """Holds the backbone under ``backbone``, as the reference's MaskedBackbone."""

    def __init__(self, backbone: nn.Module):
        super().__init__()
        self.backbone = backbone


class DeformableDETR(nn.Module):
    """The reference's ``detr.detr``: backbone, projections, transformer, heads."""

    def __init__(self, c: ModelConfig, msda_method: str = "fused"):
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
        self.transformer = VLDeformableTransformer(tc, lang_dim=c.text.hidden_size,
                                                   msda_method=msda_method)
        n_dec = tc.num_decoder_layers
        self.bbox_embed = nn.ModuleList(MLP(tc.d_model, tc.d_model, 4, 3)
                                        for _ in range(n_dec + 1))
        last = str(n_dec - 1)
        enc_cls = (StillClassifier(tc.d_model) if c.still_cls_for_encoder
                   else VLAlign(c.text.hidden_size, tc.d_model))
        self.class_embed = nn.ModuleDict({last: VLAlign(c.text.hidden_size, tc.d_model),
                                          str(n_dec): enc_cls})
        if c.use_iou_head:
            self.iou_head = nn.ModuleDict({last: nn.Linear(tc.d_model, 1)})


class HIPIEDetector(nn.Module):
    def __init__(self, c: ModelConfig, msda_method: str = "fused"):
        super().__init__()
        if c.transformer.dropout != 0.0:
            raise NotImplementedError("transformer.dropout is not implemented")
        self.cfg = c
        tc = c.transformer
        self.detr = DeformableDETR(c, msda_method)
        mh = c.mask_head
        self.weight_nums, self.bias_nums = dynamic_conv_param_sizes(
            tc.d_model // 32, mh.dynamic_mask_channels, mh.num_dynamic_layers, mh.use_rel_coord)
        self.controller = MLP(tc.d_model, tc.d_model,
                              sum(self.weight_nums) + sum(self.bias_nums), 3)
        self.mask_head = MaskFeatureHead(tc.d_model)
        if c.maskdino.enabled:
            chans = self.detr.feature_channels
            self.mask_dino = MaskDINOHead(c.maskdino, chans["res3"], chans["res5"], msda_method)
            self.mask_dino_cls_embed = nn.ModuleDict({
                str(c.maskdino.dec_layers + 1): VLAlign(c.text.hidden_size,
                                                        c.maskdino.hidden_dim)})

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
                task: str = "detection") -> Dict[str, Any]:
        """images (B, H, W, 3) normalised NHWC; pad_mask (B, H, W) True = pad;
        lang_hidden (B, L, lang_dim); lang_masks (B, L); image_sizes (B, 2) (h, w);
        task "detection" (class logits per token) or "grounding" (one logit
        against the pooled expression)."""
        c = self.cfg
        detr = self.detr
        features = detr.backbone[0].backbone(images)
        srcs, masks, poses = self._project_levels(features, pad_mask)
        n_dec = c.transformer.num_decoder_layers
        t = detr.transformer(srcs, masks, poses, lang_hidden, lang_masks,
                             enc_class_head=detr.class_embed[str(n_dec)],
                             enc_bbox_head=detr.bbox_embed[n_dec],
                             bbox_heads=detr.bbox_embed[:n_dec], task=task)
        hs = t["hs"]
        l_hidden = t["lang_hidden"]
        if task == "grounding":
            lang_for_cls = agg_lang_feat(l_hidden, lang_masks)[:, None, :]
        else:
            lang_for_cls = l_hidden
        last = str(n_dec - 1)
        outputs: Dict[str, Any] = {
            "outputs_coord": t["outputs_coord"],
            "enc_outputs_class": t["enc_outputs_class"],
            "enc_outputs_coord_unact": t["enc_outputs_coord_unact"],
            "spatial_shapes": t["spatial_shapes"],
            "lang_hidden": l_hidden,
            "memory": t["memory"],
            "pred_logits": detr.class_embed[last](hs[-1], lang_for_cls),
            "pred_boxes": t["outputs_coord"][-1],
        }
        if c.use_iou_head:
            outputs["pred_boxious"] = detr.iou_head[last](hs[-1]).float()

        # mask features from the first three encoder levels
        b = t["memory"].shape[0]
        mem_maps, start = [], 0
        for (h, w) in t["spatial_shapes"][:3]:
            mem_maps.append(t["memory"][:, start:start + h * w].reshape(b, h, w, -1))
            start += h * w
        _, mask_feats = self.mask_head(mem_maps)
        ctrl = self.controller(hs[-1])
        ref2 = t["inter_references"][-2][..., :2]
        scale = torch.stack([image_sizes[:, 1], image_sizes[:, 0]], -1).float()
        outputs["pred_masks"] = dynamic_mask_with_coords(
            mask_feats, ref2 * scale[:, None, :], ctrl, self.weight_nums, self.bias_nums,
            c.mask_head.dynamic_mask_channels, mask_feat_stride=8,
            mask_out_stride=c.mask_head.mask_out_stride, rel_coord=c.mask_head.use_rel_coord)
        outputs["hs"] = hs
        outputs["inter_references"] = t["inter_references"]
        outputs["init_reference"] = t["init_reference"]

        if c.maskdino.enabled:
            md = self.mask_dino(features, shared_memory_levels=mem_maps)
            cls_head = self.mask_dino_cls_embed[str(c.maskdino.dec_layers + 1)]
            md["pred_logits"] = cls_head(md["pred_logits"].to(hs.dtype), lang_for_cls)
            outputs["maskdino"] = md
        return outputs
