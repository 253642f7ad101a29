"""Backbone construction and per-level masks and position embeddings.

The port's dispatch for the backbones the benchmark runs: every name that
starts with "resnet" (``"resnet_tiny"`` too) builds a ResNet of
``resnet_depth``; a ``VIT_VARIANTS`` name a ViTDet. Any other name (the port's
Swin and ConvNeXt, which no cell runs) raises.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from hipie_plain.config import BackboneConfig
from hipie_plain.layers import sine_position_embedding_2d
from hipie_plain.models.backbone.resnet import ResNet, resnet_feature_channels
from hipie_plain.models.backbone.vit import VIT_VARIANTS, ViTDet, vit_feature_channels


def build_backbone(cfg: BackboneConfig) -> Tuple[nn.Module, Dict[str, int]]:
    """Returns (module mapping an NHWC image -> {resN: NHWC map}, {resN: channels})."""
    name = cfg.name
    if name.startswith("resnet"):
        mod = ResNet(depth=cfg.resnet_depth, out_features=cfg.out_features,
                     freeze_at=cfg.frozen_stages + 1)
        chans = resnet_feature_channels(cfg.resnet_depth)
    elif name in VIT_VARIANTS:
        embed_dim, depth, num_heads, drop_path = VIT_VARIANTS[name]
        mod = ViTDet(img_size=cfg.vit_img_size, patch_size=cfg.vit_patch_size,
                     embed_dim=embed_dim, depth=depth, num_heads=num_heads,
                     drop_path_rate=drop_path, window_size=cfg.vit_window_size,
                     use_rel_pos=cfg.vit_use_rel_pos, out_features=cfg.out_features,
                     remat=cfg.vit_remat)
        chans = vit_feature_channels(embed_dim)
    else:
        raise ValueError(f"unknown backbone {name}")
    return mod, {k: v for k, v in chans.items() if k in cfg.out_features}


FEATURE_STRIDES = {"res2": 4, "res3": 8, "res4": 16, "res5": 32, "res6": 64}


def masked_features(features: Dict[str, torch.Tensor], pad_mask: torch.Tensor,
                    num_pos_feats: int = 128
                    ) -> List[Tuple[str, torch.Tensor, torch.Tensor, torch.Tensor]]:
    """[(name, feat NHWC, mask (B,h,w), pos (B,h,w,2*num_pos_feats))] by stride.

    pad_mask: (B, H, W) bool, True = padding; per-level masks by strided slicing.
    """
    out = []
    for name in sorted(features, key=lambda n: FEATURE_STRIDES[n]):
        feat = features[name]
        stride = FEATURE_STRIDES[name]
        h, w = feat.shape[1], feat.shape[2]
        m = pad_mask[:, ::stride, ::stride][:, :h, :w]
        if m.shape[1] < h or m.shape[2] < w:
            m = F.pad(m, (0, w - m.shape[2], 0, h - m.shape[1]), value=True)
        pos = sine_position_embedding_2d(m, num_pos_feats=num_pos_feats)
        out.append((name, feat, m, pos))
    return out
