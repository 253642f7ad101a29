"""MaskDINO "stuff" branch.

Counterpart of hipie_tpu/models/maskdino/model.py (reference
maskdino_encoder.py and maskdino_decoder.py). In shared-encoder mode
(``shared_encoder``, every preset) the pixel decoder reuses the main encoder's
stride-8/16/32 memory maps and adds a stride-64 level from res5; in its own
mode it projects res3/4/5 (1x1 conv + GroupNorm) and res5 again (stride-2 3x3
conv + GroupNorm) to four levels, adds a sine position embedding and a level
embedding, and runs ``enc_layers`` deformable encoder layers over them without
a padding mask (``transformer.encoder.layers.N``, ``transformer.level_embed``,
``input_proj.0..3``, as the reference names them). Both modes then take one FPN
step on res3 and make the stride-4 mask features. The decoder takes a
two-stage top-k over the class embedding, runs the MSDeformAttn decoder layers
with one shared box MLP, and predicts class embeddings and masks from the last
layer. In training (``emit_embeds``) it also returns the initial and per-layer
predictions, the two-stage ("interm") prediction, and mask EMBEDDINGS in place
of dense masks (the mask head is linear in the pixel features, so the
criterion builds masks only where it needs them); seg-DN queries go in front,
their content the resized pooled language feature (``resizer``, built with
``train=True``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from hipie_plain.config import MaskDINOConfig
from hipie_plain.layers import MLP, ConvGN, nchw_to_nhwc, nhwc_to_nchw, sine_position_embedding_2d
from hipie_plain.models.heads import FeatureResizer
from hipie_plain.models.transformer import (DeformableDecoderLayer, DeformableEncoderLayer,
                                            encoder_reference_points)
from hipie_plain.utils.misc import inverse_sigmoid, sine_position_embedding_1d

N_LEVELS = 4


class Conv2dNorm(nn.Conv2d):
    """detectron2-style Conv2d with a ``norm`` child (GroupNorm(32)), NHWC in/out."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int):
        super().__init__(in_channels, out_channels, kernel_size, padding=kernel_size // 2,
                         bias=False)
        self.norm = nn.GroupNorm(32, out_channels, eps=1e-5)

    def forward(self, x):
        return nchw_to_nhwc(self.norm(super().forward(nhwc_to_nchw(x))))


class _OwnEncoder(nn.Module):
    """The pixel decoder's deformable encoder (reference MSDeformAttnTransformerEncoderOnly)."""

    def __init__(self, c: MaskDINOConfig, msda_method: str = "fused"):
        super().__init__()
        self.level_embed = nn.Parameter(torch.randn(N_LEVELS, c.hidden_dim))
        self.encoder = nn.Module()
        self.encoder.layers = nn.ModuleList(
            DeformableEncoderLayer(c.hidden_dim, c.dim_feedforward, N_LEVELS, c.nheads, 4,
                                   msda_method)
            for _ in range(c.enc_layers))

    def forward(self, srcs: Sequence[torch.Tensor]) -> Sequence[torch.Tensor]:
        """srcs [s8, s16, s32, s64] NHWC -> the encoded maps in the same order."""
        b = srcs[0].shape[0]
        dev = srcs[0].device
        spatial_shapes = tuple((s.shape[1], s.shape[2]) for s in srcs)
        pos = [sine_position_embedding_2d(torch.zeros((b, h, w), dtype=torch.bool, device=dev),
                                          num_pos_feats=s.shape[-1] // 2).to(s.dtype)
               .reshape(b, h * w, -1) + self.level_embed[lvl].to(s.dtype)
               for lvl, (s, (h, w)) in enumerate(zip(srcs, spatial_shapes))]
        memory = torch.cat([s.reshape(b, -1, s.shape[-1]) for s in srcs], 1)
        pos = torch.cat(pos, 1)
        enc_ref = encoder_reference_points(spatial_shapes,
                                           torch.ones((b, N_LEVELS, 2), device=dev))
        for layer in self.encoder.layers:
            memory = layer(memory, pos, enc_ref, spatial_shapes, None)
        maps, start = [], 0
        for h, w in spatial_shapes:
            maps.append(memory[:, start:start + h * w].reshape(b, h, w, -1))
            start += h * w
        return maps


class MaskDINOPixelDecoder(nn.Module):
    def __init__(self, c: MaskDINOConfig, channels: Dict[str, int], msda_method: str = "fused"):
        super().__init__()
        self.shared_encoder = c.shared_encoder
        projs = {"3": ConvGN(channels["res5"], c.hidden_dim, 3, stride=2)}
        if not c.shared_encoder:
            projs.update({str(i): ConvGN(channels[n], c.hidden_dim, 1)
                          for i, n in enumerate(("res3", "res4", "res5"))})
            self.transformer = _OwnEncoder(c, msda_method)
        self.input_proj = nn.ModuleDict(dict(sorted(projs.items())))
        self.adapter_1 = Conv2dNorm(channels["res3"], c.hidden_dim, 1)
        self.layer_1 = Conv2dNorm(c.hidden_dim, c.hidden_dim, 3)
        self.mask_features = nn.Sequential(
            nn.ConvTranspose2d(c.hidden_dim, c.hidden_dim, 2, stride=2),
            nn.GroupNorm(32, c.hidden_dim, eps=1e-5), nn.ReLU(),
            nn.Conv2d(c.hidden_dim, c.mask_dim, 1))

    def forward(self, features: Dict[str, torch.Tensor],
                shared_memory_levels: Optional[Sequence] = None):
        """shared_memory_levels: [s8, s16, s32] NHWC maps of the main encoder
        (shared-encoder mode) or None (own mode). Returns (mask_features
        (B, H4, W4, mask_dim), [s64, s32, s16, s8] maps)."""
        s64 = self.input_proj["3"](features["res5"])
        if self.shared_encoder:
            level_maps = list(shared_memory_levels) + [s64]
        else:
            srcs = [self.input_proj[str(i)](features[n])
                    for i, n in enumerate(("res3", "res4", "res5"))]
            level_maps = self.transformer(srcs + [s64])
        s8 = level_maps[0]
        lateral = self.adapter_1(features["res3"])
        if s8.shape[1:3] != lateral.shape[1:3]:
            # jax.image.resize "bilinear" when upsampling == half-pixel bilinear
            s8 = nchw_to_nhwc(F.interpolate(nhwc_to_nchw(s8), size=lateral.shape[1:3],
                                            mode="bilinear", align_corners=False))
        y = F.relu(self.layer_1(lateral + s8))
        m = self.mask_features(nhwc_to_nchw(y))
        return nchw_to_nhwc(m), level_maps[::-1]


class MaskDINODecoderStack(nn.Module):
    def __init__(self, c: MaskDINOConfig, msda_method: str = "fused"):
        super().__init__()
        self.layers = nn.ModuleList(
            DeformableDecoderLayer(c.hidden_dim, c.dim_feedforward, N_LEVELS, c.nheads, 4,
                                   msda_method)
            for _ in range(c.dec_layers))
        self.ref_point_head = MLP(2 * c.hidden_dim, c.hidden_dim, c.hidden_dim, 2)


class MaskDINODecoder(nn.Module):
    def __init__(self, c: MaskDINOConfig, msda_method: str = "fused", train: bool = False,
                 lang_dim: int = 768):
        super().__init__()
        self.cfg = c
        if train:
            self.resizer = FeatureResizer(lang_dim, c.hidden_dim)
        self.class_embed = nn.Linear(c.hidden_dim, c.hidden_dim)
        self.mask_embed = MLP(c.hidden_dim, c.hidden_dim, c.mask_dim, 3)
        self._bbox_embed = MLP(c.hidden_dim, c.hidden_dim, 4, 3)
        self.decoder_norm = nn.LayerNorm(c.hidden_dim, eps=1e-5)
        self.enc_output = nn.Linear(c.hidden_dim, c.hidden_dim)
        self.enc_output_norm = nn.LayerNorm(c.hidden_dim, eps=1e-5)
        self.decoder = MaskDINODecoderStack(c, msda_method)

    def forward(self, level_maps: Sequence[torch.Tensor], mask_features: torch.Tensor,
                dn_refs_unact: Optional[torch.Tensor] = None,
                dn_valid: Optional[torch.Tensor] = None,
                self_attn_mask: Optional[torch.Tensor] = None,
                lang_pool: Optional[torch.Tensor] = None, emit_embeds: bool = False):
        """level_maps [s64, s32, s16, s8] NHWC; mask_features (B, H4, W4, mask_dim).
        Returns {pred_logits (B, Q, hidden) f32, pred_masks (B, Q, H4, W4) f32,
        pred_boxes (B, Q, 4) f32}. With ``emit_embeds`` (training): pred_mask_embed
        in place of pred_masks, "aux" (classes, mask_embeds, boxes of the initial
        and every layer but the last), "interm_outputs" and mask_features (f32).
        dn_refs_unact (B, pad, 4), dn_valid (B, pad), self_attn_mask and
        lang_pool (B, lang_dim) add the seg-DN queries."""
        c = self.cfg
        b = level_maps[0].shape[0]
        dev = level_maps[0].device
        spatial_shapes = tuple((m.shape[1], m.shape[2]) for m in level_maps)
        src_flat = torch.cat([m.reshape(b, -1, m.shape[-1]) for m in level_maps], 1)
        mf = mask_features.float()

        def predict(q):
            d = self.decoder_norm(q)
            emb = self.mask_embed(d).float()
            return self.class_embed(d).float(), (
                emb if emit_embeds else torch.einsum("bqc,bhwc->bqhw", emb, mf))

        props = []
        for lvl, (h, w) in enumerate(spatial_shapes):
            gy, gx = torch.meshgrid((torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h,
                                    (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w,
                                    indexing="ij")
            grid = torch.stack([gx, gy], -1).reshape(-1, 2)
            props.append(torch.cat([grid, torch.full_like(grid, 0.05 * (2.0 ** lvl))], -1))
        proposals = torch.cat(props, 0)[None].expand(b, -1, -1)
        prop_valid = ((proposals > 0.01) & (proposals < 0.99)).all(-1)
        safe = proposals.clamp(1e-6, 1 - 1e-6)
        proposals_unact = torch.where(prop_valid[..., None], torch.log(safe / (1 - safe)),
                                      torch.full_like(safe, 1e9))

        out_memory = src_flat.masked_fill(~prop_valid[..., None], 0.0)
        out_memory = self.enc_output_norm(self.enc_output(out_memory))
        enc_logits = self.class_embed(out_memory).float()
        enc_coords_unact = self._bbox_embed(out_memory).float() + proposals_unact
        scores = enc_logits.amax(-1).masked_fill(~prop_valid, torch.finfo(torch.float32).min)
        topk_idx = scores.topk(c.num_queries, dim=1).indices
        ref_unact = enc_coords_unact.gather(1, topk_idx[..., None].expand(-1, -1, 4))
        tgt_undetach = out_memory.gather(1, topk_idx[..., None].expand(-1, -1,
                                                                       out_memory.shape[-1]))
        refpoints_unact = ref_unact.detach()
        output = tgt_undetach.detach()

        classes, embeds, boxes = [], [], []
        if emit_embeds:
            interm_class, interm_embed = predict(tgt_undetach)
            interm = {"pred_logits": interm_class, "pred_boxes": ref_unact.sigmoid(),
                      "pred_mask_embed": interm_embed}
            if dn_refs_unact is not None:
                # seg-DN with the label encoding by language: every dn slot's
                # content is the resized pooled prompt, zero where the slot is unused
                le = self.resizer(lang_pool)
                dn_tgt = le[:, None, :].expand(b, dn_refs_unact.shape[1], le.shape[-1])
                if dn_valid is not None:
                    dn_tgt = dn_tgt.masked_fill(~dn_valid[..., None], 0.0)
                output = torch.cat([dn_tgt.to(output.dtype), output], 1)
                refpoints_unact = torch.cat([dn_refs_unact.float(), refpoints_unact], 1)
            if c.initial_pred:
                cls0, emb0 = predict(output)
                classes.append(cls0)
                embeds.append(emb0)
                boxes.append(refpoints_unact.sigmoid())
        reference_points = refpoints_unact.sigmoid()
        for layer in self.decoder.layers:
            ref_input = reference_points[:, :, None, :].expand(-1, -1, N_LEVELS, -1)
            query_sine = sine_position_embedding_1d(reference_points, num_feats=c.hidden_dim // 2)
            query_pos = self.decoder.ref_point_head(query_sine.to(output.dtype))
            output = layer(output, query_pos, ref_input, src_flat, spatial_shapes, None,
                           self_attn_mask)
            new_ref = (self._bbox_embed(output).float() + inverse_sigmoid(reference_points)
                       ).sigmoid()
            reference_points = new_ref.detach()
            if emit_embeds:
                boxes.append(new_ref)
                cls_l, emb_l = predict(output)
                classes.append(cls_l)
                embeds.append(emb_l)
        if not emit_embeds:
            logits, masks = predict(output)
            return {"pred_logits": logits, "pred_masks": masks, "pred_boxes": reference_points}
        return {"pred_logits": classes[-1], "pred_mask_embed": embeds[-1],
                "pred_boxes": boxes[-1],
                "aux": {"classes": classes[:-1], "mask_embeds": embeds[:-1],
                        "boxes": boxes[:-1]},
                "interm_outputs": interm, "mask_features": mf}


class MaskDINOHead(nn.Module):
    """Pixel decoder + decoder (reference meta_arch/maskdino_head.py)."""

    def __init__(self, c: MaskDINOConfig, channels: Dict[str, int], msda_method: str = "fused",
                 train: bool = False, lang_dim: int = 768):
        super().__init__()
        self.pixel_decoder = MaskDINOPixelDecoder(c, channels, msda_method)
        self.predictor = MaskDINODecoder(c, msda_method, train, lang_dim)

    def forward(self, features, shared_memory_levels=None, **train_kwargs):
        mask_features, level_maps = self.pixel_decoder(features, shared_memory_levels)
        return self.predictor(level_maps, mask_features, **train_kwargs)
