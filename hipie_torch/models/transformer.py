"""Vision-language deformable transformer (DINO variant).

Counterpart of hipie_tpu/models/transformer.py (reference
deformable_transformer_dino.py): encoder of [VL bi-attention ->] MSDeformAttn
layers with grid-centre reference points [-> a BERT layer on the text
features]; two-stage top-k proposals over the encoder class head; query layout
[dn | bg_lang | bg | fg] with CDN queries in training, language-derived bg
queries and learned bg queries; decoupled or language-pooled content queries;
decoder with iterative box refinement and look-forward-twice, the refinement
chain detached between layers.

Module names follow the reference's state_dict (encoder.layers.N,
encoder.vl_layers.N.b_attn, encoder.lang_layers.N, decoder.layers.N,
decoder.ref_point_head). The box heads and the encoder class head live in the
detector (detr.bbox_embed, detr.class_embed) as in the reference, and are
passed in. ``msda_method`` ("fused" or "flat4") goes to every MSDeformAttn.
``remat`` (JAX's ``nn.remat`` of the encoder and decoder layers) runs each
encoder layer, with its bi-attention and BERT layer, and each decoder layer
under ``torch.utils.checkpoint`` while grad is enabled.

Branches, as in JAX:
  * ``use_extra_bert_layers``: after each encoder layer's MSDeformAttn, a BERT
    layer (geometry of ``cfg.text``: ``lang_heads``, ``lang_intermediate``)
    runs on the text features with a -1e9 bias on padded tokens
    (``encoder.lang_layers.N``; ``hipie_torch.utils.export.export_lang_layers``
    names their weights).
  * ``bg_lang_weights``: language-derived bg queries, the RAW (pre-fusion)
    ``lang_hidden`` pooled by these weights and passed through the same
    ``resizer`` as the pooled-language content: (K, B, L) in training gives one
    query set shared across the batch (under data parallelism the global
    batch: the ranks' pools are summed), (K, L) at inference one per image.
    They take zero-box references.
  * ``decouple_tgt=False``: the last ``num_queries`` slots take the resized
    pooled language feature as content; the dn, bg_lang and bg slots keep
    theirs.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from hipie_torch.config import TransformerConfig
from hipie_torch.layers import MLP, MultiHeadAttention, maybe_checkpoint
from hipie_torch.models.fusion import BiAttentionBlock
from hipie_torch.models.heads import FeatureResizer, agg_lang_feat
from hipie_torch.models.msda_module import MSDeformAttn
from hipie_torch.models.text.bert import BertLayer
from hipie_torch.parallel.mesh import global_sum
from hipie_torch.parallel.tensor import (TPLayout, ffn, gather_tokens_replicated, split_tokens,
                                         token_shards)
from hipie_torch.utils.misc import get_valid_ratio, inverse_sigmoid, sine_position_embedding_1d
from hipie_torch.utils.trace import count

Shapes = Tuple[Tuple[int, int], ...]

# the deformable layers' FFN under tensor parallelism: linear1 column-, linear2
# row-parallel
FFN_LAYOUT = TPLayout({"linear1": 1}, ("linear2",))


def encoder_reference_points(spatial_shapes: Shapes, valid_ratios: torch.Tensor) -> torch.Tensor:
    """Grid-centre reference points, valid_ratios (B, L, 2) -> (B, S, L, 2)."""
    dev = valid_ratios.device
    points = []
    for lvl, (h, w) in enumerate(spatial_shapes):
        ry, rx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev) + 0.5,
                                torch.arange(w, dtype=torch.float32, device=dev) + 0.5,
                                indexing="ij")
        ry = ry.reshape(-1)[None] / (valid_ratios[:, None, lvl, 1] * h)
        rx = rx.reshape(-1)[None] / (valid_ratios[:, None, lvl, 0] * w)
        points.append(torch.stack([rx, ry], dim=-1))
    ref = torch.cat(points, dim=1)
    return ref[:, :, None, :] * valid_ratios[:, None, :, :]


class DeformableEncoderLayer(nn.Module):
    tp = 1

    def __init__(self, d_model: int, d_ffn: int, n_levels: int, n_heads: int, n_points: int,
                 msda_method: str = "fused"):
        super().__init__()
        self.self_attn = MSDeformAttn(d_model, n_levels, n_heads, n_points, msda_method)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.linear1 = nn.Linear(d_model, d_ffn)
        self.linear2 = nn.Linear(d_ffn, d_model)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.tp_layout = FFN_LAYOUT

    def forward(self, src, pos, reference_points, spatial_shapes, padding_mask, tokens=None):
        """src, pos (B, S, C) (the rank's share under ``tokens``), with its
        reference points and pad mask."""
        src2 = self.self_attn(src + pos, reference_points, src, spatial_shapes, padding_mask,
                              tokens)
        src = self.norm1(src + src2)
        return self.norm2(src + ffn(self.linear1, self.linear2, src, self.tp, tokens))

    def token_local_parameters(self):
        """The parameters that see only the rank's tokens under SP."""
        out = (list(self.self_attn.parameters()) + list(self.norm1.parameters())
               + list(self.norm2.parameters()))
        if self.tp > 1:
            return out + [self.linear2.bias]
        return out + list(self.linear1.parameters()) + list(self.linear2.parameters())


class DeformableDecoderLayer(nn.Module):
    tp = 1

    def __init__(self, d_model: int, d_ffn: int, n_levels: int, n_heads: int, n_points: int,
                 msda_method: str = "fused"):
        super().__init__()
        self.cross_attn = MSDeformAttn(d_model, n_levels, n_heads, n_points, msda_method)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.self_attn = MultiHeadAttention(d_model, n_heads)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.linear1 = nn.Linear(d_model, d_ffn)
        self.linear2 = nn.Linear(d_ffn, d_model)
        self.norm3 = nn.LayerNorm(d_model, eps=1e-5)
        self.tp_layout = FFN_LAYOUT

    def forward(self, tgt, query_pos, reference_points, src, spatial_shapes, src_padding_mask,
                self_attn_mask=None):
        q = tgt + query_pos
        tgt = self.norm2(tgt + self.self_attn(q, q, tgt, attn_mask=self_attn_mask))
        tgt2 = self.cross_attn(tgt + query_pos, reference_points, src, spatial_shapes,
                               src_padding_mask)
        tgt = self.norm1(tgt + tgt2)
        return self.norm3(tgt + ffn(self.linear1, self.linear2, tgt, self.tp))


class _VLLayer(nn.Module):
    """Holds one encoder layer's bi-attention under ``b_attn`` (reference VLFuse)."""

    def __init__(self, block: BiAttentionBlock):
        super().__init__()
        self.b_attn = block


class VLEncoder(nn.Module):
    SHARDS_TOKENS = True            # the encoder shard_tokens splits (not MaskDINO's own)

    def __init__(self, c: TransformerConfig, lang_dim: int, msda_method: str = "fused",
                 lang_heads: int = 12, lang_intermediate: int = 3072):
        super().__init__()
        self.remat = c.remat
        n_vl = min(c.num_vl_layers, c.num_encoder_layers) if c.use_vl_fusion else 0
        self.layers = nn.ModuleList(
            DeformableEncoderLayer(c.d_model, c.dim_feedforward, c.num_feature_levels,
                                   c.nhead, c.enc_n_points, msda_method)
            for _ in range(c.num_encoder_layers))
        self.vl_layers = nn.ModuleList(
            _VLLayer(BiAttentionBlock(c.d_model, lang_dim, c.vl_hidden_dim, c.vl_nheads,
                                      init_gamma=1.0 / c.num_encoder_layers))
            for _ in range(n_vl))
        if c.use_extra_bert_layers:
            self.lang_layers = nn.ModuleList(BertLayer(lang_dim, lang_heads, lang_intermediate)
                                             for _ in range(c.num_encoder_layers))
        else:
            self.lang_layers = None

    def forward(self, memory, l_hidden, pos, enc_ref, spatial_shapes, mask_flat, lang_masks,
                tokens=None):
        """memory, pos, enc_ref and mask_flat hold the rank's share of the
        tokens under ``tokens`` (sequence parallelism)."""
        lang_bias = None
        if self.lang_layers is not None:
            lang_bias = torch.where(lang_masks[:, None, None, :] > 0,
                                    torch.zeros((), device=memory.device), -1e9)
        for i, layer in enumerate(self.layers):
            vl = self.vl_layers[i].b_attn if i < len(self.vl_layers) else None
            lang = self.lang_layers[i] if self.lang_layers is not None else None
            if vl is None and lang is None:
                memory = maybe_checkpoint(self.remat, layer, memory, pos, enc_ref, spatial_shapes,
                                          mask_flat, tokens)
                continue

            def step(memory, l_hidden, layer=layer, vl=vl, lang=lang):
                if vl is not None:
                    memory, l_hidden = vl(memory, l_hidden, lang_masks, tokens)
                memory = layer(memory, pos, enc_ref, spatial_shapes, mask_flat, tokens)
                if lang is not None:
                    l_hidden = lang(l_hidden, lang_bias)
                return memory, l_hidden

            memory, l_hidden = maybe_checkpoint(self.remat, step, memory, l_hidden)
        return memory, l_hidden

    def token_local_parameters(self):
        """The parameters that see only the rank's tokens under SP."""
        return ([p for layer in self.layers for p in layer.token_local_parameters()]
                + [p for vl in self.vl_layers for p in vl.b_attn.token_local_parameters()])


class DINODecoder(nn.Module):
    def __init__(self, c: TransformerConfig, msda_method: str = "fused"):
        super().__init__()
        self.layers = nn.ModuleList(
            DeformableDecoderLayer(c.d_model, c.dim_feedforward, c.num_feature_levels,
                                   c.nhead, c.dec_n_points, msda_method)
            for _ in range(c.num_decoder_layers))
        # input: sine embedding of the 4 box coordinates, d_model / 2 features each
        self.ref_point_head = MLP(2 * c.d_model, c.d_model, c.d_model, 2)


def two_stage_proposals(spatial_shapes: Shapes, valid_ratios, mask_flat):
    """Per-token proposal boxes (grid centres, wh = 0.05 * 2^lvl) in logit space.

    Returns (proposals_unact (B, S, 4) f32 with 1e9 at invalid tokens, valid (B, S)).
    """
    dev = valid_ratios.device
    props = []
    count("host_sync.proposal_wh", len(spatial_shapes))    # a blocking copy a level
    for lvl, (h, w) in enumerate(spatial_shapes):
        gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev) + 0.5,
                                torch.arange(w, dtype=torch.float32, device=dev) + 0.5,
                                indexing="ij")
        grid = torch.stack([gx, gy], -1).reshape(-1, 2)
        valid_wh = valid_ratios[:, lvl] * torch.tensor([w, h], dtype=torch.float32, device=dev)
        grid = grid[None] / valid_wh[:, None, :]
        props.append(torch.cat([grid, torch.full_like(grid, 0.05 * (2.0 ** lvl))], -1))
    proposals = torch.cat(props, 1)
    valid = ((proposals > 0.01) & (proposals < 0.99)).all(-1) & ~mask_flat
    safe = proposals.clamp(1e-6, 1.0 - 1e-6)
    unact = torch.where(valid[..., None], torch.log(safe / (1.0 - safe)),
                        torch.full_like(safe, 1e9))
    return unact, valid


class VLDeformableTransformer(nn.Module):
    """Encoder + two-stage selection + decoder."""

    def __init__(self, c: TransformerConfig, lang_dim: int = 768, msda_method: str = "fused",
                 lang_heads: int = 12, lang_intermediate: int = 3072):
        super().__init__()
        self.cfg = c
        self.level_embed = nn.Parameter(torch.randn(c.num_feature_levels, c.d_model))
        self.encoder = VLEncoder(c, lang_dim, msda_method, lang_heads, lang_intermediate)
        self.decoder = DINODecoder(c, msda_method)
        # pooled language -> query content (grounding without still_tgt_for_both,
        # decouple_tgt=False), and raw tokens -> language-derived bg queries
        self.resizer = FeatureResizer(lang_dim, c.d_model)
        self.enc_output = nn.Linear(c.d_model, c.d_model)
        self.enc_output_norm = nn.LayerNorm(c.d_model, eps=1e-5)
        self.tgt_embed = nn.Embedding(c.num_queries, c.d_model)
        nn.init.normal_(self.tgt_embed.weight)
        if c.num_bg_queries > 0:
            self.tgt_embed_bg = nn.Embedding(c.num_bg_queries, c.d_model)
            self.bg_query_refs = nn.Embedding(c.num_bg_queries, 4)

    def forward(self, srcs: Sequence[torch.Tensor], masks: Sequence[torch.Tensor],
                pos_embeds: Sequence[torch.Tensor], lang_hidden, lang_masks,
                enc_class_head: nn.Module, enc_bbox_head: nn.Module,
                bbox_heads: Sequence[nn.Module], task: str = "detection",
                dn_tgt: Optional[torch.Tensor] = None,
                dn_refs_unact: Optional[torch.Tensor] = None,
                self_attn_mask: Optional[torch.Tensor] = None,
                bg_lang_weights: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """srcs/pos_embeds per level (B, H, W, C), masks (B, H, W) True = pad;
        lang_hidden (B, L, lang_dim), lang_masks (B, L) 1 = valid; task
        "detection" or "grounding". Training passes the CDN queries: dn_tgt
        (B, pad, C) content, dn_refs_unact (B, pad, 4) pre-sigmoid boxes, put in
        front of the queries, and self_attn_mask (Q_total, Q_total) True =
        blocked. ``bg_lang_weights`` (K, B, L) in training or (K, L) at
        inference adds K language-derived bg queries after the dn slots."""
        c = self.cfg
        b = srcs[0].shape[0]
        dtype = self.level_embed.dtype
        spatial_shapes: Shapes = tuple((s.shape[1], s.shape[2]) for s in srcs)
        src_flat, mask_flat, pos_flat, valid_ratios = [], [], [], []
        for lvl, (src, mask, pos) in enumerate(zip(srcs, masks, pos_embeds)):
            h, w = src.shape[1], src.shape[2]
            src_flat.append(src.reshape(b, h * w, -1))
            mask_flat.append(mask.reshape(b, h * w))
            pos_flat.append(pos.reshape(b, h * w, -1) + self.level_embed[lvl])
            valid_ratios.append(get_valid_ratio(mask))
        src_flat = torch.cat(src_flat, 1).to(dtype)
        mask_flat = torch.cat(mask_flat, 1)
        pos_flat = torch.cat(pos_flat, 1).to(dtype)
        valid_ratios = torch.stack(valid_ratios, 1)

        enc_ref = encoder_reference_points(spatial_shapes, valid_ratios)
        # sequence parallelism: the encoder on this rank's share of the tokens
        tokens = token_shards(src_flat.shape[1]) if c.shard_tokens else None
        if tokens is None:
            memory, l_hidden = self.encoder(src_flat, lang_hidden.to(dtype), pos_flat, enc_ref,
                                            spatial_shapes, mask_flat, lang_masks)
        else:
            memory, l_hidden = self.encoder(
                split_tokens(src_flat, tokens), lang_hidden.to(dtype),
                split_tokens(pos_flat, tokens), tokens.local(enc_ref), spatial_shapes,
                tokens.local(mask_flat), lang_masks, tokens)
            memory = gather_tokens_replicated(memory, tokens)

        lang_pool = agg_lang_feat(l_hidden, lang_masks)
        bg_lang = None
        if bg_lang_weights is not None:
            # pooled in f32 from the raw tokens, then resized in the model's dtype
            eq = "kbl,bld->kd" if bg_lang_weights.dim() == 3 else "kl,bld->bkd"
            q_lang = torch.einsum(eq, bg_lang_weights.float(), lang_hidden.float())
            if bg_lang_weights.dim() == 3:
                # shared by the global batch: the data-parallel ranks' pools summed
                q_lang = global_sum(q_lang)
            bg_lang = self.resizer(q_lang.to(dtype))
            if bg_lang.dim() == 2:
                bg_lang = bg_lang[None].expand(b, -1, -1)

        # ---- two-stage proposals ------------------------------------------
        proposals_unact, prop_valid = two_stage_proposals(spatial_shapes, valid_ratios,
                                                          mask_flat)
        out_memory = memory.masked_fill(~prop_valid[..., None], 0.0)
        out_memory = self.enc_output_norm(self.enc_output(out_memory))
        enc_class = enc_class_head(out_memory, lang_pool[:, None, :])
        enc_coord_unact = enc_bbox_head(out_memory).float() + proposals_unact
        scores = enc_class[..., 0].masked_fill(~prop_valid, torch.finfo(torch.float32).min)
        topk_idx = scores.topk(c.two_stage_num_proposals, dim=1).indices
        topk_coords_unact = enc_coord_unact.gather(1, topk_idx[..., None].expand(-1, -1, 4))
        fg_refs = topk_coords_unact.detach().sigmoid()

        # ---- queries [dn | bg_lang | bg | fg] -----------------------------
        tgt = self.tgt_embed.weight[None].expand(b, -1, -1)
        refs = fg_refs
        if c.num_bg_queries > 0:
            tgt = torch.cat([self.tgt_embed_bg.weight[None].expand(b, -1, -1), tgt], 1)
            refs = torch.cat([self.bg_query_refs.weight.float()[None].expand(b, -1, -1), refs], 1)
        if bg_lang is not None:
            tgt = torch.cat([bg_lang.to(tgt.dtype), tgt], 1)
            refs = torch.cat([refs.new_zeros(b, bg_lang.shape[1], 4), refs], 1)
        if dn_tgt is not None:
            tgt = torch.cat([dn_tgt.to(tgt.dtype), tgt], 1)
            refs = torch.cat([dn_refs_unact.float().sigmoid(), refs], 1)
        if c.decouple_tgt:
            # grounding without still_tgt_for_both puts the pooled language
            # feature into every query slot; detection keeps the embeddings
            if not c.still_tgt_for_both and task == "grounding":
                tgt = self.resizer(lang_pool)[:, None, :].expand_as(tgt)
        else:
            # the matching queries take the pooled language; the slots before them
            # (dn, bg_lang, bg) keep their content
            n_fixed = tgt.shape[1] - c.num_queries
            lang_part = self.resizer(lang_pool)[:, None, :].expand(b, c.num_queries, -1)
            tgt = torch.cat([tgt[:, :n_fixed], lang_part.to(tgt.dtype)], 1)
        init_reference = refs

        # ---- decoder --------------------------------------------------------
        # Each layer refines its input boxes with the shared-index box head; the
        # next layer's reference is the refined box detached. A layer's output
        # box applies its delta to the previous layer's undetached refined box
        # (look-forward-twice), which differs from its refined reference only in
        # gradients.
        vr2 = torch.cat([valid_ratios, valid_ratios], -1)[:, None]
        hs_list, refs_list, coords_list = [], [], []
        output = tgt
        reference_points = refs
        for lid, layer in enumerate(self.decoder.layers):
            ref_input = reference_points[:, :, None, :] * vr2
            query_sine = sine_position_embedding_1d(ref_input[:, :, 0, :], num_feats=c.d_model // 2)
            query_pos = self.decoder.ref_point_head(query_sine.to(dtype))
            output = maybe_checkpoint(c.remat, layer, output, query_pos, ref_input, memory,
                                      spatial_shapes, mask_flat, self_attn_mask)
            delta = bbox_heads[lid](output).float()
            new_ref = (delta + inverse_sigmoid(reference_points)).sigmoid()
            reference_points = new_ref.detach()
            hs_list.append(output)
            refs_list.append(new_ref if c.look_forward_twice else reference_points)
            if lid == 0 or not torch.is_grad_enabled():
                coords_list.append(new_ref)
            else:
                coords_list.append((delta + inverse_sigmoid(refs_list[lid - 1])).sigmoid())
        inter_references = torch.stack(refs_list)

        return {
            "hs": torch.stack(hs_list),
            "outputs_coord": torch.stack(coords_list),
            "inter_references": inter_references,
            "init_reference": init_reference,
            "memory": memory,
            "spatial_shapes": spatial_shapes,
            "enc_outputs_class": enc_class,
            "enc_outputs_coord_unact": enc_coord_unact,
            "lang_hidden": l_hidden,
        }
