"""HIPIE meta-architecture: text encoder + detector + fused inference.

Counterpart of hipie_tpu/models/hipie.py (reference hipie_img.py). Serving
shape: ``encode_text`` once for a fixed class prompt, then ``forward(...,
lang_hidden=...)`` and ``hipie_inference`` per image; ``hipie_torch.predictor``
wraps both for one image and a label set or a referring expression. Tasks:
"detection" (instances, semantic and panoptic maps over a label set) and
"grounding" (the one instance a referring expression names).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch
import torch.nn as nn

from hipie_torch.config import ModelConfig, TestConfig
from hipie_torch.models.detector import HIPIEDetector
from hipie_torch.models.postprocess import (ClassMaps, fg_instance_inference,
                                            grounding_to_od_logits, panoptic_inference,
                                            semantic_inference, transform_probs)
from hipie_torch.models.postprocess_clip import fuse_all_probs, fuse_fg_probs
from hipie_torch.models.text.bert import BertEncoder, parallel_det_block_mask
from hipie_torch.models.text.frontend import encode_long_prompt, plan_chunks
from hipie_torch.utils.trace import count, span


class HIPIEModel(nn.Module):
    """The model. Module names match the reference checkpoint.

    ``train=True`` also builds the heads that only training uses (see
    hipie_torch/models/detector.py), so that ``forward(..., train=True)`` can
    return the training outputs, and the parameters ``create_train_state`` of
    the JAX package makes load strictly.

    ``msda_method`` picks every MSDeformAttn's sampling core, as the JAX
    package's ``HIPIE_MSDA_METHOD`` does: "fused" (kernel K-B, the default) or
    "flat4" (quad-table gather and kernel K-C; its tables take the value dtype,
    so it is JAX's "flat4_bf16" under bf16 and "flat4" under f32).
    """

    def __init__(self, cfg: ModelConfig, parallel_det: bool = False, sep_token_id: int = 1012,
                 cls_token_id: int = 101, pad_token_id: int = 0, msda_method: str = "fused",
                 train: bool = False):
        super().__init__()
        self.cfg = cfg
        self.parallel_det = parallel_det
        self.sep_token_id, self.cls_token_id, self.pad_token_id = (
            sep_token_id, cls_token_id, pad_token_id)
        t = cfg.text
        self.text_encoder = BertEncoder(
            vocab_size=t.vocab_size, hidden_size=t.hidden_size, num_layers=t.num_layers,
            num_heads=t.num_heads, intermediate_size=t.intermediate_size,
            max_position_embeddings=t.max_position_embeddings, remat=t.remat)
        self.detr = HIPIEDetector(cfg, msda_method, train)

    def normalize(self, images: torch.Tensor) -> torch.Tensor:
        count("host_sync.normalize", 2)      # two blocking copies to the images' device
        mean = torch.tensor(self.cfg.pixel_mean, dtype=torch.float32, device=images.device)
        std = torch.tensor(self.cfg.pixel_std, dtype=torch.float32, device=images.device)
        return (images.float() - mean) / std

    def encode_text(self, input_ids, attn_mask, task: str = "detection"):
        """(B, L) token ids and mask -> (B, L, hidden) text features. The
        parallel_det block mask applies to detection prompts only. A prompt
        longer than BERT's positions (open-vocab label sets) is encoded in
        chunks of at most 510 tokens split at separators (``frontend``), as the
        reference's BERT wrapper does; positions after the last separator are
        zero."""
        with span("model.text"):
            parallel = self.parallel_det and task == "detection"
            if input_ids.shape[1] > self.cfg.text.max_position_embeddings:
                if parallel:
                    raise NotImplementedError("parallel_det with a prompt longer than "
                                              "max_position_embeddings")
                ids, mask = input_ids.cpu().numpy(), attn_mask.cpu().numpy()
                return torch.cat([
                    encode_long_prompt(self.text_encoder,
                                       plan_chunks(ids[i], mask[i], self.sep_token_id),
                                       ids.shape[1], input_ids.device)
                    for i in range(ids.shape[0])])
            block_mask = None
            if parallel:
                block_mask = parallel_det_block_mask(input_ids, self.sep_token_id,
                                                     self.cls_token_id, self.pad_token_id)
            return self.text_encoder(input_ids, attn_mask, block_mask)

    def forward(self, images, pad_mask, input_ids, lang_attn_mask, image_sizes,
                task: str = "detection",
                lang_hidden: Optional[torch.Tensor] = None, train: bool = False,
                bg_lang_weights: Optional[torch.Tensor] = None,
                **dn_kwargs) -> Dict[str, Any]:
        """images (B, H, W, 3) raw RGB (any numeric dtype); pad_mask (B, H, W) True = pad;
        input_ids / lang_attn_mask (B, L); image_sizes (B, 2) valid (h, w).
        Pass ``lang_hidden`` from ``encode_text`` to reuse a fixed prompt's features.
        ``bg_lang_weights`` adds language-derived bg queries (model.bg_query_from_lang):
        (K, L) token weights at inference, one row a stuff class, or (K, B, L) from
        ``hipie_torch.train.bg_lang`` in training; they sit after the dn slots.
        ``train=True`` returns the training outputs; ``dn_kwargs`` are the CDN
        queries (dn_labels, dn_valid, dn_refs_unact, self_attn_mask,
        maskdino_dn_refs, maskdino_dn_valid, maskdino_attn_mask) and a ViT
        backbone's drop-path keep masks (drop_path_masks), as
        hipie_torch.train.step passes them."""
        if task not in ("detection", "grounding"):
            raise ValueError(f"task must be 'detection' or 'grounding', got {task!r}")
        with span("model.forward"):
            x = self.normalize(images).masked_fill(pad_mask[..., None], 0.0)
            if lang_hidden is None:
                lang_hidden = self.encode_text(input_ids, lang_attn_mask, task)
            return self.detr(x, pad_mask, lang_hidden, lang_attn_mask, image_sizes, task=task,
                             train=train, bg_lang_weights=bg_lang_weights, **dn_kwargs)


class InferenceResult(NamedTuple):
    """Per-image static-shape outputs."""

    scores: torch.Tensor            # (K,)
    classes: torch.Tensor           # (K,)
    boxes: torch.Tensor             # (K, 4) xyxy normalised to the padded canvas
    mask_logits: torch.Tensor       # (K, H4, W4)
    sem_seg: Optional[torch.Tensor]          # (C, H4, W4); None for grounding
    panoptic: Optional[torch.Tensor]         # (H4, W4) int32 segment ids; None for grounding
    segment_valid: Optional[torch.Tensor]
    segment_classes: Optional[torch.Tensor]
    segment_isthing: Optional[torch.Tensor]


def hipie_inference(outputs: Dict[str, Any], maps: ClassMaps, test_cfg: TestConfig,
                    model_cfg: ModelConfig, image_index: int = 0, task: str = "detection",
                    has_thing: bool = True,
                    pad_mask_s4: Optional[torch.Tensor] = None,
                    clip_fn=None, clip_overlap: Optional[torch.Tensor] = None,
                    images01: Optional[torch.Tensor] = None,
                    n_bg_lang: int = 0) -> InferenceResult:
    """Fuse fg and bg branches into instance / semantic / panoptic results for one
    image (reference hipie_img.py inference, with its defaults use_bg_for_pano=True
    and transform_eval=True). Grounding keeps the one best instance and gives no
    semantic or panoptic map. ``n_bg_lang`` language-derived bg queries sit in
    front (query layout [bg_lang | bg | fg], hipie_img.py:560-573): the fg
    queries start after both bg blocks, and without MaskDINO the bg branch
    reads the bg_lang block.

    With ``clip_fn`` (MODEL.CLIP.ENABLED; ``CLIPScorer.make_clip_fn`` gives it
    and ``clip_overlap``), MaskCLIP probabilities are ensembled into the fg
    instance scores (a pass over the fg masks, hipie_img.py:596-611) and into
    the panoptic and semantic class probabilities (a pass over the masks those
    take, :736-751). ``images01`` (1, H, W, 3) is the padded canvas in [0, 1]."""
    with span("post.image"):
        i = image_index
        n_bg = model_cfg.transformer.num_bg_queries
        fg_start = n_bg + n_bg_lang
        fg_logits = outputs["pred_logits"][i][fg_start:]
        fg_boxes = outputs["pred_boxes"][i][fg_start:]
        fg_masks = outputs["pred_masks"][i][fg_start:]
        iou = outputs.get("pred_boxious")
        iou_i = iou[i][fg_start:] if iou is not None else None

        clip_prob = None
        if clip_fn is not None and task == "detection":
            fg_cls = grounding_to_od_logits(fg_logits, maps, mode="FG" if has_thing else None,
                                            max_pool=test_cfg.max_pool_tokens)
            clip_prob = fuse_fg_probs(fg_cls, clip_fn(images01, fg_masks[None]), clip_overlap,
                                      maps.is_thing, iou_i, model_cfg.clip, test_cfg.transform_eval)

        max_det = test_cfg.detections_per_image if task == "detection" else 1
        inst = fg_instance_inference(fg_logits, fg_boxes, fg_masks, iou_i, maps,
                                     max_detections=max_det,
                                     nms_thresh=test_cfg.nms_thresh, has_thing=has_thing,
                                     max_pool=test_cfg.max_pool_tokens, clip_prob=clip_prob)
        if task != "detection":
            return InferenceResult(scores=inst.scores, classes=inst.classes, boxes=inst.boxes,
                                   mask_logits=inst.mask_logits, sem_seg=None, panoptic=None,
                                   segment_valid=None, segment_classes=None, segment_isthing=None)

        md = outputs.get("maskdino")
        if md is not None:
            bg_token_logits, bg_mask_logits = md["pred_logits"][i], md["pred_masks"][i]
        else:
            n_bg_blk = n_bg_lang if n_bg_lang > 0 else n_bg
            bg_token_logits = outputs["pred_logits"][i][:n_bg_blk]
            bg_mask_logits = outputs["pred_masks"][i][:n_bg_blk]
        mode = None if (test_cfg.use_bg_for_pano or test_cfg.bg_cls_agnostic) else "BG"
        bg_cls = grounding_to_od_logits(bg_token_logits, maps, mode=mode,
                                        max_pool=test_cfg.max_pool_tokens)
        if test_cfg.use_bg_for_pano:
            all_cls, all_masks, drop = bg_cls, bg_mask_logits, None
        else:
            all_cls = torch.cat([grounding_to_od_logits(fg_logits, maps, mode="FG",
                                                        max_pool=test_cfg.max_pool_tokens), bg_cls])
            all_masks = torch.cat([fg_masks, bg_mask_logits])
            drop = torch.cat([~inst.keep_fg, torch.zeros(bg_cls.shape[0], dtype=torch.bool,
                                                         device=bg_cls.device)])
        prob = transform_probs(all_cls, temperature=test_cfg.pano_temperature,
                               transform_eval=test_cfg.transform_eval)
        if clip_fn is not None:
            prob = fuse_all_probs(prob, clip_fn(images01, all_masks[None]), clip_overlap,
                                  model_cfg.clip)
        if drop is not None:
            prob = prob.masked_fill(drop[:, None], 0.0)
            all_masks = all_masks.masked_fill(drop[:, None, None], -1e4)
        if pad_mask_s4 is not None:
            all_masks = all_masks.masked_fill(pad_mask_s4[None], -1e4)
        with span("post.panoptic"):
            sem = semantic_inference(prob, all_masks)
            p = panoptic_inference(prob, all_masks, maps.is_thing,
                                   test_cfg.panoptic_object_mask_thresh,
                                   test_cfg.panoptic_overlap_thresh, pad_mask=pad_mask_s4)
        return InferenceResult(scores=inst.scores, classes=inst.classes, boxes=inst.boxes,
                               mask_logits=inst.mask_logits, sem_seg=sem, panoptic=p.panoptic_seg,
                               segment_valid=p.segment_valid, segment_classes=p.segment_classes,
                               segment_isthing=p.segment_isthing)
