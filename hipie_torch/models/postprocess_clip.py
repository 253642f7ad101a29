"""Open-vocabulary CLIP score ensembling: the text-embedding cache, the
train-vocabulary overlap, and the fusion of MaskCLIP probabilities into the
detector's class scores.

Counterpart of hipie_tpu/models/postprocess_clip.py (reference
hipie/hipie_img.py get_clip_logits :811-868 and its call sites :596-611 and
:736-751, open_vocab/clip.py build_text_embed :361-373, open_vocab/helper.py
prompt_labels and ensemble_logits_with_labels :79-129). The text embeddings
of a label set are built once on the device and cached; the per-image work
is the mask-pooled visual pass and the fusion.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from hipie_torch.config import ClipConfig
from hipie_torch.models.clip import (CLIPText, CLIPVisual, MaskCLIP, clip_score_fusion,
                                     load_open_clip)


def prompt_labels(labels: Sequence[Sequence[str]], prompt: str = "photo"
                  ) -> List[List[str]]:
    """reference helper.py prompt_labels (:112-129)."""
    if prompt is None:
        return [list(g) for g in labels]
    fmt = {"a": "a {}", "photo": "a photo of a {}.",
           "scene": "a photo of a {} in the scene."}[prompt]
    return [[fmt.format(l) for l in group] for group in labels]


def category_overlap_mask(test_labels: Sequence[Sequence[str]],
                          train_vocab: Optional[Sequence[str]] = None) -> np.ndarray:
    """(C,) 1.0 where any synonym of the test class appears in the training
    vocabulary (default COCO panoptic's 133 names; hipie_img.py:820-831)."""
    if train_vocab is None:
        from hipie_torch.data.label_spaces import COCO_PANOPTIC_133
        train_vocab = COCO_PANOPTIC_133
    vocab = set()
    for name in train_vocab:
        vocab.update(s.strip() for s in name.split(","))
    out = np.zeros(len(test_labels), np.float32)
    for i, group in enumerate(test_labels):
        if not vocab.isdisjoint({s.strip() for s in group}):
            out[i] = 1.0
    return out


class CLIPScorer:
    """Holder of the frozen CLIP towers and the per-label-set text-embedding cache.

    ``state_dict`` is an open_clip checkpoint's (``hipie_torch.utils.export.
    inv_clip`` gives one from the JAX package's CLIP parameters); without one
    the towers are random, drawn from ``generator`` (a seeded torch.Generator
    on ``device``; seed 0 when not given). The towers compute in ``dtype``
    (f32 by default, as JAX's) on ``device``, the card unless the caller
    passes ``device="cpu"``.
    """

    def __init__(self, cfg: ClipConfig, tokenizer, state_dict: Optional[Dict] = None,
                 visual: Optional[CLIPVisual] = None, text: Optional[CLIPText] = None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CLIPScorer: no CUDA device; pass device='cpu' to run on the CPU")
        self.cfg = cfg
        self.tok = tokenizer
        with torch.device(self.device):
            self.text = (text or CLIPText()).to(self.device).eval()
            self.maskclip = MaskCLIP(visual or CLIPVisual()).to(self.device).eval()
        self.visual = self.maskclip.visual
        self._text_cache: Dict[str, Tuple[torch.Tensor, Tuple[int, ...]]] = {}
        if state_dict is not None:
            load_open_clip(self.text, self.maskclip,
                           {k: torch.as_tensor(np.array(v)) for k, v in state_dict.items()})
        else:
            from hipie_torch.utils.weights import random_init_

            g = generator or torch.Generator(device=self.device).manual_seed(0)
            with torch.no_grad():
                for module in (self.text, self.maskclip):
                    random_init_(module, g)
                self.visual.class_embedding.normal_(0.0, 0.02, generator=g)
        self.text.to(dtype)
        self.maskclip.to(dtype)
        self.maskclip.logit_scale.data = self.maskclip.logit_scale.data.float()

    @torch.no_grad()
    def build_text_embed(self, labels: Sequence[Sequence[str]], prompt: str = "photo"
                         ) -> Tuple[torch.Tensor, Tuple[int, ...]]:
        """Cached text embeddings of a label set (reference clip.py:361-373).

        labels: per class, its synonyms. Returns ((T, C) f32 embeddings of the
        flattened prompted synonyms, the per-class group sizes). A label set
        of one class (a referring expression) is not cached."""
        key = repr([list(g) for g in labels]) + prompt
        if key in self._text_cache:
            return self._text_cache[key]
        prompted = prompt_labels(labels, prompt)
        flat = [p for group in prompted for p in group]
        group_sizes = tuple(len(g) for g in prompted)
        ids = torch.from_numpy(self.tok(flat)).long().to(self.device)
        embeds = [self.text(ids[s:s + 256]) for s in range(0, ids.shape[0], 256)]
        out = (torch.cat(embeds, 0), group_sizes)
        if len(labels) > 1:
            self._text_cache[key] = out
        return out

    def make_clip_fn(self, labels: Sequence[Sequence[str]],
                     train_vocab: Optional[Sequence[str]] = None):
        """Returns (clip_fn, overlap): clip_fn(images01, mask_logits) -> (Q, C)
        ensembled CLIP logits over the cached text embeddings; overlap (C,) f32."""
        text_embed, group_sizes = self.build_text_embed(labels)
        overlap = torch.from_numpy(category_overlap_mask(labels, train_vocab)).to(self.device)

        def clip_fn(images01: torch.Tensor, mask_logits: torch.Tensor) -> torch.Tensor:
            with torch.no_grad():
                out = self.maskclip(images01, mask_logits, text_embed, group_sizes)
            return out[0] if out.ndim == 3 else out

        return clip_fn, overlap


def fuse_fg_probs(cls_logits: torch.Tensor, clip_logits: torch.Tensor, overlap: torch.Tensor,
                  is_thing: torch.Tensor, iou_logits: Optional[torch.Tensor], cfg: ClipConfig,
                  transform_eval: bool) -> torch.Tensor:
    """FG-instance CLIP fusion (reference hipie_img.py:593-608): prob =
    sigmoid(fused logits) * is_thing, then the geometric iou mix with exponents
    FG_IOU_A and FG_IOU_B."""
    if transform_eval:
        pred_prob = torch.softmax(torch.sigmoid(cls_logits) / cfg.pano_temperature_fg, -1)
    else:
        pred_prob = torch.sigmoid(cls_logits)
    fused = clip_score_fusion(pred_prob, clip_logits, overlap, cfg.alpha, cfg.beta, cfg.agg_mode)
    prob = torch.sigmoid(fused) * is_thing.float()[None]
    if iou_logits is not None:
        iou = torch.sigmoid(iou_logits.float())
        prob = torch.sqrt((prob ** cfg.fg_iou_a) * (iou ** cfg.fg_iou_b))
    return prob


def fuse_all_probs(pred_prob: torch.Tensor, clip_logits: torch.Tensor, overlap: torch.Tensor,
                   cfg: ClipConfig) -> torch.Tensor:
    """Pano/semantic CLIP fusion (reference hipie_img.py:736-751): fused
    logits, softmax over classes."""
    fused = clip_score_fusion(pred_prob, clip_logits, overlap, cfg.alpha, cfg.beta, cfg.agg_mode)
    return torch.softmax(fused, -1)
