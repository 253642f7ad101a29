"""Dataset mapper: raw dataset dicts -> static-shape device batches.

The port's copy of hipie_tpu/data/mapper.py: the same ``np.random.RandomState``
draws in the same order, so one seed gives the JAX package's outputs. The
resizes are hipie_torch/data/image_io.py's (cv2.INTER_LINEAR's geometry for
the image, cv2.INTER_NEAREST's indices for the masks) instead of cv2's.

Behavioral parity target: reference hipie/data/coco_dataset_mapper_uni.py
(DetrDatasetMapperUni): per-dataset label spaces + is_thing maps, GLIP-style
detection->grounding conversion with negative sampling, LSJ / shortest-edge
transforms, expression hflip word swap, per-instance positive maps; test-time
inputs carry the class-list prompt + dense maps + is_thing.

The mapper emits fixed-shape numpy arrays (padded N_max targets, bucketed
image sizes, fixed text length) that the loader stacks into the train step's
batches — the detectron2 Instances/ImageList machinery is replaced by
the Targets/TrainBatch NamedTuples.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from hipie_torch.config import DataConfig
from hipie_torch.data import transforms as T
from hipie_torch.data.image_io import resize_nearest
from hipie_torch.data.prompts import (
    PromptSpec,
    build_prompt_spec,
    detection_to_grounding,
    grounding_prompt_spec,
)
from hipie_torch.data.transforms import flip_expression
from hipie_torch.models.text.tokenizer import WordPieceTokenizer


@dataclass
class MapperOutput:
    image: np.ndarray            # (H, W, 3) float32, padded bucket
    pad_mask: np.ndarray         # (H, W) bool
    image_size: Tuple[int, int]  # valid (h, w) after transforms
    orig_size: Tuple[int, int]   # original (h, w)
    input_ids: np.ndarray        # (L,)
    attention_mask: np.ndarray   # (L,)
    prompt_spec: PromptSpec
    # training-only padded targets:
    labels: Optional[np.ndarray] = None       # (N,)
    boxes: Optional[np.ndarray] = None        # (N, 4) cxcywh normalized
    masks: Optional[np.ndarray] = None        # (N, Hm, Wm)
    positive_map: Optional[np.ndarray] = None # (N, L)
    is_thing: Optional[np.ndarray] = None     # (N,)
    valid: Optional[np.ndarray] = None        # (N,)
    meta: Optional[Dict[str, Any]] = None


def _resize_masks(masks: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """(N, H, W) masks -> (N, h, w) uint8, nearest (cv2.INTER_NEAREST's indices)."""
    return np.moveaxis(resize_nearest(np.moveaxis(masks.astype(np.uint8), 0, -1), hw), -1, 0)


class HIPIEMapper:
    def __init__(self, cfg: DataConfig, tokenizer: WordPieceTokenizer,
                 is_train: bool = True, max_gt: int = 100,
                 mask_out_stride: int = 4, seed: int = 0,
                 part_words: Sequence[str] = ()):
        self.cfg = cfg
        self.tok = tokenizer
        self.is_train = is_train
        self.max_gt = max_gt
        self.mask_out_stride = mask_out_stride
        self.rng = np.random.RandomState(seed)
        self.part_words = part_words

    # -- shared image path ---------------------------------------------------

    def _transform_train(self, img, boxes, masks):
        cfg = self.cfg
        if cfg.lsj_crop:
            img2, (sy, sx) = T.random_resize_scale(self.rng, img, 0.1, 2.0,
                                                   cfg.crop_size)
            if boxes is not None and len(boxes):
                boxes = boxes * np.array([sx, sy, sx, sy])
            if masks is not None and len(masks):
                masks = _resize_masks(masks, img2.shape[:2])
            img, boxes, masks, _ = T.fixed_size_crop(self.rng, img2, cfg.crop_size,
                                                     boxes, masks)
        else:
            short = cfg.min_size_train[self.rng.randint(len(cfg.min_size_train))]
            img2, (sy, sx) = T.resize_shortest_edge_np(img, short, cfg.max_size_train)
            if boxes is not None and len(boxes):
                boxes = boxes * np.array([sx, sy, sx, sy])
            if masks is not None and len(masks):
                masks = _resize_masks(masks, img2.shape[:2])
            img = img2
        flipped = False
        if self.rng.rand() < 0.5:
            img, boxes, masks = T.hflip(img, boxes, masks)
            flipped = True
        return img, boxes, masks, flipped

    def _pad_targets(self, labels, boxes_cxcywh, masks_s4, pos_map, is_thing, L):
        n = self.max_gt
        hm, wm = masks_s4.shape[1:] if len(masks_s4) else (1, 1)
        out = dict(
            labels=np.zeros(n, np.int32), boxes=np.zeros((n, 4), np.float32),
            masks=np.zeros((n, hm, wm), np.float32),
            positive_map=np.zeros((n, L), np.float32),
            is_thing=np.zeros(n, bool), valid=np.zeros(n, bool))
        k = min(len(labels), n)
        if k:
            out["labels"][:k] = labels[:k]
            out["boxes"][:k] = boxes_cxcywh[:k]
            out["masks"][:k] = masks_s4[:k]
            out["positive_map"][:k] = pos_map[:k]
            out["is_thing"][:k] = is_thing[:k]
            out["valid"][:k] = True
        return out

    # -- main entry ------------------------------------------------------------

    def __call__(self, record: Dict[str, Any],
                 bucket: Optional[Tuple[int, int]] = None) -> MapperOutput:
        """record: {image (H,W,3) uint8 RGB, annotations: [{bbox xyxy, category_id,
        segmentation mask (H,W) uint8, is_thing}], class_names, class_is_thing,
        task, expression?}"""
        img = record["image"].astype(np.float32)
        task = record.get("task", "detection")
        cfg = self.cfg
        L = cfg.max_text_len

        anns = record.get("annotations", [])
        boxes = np.asarray([a["bbox"] for a in anns], np.float32).reshape(-1, 4)
        masks = (np.stack([a["segmentation"] for a in anns])
                 if anns and "segmentation" in anns[0] else np.zeros((0, 1, 1)))
        labels = np.asarray([a["category_id"] for a in anns], np.int64)
        inst_is_thing = np.asarray(
            [a.get("is_thing", True) for a in anns], bool)

        orig_size = img.shape[:2]
        if self.is_train:
            img, boxes, masks, flipped = self._transform_train(img, boxes, masks)
        else:
            img, (sy, sx) = T.resize_shortest_edge_np(
                img, cfg.min_size_test, cfg.max_size_test)
            flipped = False

        h, w = img.shape[:2]
        bucket = bucket or T.size_buckets(h, w)
        img_p, pad_mask = T.pad_to_bucket(img, bucket)

        # ---- text + positive maps -------------------------------------------
        expression = record.get("expression")
        if task == "grounding":
            if flipped and expression:
                expression = flip_expression(expression)
            spec = grounding_prompt_spec(expression or "", self.tok, L)
            # grounding class logits span ONE pooled-language channel
            # (reference coco_dataset_mapper.py:234 positive_map =
            # ones((1, 1))): positive weight lives in column 0; the criterion
            # slices the padded map to the logits' channel count.
            inst_pm = np.zeros((len(labels), L), np.float32)
            inst_pm[:, 0] = 1.0
            new_labels = np.zeros(len(labels), np.int64)
        elif self.is_train:
            spec, inst_pm, new_labels, keep = detection_to_grounding(
                self.rng, labels, record["class_names"],
                record["class_is_thing"], self.tok, L,
                max_num_classes=cfg.num_negative_classes,
                shuffle=cfg.shuffle_classes, part_words=self.part_words)
            if not keep.all():
                # instances whose class overflowed the token budget are dropped
                # (reference check_for_positive_overflow semantics)
                boxes = boxes[keep]
                masks = masks[keep] if len(masks) == len(keep) else masks
                inst_is_thing = inst_is_thing[keep]
                labels = labels[keep]
        else:
            spec = build_prompt_spec(record["class_names"],
                                     record["class_is_thing"], self.tok, L,
                                     part_words=self.part_words)
            inst_pm = (spec.mean_weights[labels]
                       if len(labels) else np.zeros((0, L), np.float32))
            new_labels = labels

        out = MapperOutput(
            image=img_p, pad_mask=pad_mask, image_size=(h, w),
            orig_size=tuple(orig_size),
            input_ids=spec.input_ids, attention_mask=spec.attention_mask,
            prompt_spec=spec, meta={"task": task, "record": record},
        )
        if self.is_train:
            # normalize boxes by the VALID image size, xyxy -> cxcywh.
            scale = np.array([w, h, w, h], np.float32)
            bn = boxes / scale if len(boxes) else boxes
            cxcywh = np.concatenate(
                [(bn[:, :2] + bn[:, 2:]) / 2, bn[:, 2:] - bn[:, :2]], -1
            ) if len(boxes) else np.zeros((0, 4), np.float32)
            # GT masks at mask_out_stride on the PADDED canvas.
            masks_full = np.zeros((len(masks), bucket[0], bucket[1]), np.float32)
            if len(masks):
                masks_full[:, :h, :w] = masks[:, :h, :w]
            masks_s4 = T.downsample_mask_condinst(masks_full, self.mask_out_stride)
            padded = self._pad_targets(new_labels, cxcywh, masks_s4, inst_pm,
                                       inst_is_thing, L)
            for k, v in padded.items():
                setattr(out, k, v)
        return out
