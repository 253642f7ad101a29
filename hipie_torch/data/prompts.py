"""Prompt construction + positive maps (host side, numpy).

Counterpart of hipie_tpu/data/prompts.py; ``PromptSpec.class_maps`` gives the
port's torch ClassMaps.

Behavioral parity target: reference hipie/data/coco_dataset_mapper_uni.py —
  * create_queries_and_maps (:54-92): label list -> "a. b. c." prompt + per-class
    token spans via char offsets.
  * create_positive_map (:974-1023): (N_obj, L) row-normalized token maps; the
    part-mode token spreading (THINGS_CLASSES_WITH_PART) is reproduced: shared
    object words distribute their token mass over all occurrences.
  * convert_object_detection_to_grounding_optimized_for_od (:738-903): GLIP-style
    negative-class sampling/shuffling for training prompts.
  * check_for_positive_overflow (:689): drop classes whose tokens exceed max_len.

TPU redesign: instead of the reference's {label: token-index list} dict consumed
by a python loop at inference, we emit a dense ClassMaps (mean-weights matrix +
token mask + is_thing vector) so token->class pooling is a single matmul on
device (hipie_torch/models/postprocess.py).
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from hipie_torch.models.postprocess import ClassMaps
from hipie_torch.models.text.tokenizer import WordPieceTokenizer


def clean_name(name: str) -> str:
    """reference coco_dataset_mapper_uni.py clean_name: strip parens/underscores."""
    name = re.sub(r"\(.*\)", "", name)
    name = re.sub(r"_", " ", name)
    name = re.sub(r"  ", " ", name)
    return name


def build_class_prompt(class_names: Sequence[str],
                       separation_tokens: str = ". ") -> Tuple[str, List[Tuple[int, int]]]:
    """'a. b. c' prompt + per-class char spans."""
    query = ""
    spans = []
    names = [clean_name(n) for n in class_names]
    for i, name in enumerate(names):
        start = len(query)
        query += name
        spans.append((start, len(query)))
        if i != len(names) - 1:
            query += separation_tokens
    return query, spans


def spans_to_token_map(
    offsets: Sequence[Tuple[int, int]],
    spans: Sequence[Tuple[int, int]],
    max_len: int,
) -> np.ndarray:
    """(N_spans, L) 0/1 map from char spans to token positions (un-normalized)."""
    def char_to_token(ci):
        for ti, (s, e) in enumerate(offsets):
            if s <= ci < e:
                return ti
        return None

    def first_not_none(*vals):
        for v in vals:
            if v is not None:
                return v
        return None

    pm = np.zeros((len(spans), max_len), np.float32)
    for j, (beg, end) in enumerate(spans):
        beg_pos = first_not_none(char_to_token(beg), char_to_token(beg + 1),
                                 char_to_token(beg + 2))
        end_pos = first_not_none(char_to_token(end - 1), char_to_token(end - 2),
                                 char_to_token(end - 3))
        if beg_pos is None or end_pos is None:
            continue
        pm[j, beg_pos:end_pos + 1] = 1.0
    return pm


def spread_part_tokens(pm: np.ndarray, input_ids: Sequence[int],
                       tokenizer: WordPieceTokenizer,
                       part_words: Sequence[str]) -> np.ndarray:
    """Part-mode token spreading (create_positive_map part_mode branch):
    for shared object words ('dog' in 'dog head'/'dog tail'), every row that has
    mass on ANY occurrence of the word gets mass on ALL its occurrences."""
    ids = np.asarray(input_ids)
    uids, counts = np.unique(ids, return_counts=True)
    for uid, c in zip(uids, counts):
        tok = tokenizer.ids_to_tokens.get(int(uid), "")
        if ("[" in tok or "]" in tok or "#" in tok or "." in tok
                or c == 1 or c >= 30):
            continue
        if tok not in part_words:
            continue
        matched = ids == uid
        any_mass = pm[:, matched].any(axis=1, keepdims=True)
        pm[:, matched] = any_mass.astype(np.float32)
    return pm


def normalize_positive_map(pm: np.ndarray) -> np.ndarray:
    return pm / (pm.sum(-1, keepdims=True) + 1e-6)


class PromptSpec:
    """Per-dataset (or per-image) prompt + dense class maps for the device."""

    def __init__(self, prompt: str, input_ids: np.ndarray, attention_mask: np.ndarray,
                 mean_weights: np.ndarray, token_mask: np.ndarray,
                 is_thing: np.ndarray, class_names: List[str]):
        self.prompt = prompt
        self.input_ids = input_ids
        self.attention_mask = attention_mask
        self.mean_weights = mean_weights    # (C, L)
        self.token_mask = token_mask        # (C, L) bool
        self.is_thing = is_thing            # (C,) bool
        self.class_names = class_names

    def class_maps(self, device=None):
        return ClassMaps(torch.as_tensor(self.mean_weights, device=device),
                         torch.as_tensor(self.token_mask, device=device),
                         torch.as_tensor(self.is_thing, device=device))


def build_prompt_spec(
    class_names: Sequence[str],
    is_thing: Sequence[bool],
    tokenizer: WordPieceTokenizer,
    max_len: int = 256,
    part_words: Sequence[str] = (),
) -> PromptSpec:
    """Detection/panoptic prompt for a fixed label set (test-time path,
    reference coco_dataset_mapper_uni.py:451-601)."""
    prompt, spans = build_class_prompt(class_names)
    enc = tokenizer.encode(prompt, max_len=max_len)
    pm = spans_to_token_map(enc["offsets"], spans, max_len)
    if part_words:
        pm = spread_part_tokens(pm, enc["input_ids"], tokenizer, part_words)
    return PromptSpec(
        prompt=prompt,
        input_ids=np.asarray(enc["input_ids"], np.int32),
        attention_mask=np.asarray(enc["attention_mask"], np.int32),
        mean_weights=normalize_positive_map(pm),
        token_mask=pm > 0,
        is_thing=np.asarray(is_thing, bool),
        class_names=list(class_names),
    )


def grounding_prompt_spec(expression: str, tokenizer: WordPieceTokenizer,
                          max_len: int = 256) -> PromptSpec:
    """Referring-expression prompt: one pooled 'class' covering token 0."""
    enc = tokenizer.encode(expression, max_len=max_len)
    pm = np.zeros((1, max_len), np.float32)
    pm[0, 0] = 1.0
    return PromptSpec(expression, np.asarray(enc["input_ids"], np.int32),
                      np.asarray(enc["attention_mask"], np.int32),
                      pm, pm > 0, np.asarray([True]), [expression])


def detection_to_grounding(
    rng: np.random.RandomState,
    gt_classes: np.ndarray,              # (N_obj,) dataset class ids (0-based)
    class_names: Sequence[str],
    is_thing: Sequence[bool],
    tokenizer: WordPieceTokenizer,
    max_len: int = 256,
    max_num_classes: int = 80,
    shuffle: bool = True,
    part_words: Sequence[str] = (),
) -> Tuple[PromptSpec, np.ndarray, np.ndarray, np.ndarray]:
    """GLIP-style training prompt: positives + sampled negatives, shuffled.

    reference convert_object_detection_to_grounding_optimized_for_od
    (coco_dataset_mapper_uni.py:738-903) + check_for_positive_overflow (:689).
    Returns (PromptSpec over the sampled classes, (N_kept, L) per-instance
    positive map rows, (N_kept,) remapped class ids, (N_obj,) bool mask of
    instances kept — False where the instance's class overflowed the budget).
    """
    num_classes = len(class_names)
    positives = sorted(set(int(c) for c in gt_classes))
    negatives = [c for c in range(num_classes) if c not in positives]
    n_neg = max(0, min(len(negatives), max_num_classes - len(positives)))
    if n_neg > 0 and len(negatives) > n_neg:
        negatives = list(rng.choice(negatives, n_neg, replace=False))
    else:
        negatives = negatives[:n_neg]
    # Token budget: positives are admitted FIRST (reference
    # check_for_positive_overflow guarantees every kept instance's class fits;
    # overflow positives are dropped along with their instances), then
    # negatives fill the remaining budget. The final prompt can never exceed
    # max_len.
    def token_cost(c, first):
        ids, _ = tokenizer.tokenize(clean_name(class_names[c]))
        return len(ids) + (0 if first else 2)

    kept_pos, length = [], 2   # [CLS]/[SEP]
    for c in positives:
        extra = token_cost(c, not kept_pos)
        if length + extra >= max_len - 2:
            continue
        length += extra
        kept_pos.append(c)
    kept_neg = []
    for c in negatives:
        extra = token_cost(c, False)
        if length + extra >= max_len - 2:
            continue
        length += extra
        kept_neg.append(c)
    kept = kept_pos + kept_neg
    if shuffle:
        rng.shuffle(kept)

    names = [class_names[c] for c in kept]
    things = [is_thing[c] for c in kept]
    spec = build_prompt_spec(names, things, tokenizer, max_len, part_words)
    # per-instance positive map rows: instance -> its class's row; instances of
    # dropped (overflow) positive classes are masked out via keep_instances.
    remap = {c: i for i, c in enumerate(kept)}
    keep_instances = np.asarray([int(c) in remap for c in gt_classes], bool)
    gt_kept = [int(c) for c in gt_classes if int(c) in remap]
    inst_pm = np.stack([
        spec.mean_weights[remap[c]] for c in gt_kept
    ]) if gt_kept else np.zeros((0, max_len), np.float32)
    new_classes = np.asarray([remap[c] for c in gt_kept], np.int64)
    return spec, inst_pm, new_classes, keep_instances
