"""Contrastive denoising (CDN) queries, static slot budget.

Counterpart of hipie_tpu/models/dn.py (reference ddetrs_dn.py prepare_for_cdn
and compute_gt_indices): the slot budget is pad = 2 * max(dn_number, N); the
group count is dynamic, g = max(1, 2 * dn_number // (2 * m)) with m the batch's
largest GT count, and slot s serves section s // m (even: positive, odd:
negative) and GT s % m. Labels are flipped to a random class with probability
ratio / 2; box corners move by a random sign times a magnitude in [0, 1) for
positive sections and [1, 2) for negative ones, in half-extent units, clamped to
[0, 1]. Both sections supervise their GT (``gt_assign``). The attention mask
keeps the matching queries from seeing dn slots and dn groups from seeing each
other. The random draws come from ``keys`` (hipie_plain/utils/rng.py). Under
data parallelism m is the global batch's and the draws are the global batch's
rows of this rank, so each rank builds what one process would for its images.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from hipie_plain.parallel.mesh import global_max
from hipie_plain.utils.misc import inverse_sigmoid
from hipie_plain.utils.rng import Keys, batch_randint, batch_uniform


class CDNQueries(NamedTuple):
    noised_labels: torch.Tensor   # (B, pad) int64, embedded by the model's label_enc
    slot_valid: torch.Tensor      # (B, pad) bool
    refs_unact: torch.Tensor      # (B, pad, 4) inverse-sigmoid noised boxes
    attn_mask: torch.Tensor       # (pad + matching, pad + matching) bool, True = blocked
    gt_assign: torch.Tensor       # (B, pad) int64 GT index or -1
    pad_size: int


def prepare_cdn(keys: Keys, labels: torch.Tensor, boxes: torch.Tensor, valid: torch.Tensor,
                num_classes: int, num_matching_queries: int, dn_number: int = 100,
                label_noise_ratio: float = 0.5, box_noise_scale: float = 1.0) -> CDNQueries:
    """labels (B, N) int; boxes (B, N, 4) cxcywh in [0, 1]; valid (B, N) bool with
    the valid GTs first. ``num_matching_queries``: the queries after the dn block."""
    b, n = labels.shape
    dev = labels.device
    pad = 2 * max(dn_number, n)
    k_label, k_box_sign, k_box_mag, k_flip = keys.split(4)

    # the global batch's largest GT count (over the data-parallel ranks)
    m = global_max(valid.sum(-1).max()).clamp(min=1)
    groups = ((2 * dn_number) // (2 * m)).clamp(min=1)
    s = torch.arange(pad, device=dev)
    sec = s // m
    gt = s % m
    slot_active = sec < 2 * groups
    gt_b = gt[None].expand(b, pad)
    slot_labels = labels.long().gather(1, gt_b)
    slot_boxes = boxes.float().gather(1, gt_b[..., None].expand(b, pad, 4))
    slot_valid = valid.gather(1, gt_b) & slot_active[None]

    if label_noise_ratio > 0:
        p = batch_uniform(k_label, (b, pad), device=dev)
        rand_label = batch_randint(k_flip, 0, num_classes, (b, pad), device=dev)
        noised_labels = torch.where(p < label_noise_ratio * 0.5, rand_label, slot_labels)
    else:
        noised_labels = slot_labels
    noised_labels = noised_labels.clamp(0, num_classes - 1)

    is_neg = (sec % 2 == 1)[None, :, None]
    sign = batch_randint(k_box_sign, 0, 2, (b, pad, 4), device=dev).float() * 2.0 - 1.0
    mag = batch_uniform(k_box_mag, (b, pad, 4), device=dev)
    mag = torch.where(is_neg, mag + 1.0, mag)
    wh = slot_boxes[..., 2:]
    half = torch.cat([wh / 2, wh / 2], -1)
    xyxy = torch.cat([slot_boxes[..., :2] - wh / 2, slot_boxes[..., :2] + wh / 2], -1)
    noised_xyxy = (xyxy + sign * mag * half * box_noise_scale).clamp(0.0, 1.0)
    noised = torch.cat([(noised_xyxy[..., :2] + noised_xyxy[..., 2:]) / 2,
                        noised_xyxy[..., 2:] - noised_xyxy[..., :2]], -1)
    refs_unact = torch.where(slot_valid[..., None], inverse_sigmoid(noised), 0.0)
    gt_assign = torch.where(slot_valid, gt_b, -1)

    q_total = pad + num_matching_queries
    mask = torch.zeros(q_total, q_total, dtype=torch.bool, device=dev)
    mask[pad:, :pad] = True
    mask[:pad, :pad] = (sec[:, None] // 2) != (sec[None, :] // 2)
    return CDNQueries(noised_labels, slot_valid, refs_unact, mask, gt_assign, pad)
