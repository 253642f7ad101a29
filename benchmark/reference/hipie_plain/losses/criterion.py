"""HIPIE training criterion: token-focal classification, box, IoU-head and
point-sampled mask losses with per-layer deep supervision.

Counterpart of hipie_tpu/losses/criterion.py (reference deformable_detr.py
SetCriterion / DINOCriterion and the fg / bg / gt passes of ddetrs_dn.py
coco_forward): targets padded to N slots with validity masks, assignments as
(B, Q) GT-index-or--1 tensors, and masks only for up to ``max_matched`` matched
queries per image. Matching for all layers of a pass runs first, batched over
(layers x images); the losses then run layer by layer. Every loss is f32.

The normalisers (GT and matched counts, the things re-weighting's pair and
thing counts) are the global batch's under data parallelism
(``hipie_plain.parallel.mesh.global_count``: one all-reduce a pass, after its
matching), in units of the global count over the group's size; a normaliser's
floor of one count is ``count_unit()`` in those units. Without a process group
they are this batch's counts and the floor is 1.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

from hipie_plain.config import LossConfig
from hipie_plain.losses.matcher import (auction_assignment, hungarian_vl_costs,
                                        hungarian_vl_match, mask_match_costs,
                                        mask_match_costs_embed, simota_match)
from hipie_plain.losses.point_features import point_sample, uncertain_point_coords
from hipie_plain.models.mask_head import dynamic_mask_with_coords
from hipie_plain.ops.box_ops import (box_cxcywh_to_xyxy, elementwise_box_iou,
                                     elementwise_generalized_box_iou)
from hipie_plain.parallel.mesh import count_unit, data_size, global_count
from hipie_plain.utils.rng import Keys


class Targets(NamedTuple):
    """Padded per-batch ground truth (N slots)."""

    labels: torch.Tensor        # (B, N) int
    boxes: torch.Tensor         # (B, N, 4) cxcywh normalised
    masks: torch.Tensor         # (B, N, Hm, Wm) float 0/1 at mask_out_stride
    positive_map: torch.Tensor  # (B, N, L) row-normalised token map
    is_thing: torch.Tensor      # (B, N) bool
    valid: torch.Tensor         # (B, N) bool


def gather_targets(t: Targets, assign: torch.Tensor):
    """Per-query matched GT fields for (B, Q) ``assign``: (matched, boxes,
    positive map, is_thing, clamped index)."""
    idx = assign.clamp(0, t.boxes.shape[1] - 1).long()
    take = lambda x: x.gather(1, idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(
        idx.shape + x.shape[2:]))
    return assign >= 0, take(t.boxes), take(t.positive_map), t.is_thing.gather(1, idx), idx


def _focal(x: torch.Tensor, tgt: torch.Tensor, alpha: float, gamma: float) -> torch.Tensor:
    p = x.sigmoid()
    ce = x.clamp(min=0) - x * tgt + torch.log1p(torch.exp(-x.abs()))
    p_t = p * tgt + (1 - p) * (1 - tgt)
    return (alpha * tgt + (1 - alpha) * (1 - tgt)) * ce * (1 - p_t) ** gamma


def loss_labels_vl(logits, assign, targets: Targets, text_mask, num_boxes,
                   alpha: float = 0.25, gamma: float = 2.0) -> torch.Tensor:
    """Token sigmoid focal loss against the BINARY positive map of each query's
    matched GT (reference loss_labelsVL), over valid tokens, / num_boxes."""
    matched, _, pos_map, _, _ = gather_targets(targets, assign)
    tgt = (matched[..., None] & (pos_map > 0)).float()
    loss = _focal(logits.float(), tgt, alpha, gamma) * (text_mask[:, None, :] > 0)
    return loss.sum() / num_boxes.clamp(min=count_unit())


def pair_counts(assign: torch.Tensor, targets: Targets) -> torch.Tensor:
    """(..., 2) matched pairs and matched things of (..., B, Q) assignments,
    each summed over (B, Q)."""
    idx = assign.clamp(0, targets.is_thing.shape[1] - 1).long()
    matched = assign >= 0
    thing = targets.is_thing.expand(idx.shape[:-2] + targets.is_thing.shape).gather(-1, idx)
    return torch.stack([matched.flatten(-2).sum(-1), (matched & thing).flatten(-2).sum(-1)],
                       -1).float()


def loss_boxes(boxes, iou_logits, assign, targets: Targets, num_boxes,
               counts: torch.Tensor) -> Dict[str, torch.Tensor]:
    """L1 + GIoU on matched pairs, weighted to things only (renormalised), and
    the IoU head's BCE against the detached pairwise IoU. ``counts``: the
    (pairs, things) of ``pair_counts``, reduced by ``global_count``."""
    matched, gt_boxes, _, is_thing, _ = gather_targets(targets, assign)
    m = matched.float()
    thing = is_thing.float() * m
    n_pairs, n_thing = counts.unbind(-1)
    unit = count_unit()
    adj = n_pairs / n_thing.clamp(min=1e-6 * unit)
    src, tgt = boxes.float(), gt_boxes.float()
    l1 = (src - tgt).abs().sum(-1) * thing * adj
    giou = elementwise_generalized_box_iou(box_cxcywh_to_xyxy(src), box_cxcywh_to_xyxy(tgt))
    out = {"loss_bbox": (l1 * m).sum() / num_boxes.clamp(min=unit),
           "loss_giou": ((1.0 - giou) * thing * adj * m).sum() / num_boxes.clamp(min=unit)}
    if iou_logits is not None:
        ious = elementwise_box_iou(box_cxcywh_to_xyxy(src), box_cxcywh_to_xyxy(tgt)).detach()
        logit = iou_logits[..., 0].float()
        bce = logit.clamp(min=0) - logit * ious + torch.log1p(torch.exp(-logit.abs()))
        out["loss_boxiou"] = (bce * thing * adj * m).sum() / n_pairs.clamp(min=unit)
    return out


def loss_masks_pointwise(keys: Keys, mask_logits, gt_masks, pair_valid, num_boxes,
                         cfg: LossConfig) -> Dict[str, torch.Tensor]:
    """Point-sampled focal + dice on (B, K, H, W) matched masks, at
    ``cfg.num_points`` uncertainty-oversampled points."""
    b, k, h, w = mask_logits.shape
    ml = mask_logits.reshape(b * k, h, w).float()
    gm = gt_masks.reshape(b * k, *gt_masks.shape[2:])
    coords = uncertain_point_coords(keys, ml.detach(), cfg.num_points, cfg.oversample_ratio,
                                    cfg.importance_sample_ratio)
    logits = point_sample(ml, coords)
    with torch.no_grad():
        labels = point_sample(gm, coords)
    v = pair_valid.reshape(b * k).float()
    unit = count_unit()
    focal = (_focal(logits, labels, 0.25, 2.0).mean(-1) * v).sum() / num_boxes.clamp(min=unit)
    p = logits.sigmoid()
    numer = 2 * (p * labels * v[:, None]).sum(-1)
    denom = (p * v[:, None]).sum(-1) + (labels * v[:, None]).sum(-1)
    dice = ((1 - (numer + 1) / (denom + 1)) * v).sum() / num_boxes.clamp(min=unit)
    return {"loss_mask": focal, "loss_dice": dice}


def select_matched(assign: torch.Tensor, k: int):
    """Up to k matched query slots per image, in query order: (sel_q (B, k),
    sel_valid (B, k) bool)."""
    b, q = assign.shape
    ar = torch.arange(q, device=assign.device)[None]
    key = torch.where(assign >= 0, ar, q + ar)
    order = key.argsort(dim=1, stable=True)[:, :k]
    return order, (assign >= 0).gather(1, order)


def predict_matched_masks(sel_q, ctrl_params_layer, refs_layer, mask_feats, image_sizes,
                          weight_nums, bias_nums, channels: int, rel_coord: bool = True):
    """Dynamic-conv masks (B, K, H4, W4) for the selected (B, K) query slots of one layer."""
    ctrl = ctrl_params_layer.gather(1, sel_q[..., None].expand(-1, -1, ctrl_params_layer.shape[-1]))
    refs = refs_layer[..., :2].gather(1, sel_q[..., None].expand(-1, -1, 2))
    scale = torch.stack([image_sizes[:, 1], image_sizes[:, 0]], -1).float()
    return dynamic_mask_with_coords(mask_feats, refs * scale[:, None, :], ctrl, weight_nums,
                                    bias_nums, channels, mask_feat_stride=8, mask_out_stride=4,
                                    rel_coord=rel_coord)


def _sigmoid_f32(x):
    return x.detach().float().sigmoid()


def _flat(x: torch.Tensor) -> torch.Tensor:
    """(L, B, ...) -> (L*B, ...)."""
    return x.reshape((-1,) + x.shape[2:])


def _rep(x: torch.Tensor, n_layers: int) -> torch.Tensor:
    """(B, ...) repeated for each of n_layers -> (L*B, ...), layer-major."""
    return x[None].expand((n_layers,) + x.shape).reshape((-1,) + x.shape[1:])


def criterion_pass(keys: Keys, layer_outputs: Dict[str, torch.Tensor], targets: Targets,
                   text_mask, mask_feats, image_sizes, cfg: LossConfig, weight_nums, bias_nums,
                   dyn_channels: int = 8, matcher: str = "ota",
                   fixed_assign: Optional[torch.Tensor] = None, max_matched: int = 100,
                   with_masks: bool = True, ota_normalize_by_matches: bool = True,
                   pixel_feats: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """One criterion pass (fg, bg, gt or a MaskDINO pass) over all decoder layers.

    ``layer_outputs`` holds (layers, B, Q, ...) tensors already sliced to this
    pass's queries: "classes", "boxes", optionally "ious", and the masks as
    "ctrl" + "refs" (the dynamic-conv head) or "mask_embeds" with
    ``pixel_feats`` (B, H, W, C) (MaskDINO's linear head). ``matcher`` is "ota",
    "hungarian" (with point-sampled mask costs) or "fixed" (``fixed_assign``).
    Losses of layer i < L-1 carry the suffix ``_i``."""
    classes = layer_outputs["classes"]
    t_cls = classes.shape[-1]
    if targets.positive_map.shape[-1] != t_cls:
        # grounding pools the prompt to one channel: slice the map and mask to it
        targets = targets._replace(positive_map=targets.positive_map[..., :t_cls])
        if text_mask is not None:
            text_mask = text_mask[..., :t_cls]
    boxes = layer_outputs["boxes"]
    ious = layer_outputs.get("ious")
    ctrl = layer_outputs.get("ctrl")
    refs = layer_outputs.get("refs")
    mask_embeds = layer_outputs.get("mask_embeds")
    n_layers, b = classes.shape[:2]
    ksplit = [k.split(2) for k in keys.split(n_layers)]
    k_match_all = [k[0] for k in ksplit]
    k_pts_all = [k[1] for k in ksplit]

    # ---- matching for all layers up front, batched over (layers x images) ----
    with torch.no_grad():
        if matcher == "fixed":
            assign_all = fixed_assign[None].expand((n_layers,) + fixed_assign.shape)
        elif matcher == "ota":
            assign_all = simota_match(
                _sigmoid_f32(_flat(classes)), _flat(boxes).float(),
                _rep(targets.boxes, n_layers), _rep(targets.positive_map, n_layers),
                _rep(targets.valid, n_layers)).reshape(n_layers, b, -1)
        else:
            n_pts = min(cfg.num_points, 2048)
            costs = []
            for lid in range(n_layers):
                bkeys = k_match_all[lid].split(b * data_size())
                if mask_embeds is not None:
                    mc = mask_match_costs_embed(bkeys, mask_embeds[lid], pixel_feats,
                                                targets.masks, n_pts, cfg.mask_weight,
                                                cfg.dice_weight)
                else:
                    q = classes.shape[2]
                    all_q = torch.arange(q, device=classes.device)[None].expand(b, q)
                    ml = predict_matched_masks(all_q, ctrl[lid], refs[lid], mask_feats,
                                               image_sizes, weight_nums, bias_nums, dyn_channels)
                    mc = mask_match_costs(bkeys, ml, targets.masks, n_pts, cfg.mask_weight,
                                          cfg.dice_weight)
                    del ml
                costs.append(hungarian_vl_costs(
                    _sigmoid_f32(classes[lid]), boxes[lid].detach().float(), targets.boxes,
                    targets.positive_map, cfg.class_weight, cfg.bbox_weight, cfg.giou_weight,
                    mask_cost=mc))
            assign_all = auction_assignment(torch.cat(costs), _rep(targets.valid, n_layers)
                                            ).reshape(n_layers, b, -1)

    # the GT count and each layer's (pairs, things), over the global batch
    counts = global_count(torch.cat([targets.valid.sum().float()[None],
                                     pair_counts(assign_all, targets).reshape(-1)]))
    num_gt, layer_counts = counts[0], counts[1:].reshape(n_layers, 2)
    unit = count_unit()
    stacked: Dict[str, list] = {}
    for lid in range(n_layers):
        assign = assign_all[lid]
        matched_count = layer_counts[lid, 0]
        if matcher == "fixed":
            num_boxes = matched_count.clamp(min=unit)
        elif matcher == "ota" and ota_normalize_by_matches:
            num_boxes = matched_count
        else:
            num_boxes = num_gt.clamp(min=unit)
        out = {"loss_ce": loss_labels_vl(classes[lid], assign, targets, text_mask, num_boxes,
                                         alpha=cfg.focal_alpha, gamma=cfg.focal_gamma)}
        out.update(loss_boxes(boxes[lid], ious[lid] if ious is not None else None, assign,
                              targets, num_boxes, counts=layer_counts[lid]))
        if with_masks and (ctrl is not None or mask_embeds is not None):
            sel_q, sel_valid = select_matched(assign, max_matched)
            # mask supervision past max_matched is dropped; 'matchdrop' counts it
            out["matchdrop"] = ((assign >= 0).sum(1) - max_matched).clamp(min=0).float().sum()
            if mask_embeds is not None:
                emb_sel = mask_embeds[lid].float().gather(
                    1, sel_q[..., None].expand(-1, -1, mask_embeds.shape[-1]))
                pred_masks = torch.einsum("bkc,bhwc->bkhw", emb_sel, pixel_feats.float())
            else:
                pred_masks = predict_matched_masks(sel_q, ctrl[lid], refs[lid], mask_feats,
                                                   image_sizes, weight_nums, bias_nums,
                                                   dyn_channels)
            gt_idx = assign.gather(1, sel_q).clamp(0, targets.masks.shape[1] - 1)
            gt_m = targets.masks.gather(1, gt_idx[..., None, None].expand(
                -1, -1, *targets.masks.shape[2:]))
            ph, pw = pred_masks.shape[2:]
            gt_m = gt_m[:, :, :ph, :pw]
            gt_m = F.pad(gt_m, (0, pw - gt_m.shape[3], 0, ph - gt_m.shape[2]))
            out.update(loss_masks_pointwise(k_pts_all[lid], pred_masks, gt_m, sel_valid,
                                            num_boxes, cfg))
        for name, v in out.items():
            stacked.setdefault(name, []).append(v)
    losses: Dict[str, torch.Tensor] = {}
    for name, vals in stacked.items():
        for lid in range(n_layers):
            losses[name if lid == n_layers - 1 else f"{name}_{lid}"] = vals[lid]
    return losses


def encoder_loss_pass(enc_class, enc_boxes, targets: Targets, text_mask, cfg: LossConfig,
                      still_cls: bool = True) -> Dict[str, torch.Tensor]:
    """Two-stage encoder-proposal losses (the reference's '_enc' losses):
    auction matching over all encoder positions, class and box losses, no masks.
    enc_class (B, S, K) f32 logits; enc_boxes (B, S, 4) sigmoided coords."""
    b, k = enc_class.shape[0], enc_class.shape[-1]
    if still_cls or k == 1:
        pm = torch.ones(targets.positive_map.shape[:2] + (1,), device=enc_class.device)
        tm = torch.ones(b, 1, device=enc_class.device)
    else:
        pm, tm = targets.positive_map, text_mask
    t = targets._replace(positive_map=pm)
    with torch.no_grad():
        assign = hungarian_vl_match(_sigmoid_f32(enc_class), enc_boxes.detach().float(),
                                    targets.boxes, pm, targets.valid, cfg.class_weight,
                                    cfg.bbox_weight, cfg.giou_weight)
    counts = global_count(torch.cat([targets.valid.sum().float()[None],
                                     pair_counts(assign, t)]))
    num_boxes = counts[0].clamp(min=count_unit())
    out = {"loss_ce_enc": loss_labels_vl(enc_class, assign, t, tm, num_boxes,
                                         alpha=cfg.focal_alpha, gamma=cfg.focal_gamma)}
    out.update({f"{kk}_enc": v for kk, v in loss_boxes(enc_boxes, None, assign, t, num_boxes,
                                                        counts=counts[1:]).items()})
    return out


def merge_loss_dicts(dicts: Sequence[Dict[str, torch.Tensor]],
                     weights: Sequence[float]) -> Dict[str, torch.Tensor]:
    """Weighted merge (reference ddetrs_dn.py merge_dict)."""
    out: Dict[str, torch.Tensor] = {}
    for d, w in zip(dicts, weights):
        for k, v in d.items():
            out[k] = out.get(k, 0.0) + v * w
    return out


def apply_weight_dict(losses: Dict[str, torch.Tensor], cfg: LossConfig):
    """Total = sum of weighted losses (reference weight dict, hipie_img.py)."""
    base = {"loss_ce": cfg.class_weight, "loss_bbox": cfg.bbox_weight,
            "loss_giou": cfg.giou_weight, "loss_mask": cfg.mask_weight,
            "loss_dice": cfg.dice_weight, "loss_boxiou": cfg.iou_head_weight}
    total = 0.0
    for k, v in losses.items():
        for name, w in base.items():
            if k == name or k.startswith(name + "_"):
                total = total + w * v
                break
    return total
