"""Matchers: simOTA dynamic-k and auction-based Hungarian assignment.

Counterpart of hipie_tpu/losses/matcher.py (reference matcher.py
HungarianMatcherVL.forward_ota / dynamic_k_matching and HungarianMatcherVL /
HungarianMatcherBG with point-sampled mask costs). The JAX package replaces the
reference's exact Hungarian solve on the host by a forward auction with
eps-scaling on the device; the port runs the same auction and the same simOTA
repair loop, step for step, so that the assignments are JAX's (an exact solver
such as scipy's gives other ones where costs nearly tie).

Every function takes a leading batch dim G (layers x images, flattened), as
JAX's vmaps do. Assignments are (G, Q) int64: the matched GT index or -1.

The two solvers are loops whose bodies change nothing once every valid GT is
matched. The port runs them eagerly on the device and asks the host whether all
G problems are done only every ``CHECK_EVERY`` iterations, so a solve costs a
few host syncs instead of one per iteration; ``HOST_SYNCS`` counts them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from hipie_torch.losses.point_features import point_sample
from hipie_torch.ops.box_ops import box_cxcywh_to_xyxy, box_iou, generalized_box_iou
from hipie_torch.parallel.mesh import shard_rows
from hipie_torch.utils.trace import count

BIG = 1e5
CHECK_EVERY = 32          # loop iterations between two convergence checks on the host
HOST_SYNCS = [0]          # convergence checks made (each a device-to-host sync)


def _done(flag: torch.Tensor) -> bool:
    HOST_SYNCS[0] += 1
    count("host_sync.matcher_done")
    return not bool(flag.item())


def focal_token_cost(prob: torch.Tensor, positive_map: torch.Tensor,
                     alpha: float = 0.25, gamma: float = 2.0) -> torch.Tensor:
    """(G, Q, L) sigmoid probs x (G, N, L) normalised positive maps -> (G, Q, N):
    the mean over each GT's tokens of the focal pos - neg cost, as a matmul."""
    p = prob.float().clamp(1e-8, 1 - 1e-8)
    neg = (1 - alpha) * (p ** gamma) * (-torch.log(1 - p))
    pos = alpha * ((1 - p) ** gamma) * (-torch.log(p))
    return (pos - neg) @ positive_map.float().transpose(-1, -2)


def in_boxes_info(pred_boxes: torch.Tensor, gt_boxes: torch.Tensor,
                  expanded_strides: int = 32, center_radius: float = 2.5):
    """Centre-prior masks: (candidate (G, Q), in-box-and-centre (G, Q, N))."""
    gt_xyxy = box_cxcywh_to_xyxy(gt_boxes)[:, None]               # (G, 1, N, 4)
    cx, cy = pred_boxes[..., 0:1], pred_boxes[..., 1:2]           # (G, Q, 1)
    in_box = ((cx > gt_xyxy[..., 0]) & (cx < gt_xyxy[..., 2])
              & (cy > gt_xyxy[..., 1]) & (cy < gt_xyxy[..., 3]))
    r = center_radius / expanded_strides
    gc = gt_boxes[:, None]
    in_center = ((cx > gc[..., 0] - r) & (cx < gc[..., 0] + r)
                 & (cy > gc[..., 1] - r) & (cy < gc[..., 1] + r))
    return in_box.any(-1) | in_center.any(-1), in_box & in_center


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Bool one-hot of (...) int indices over n; an index outside [0, n) gives
    the zero vector, as jax.nn.one_hot."""
    return idx[..., None] == torch.arange(n, device=idx.device)


def _resolve(match: torch.Tensor, cost: torch.Tensor) -> torch.Tensor:
    """A query matched to more than one GT keeps only its least-cost GT."""
    n = match.shape[-1]
    best = torch.where(match, cost, torch.full_like(cost, BIG * 100)).argmin(-1)
    return torch.where((match.sum(-1) > 1)[..., None], _one_hot(best, n) & match, match)


@torch.no_grad()
def simota_match(prob: torch.Tensor, pred_boxes: torch.Tensor, gt_boxes: torch.Tensor,
                 positive_map: torch.Tensor, gt_valid: torch.Tensor,
                 topk_candidates: int = 10) -> torch.Tensor:
    """simOTA dynamic-k matching -> (G, Q) assigned GT index or -1.

    prob (G, Q, L) sigmoid token probs; pred_boxes (G, Q, 4) and gt_boxes
    (G, N, 4) cxcywh; positive_map (G, N, L); gt_valid (G, N) bool."""
    q, n = prob.shape[1], gt_boxes.shape[1]
    candidate, in_both = in_boxes_info(pred_boxes, gt_boxes)
    pxy, gxy = box_cxcywh_to_xyxy(pred_boxes), box_cxcywh_to_xyxy(gt_boxes)
    ious = box_iou(pxy, gxy)
    cost = focal_token_cost(prob, positive_map) + 3.0 * -generalized_box_iou(pxy, gxy)
    cost = cost + 100.0 * (~in_both).float()
    cost = cost + torch.where(candidate[..., None], 0.0, 10000.0)
    cost = torch.where(gt_valid[:, None, :], cost, torch.full_like(cost, BIG * 10))

    # dynamic k: per GT, k = max(int(sum of its top-10 IoUs), 1)
    top_ious = ious.transpose(1, 2).topk(min(q, topk_candidates), dim=-1).values
    dynamic_ks = top_ious.sum(-1).int().clamp(min=1)                # (G, N)
    # query i matches GT j iff i's rank in column j's cost order is < k_j
    ranks = cost.argsort(dim=1, stable=True).argsort(dim=1, stable=True)
    match = (ranks < dynamic_ks[:, None, :]) & gt_valid[:, None, :]
    match = _resolve(match, cost)

    # repair loop: an orphaned valid GT takes its least-cost unmatched query, then
    # conflicts are resolved again; at most n iterations
    it = 0
    while it < n:
        for _ in range(min(CHECK_EVERY, n - it)):
            q_matched = match.sum(-1) > 0
            cost_r = cost + torch.where(q_matched[..., None], 100000.0, 0.0)
            unmatched_gt = gt_valid & (match.sum(1) == 0)
            pick = cost_r.argmin(1)                                  # (G, N)
            add = _one_hot(pick, q).transpose(1, 2) & unmatched_gt[:, None, :]
            match = _resolve(match | add, cost)
            it += 1
        if _done((gt_valid & (match.sum(1) == 0)).any()):
            break
    assigned = match.sum(-1) > 0
    return torch.where(assigned, match.int().argmax(-1), -1)


@torch.no_grad()
def auction_assignment(cost: torch.Tensor, gt_valid: torch.Tensor, eps: float = 1e-3,
                       max_iters: int = 2000) -> torch.Tensor:
    """One-to-one assignment minimising (G, Q, N) ``cost`` by a forward auction
    -> (G, Q) GT index or -1; every valid GT column ends up owning one query."""
    g, qn, n = cost.shape
    dev = cost.device
    value = torch.where(gt_valid[:, None, :], -cost.float(), torch.full_like(cost, -BIG,
                                                                             dtype=torch.float32))
    scale = torch.where(gt_valid[:, None, :], cost.float(), 0.0).abs().amax((1, 2)).clamp(min=1.0)
    eps_val = (eps * scale)[:, None]                                  # (G, 1)
    net_value = value.transpose(1, 2)                                # (G, N, Q)
    prices = torch.zeros(g, qn, dtype=torch.float32, device=dev)
    owner = torch.full((g, qn), -1, dtype=torch.long, device=dev)
    assigned = torch.zeros(g, n, dtype=torch.bool, device=dev)
    count("host_sync.auction_neg_inf")      # a blocking copy to the card
    neg_inf = torch.tensor(float("-inf"), device=dev)
    it = 0
    while it < max_iters:
        for _ in range(min(CHECK_EVERY, max_iters - it)):
            # every unassigned valid GT bids for its best query at once
            net = net_value - prices[:, None, :]
            top1, best_q = net.max(-1)                               # (G, N)
            is_best = _one_hot(best_q, qn)                           # (G, N, Q)
            top2 = torch.where(is_best, neg_inf, net).amax(-1)
            bid = top1 - (top2 if qn > 1 else 0.0) + eps_val
            bidding = gt_valid & ~assigned
            bid_matrix = torch.where(is_best & bidding[..., None], bid[..., None], neg_inf)
            win_bid, win_gt = bid_matrix.max(1)                      # (G, Q)
            got_bid = torch.isfinite(win_bid)
            displaced = owner
            new_owner = torch.where(got_bid, win_gt, owner)
            newly = (_one_hot(win_gt, n) & got_bid[..., None]).any(1)         # (G, N)
            was_displaced = got_bid & (displaced >= 0) & (displaced != new_owner)
            freed = (_one_hot(displaced, n) & was_displaced[..., None]).any(1)
            assigned = (assigned | newly) & ~(freed & ~newly)
            prices = torch.where(got_bid, prices + win_bid, prices)
            owner = new_owner
            it += 1
        if _done((gt_valid & ~assigned).any()):
            break
    return owner


def hungarian_vl_costs(prob, pred_boxes, gt_boxes, positive_map, cost_class: float = 2.0,
                       cost_bbox: float = 5.0, cost_giou: float = 2.0,
                       mask_cost: Optional[torch.Tensor] = None) -> torch.Tensor:
    """HungarianMatcherVL cost matrices (G, Q, N)."""
    c = cost_class * focal_token_cost(prob, positive_map)
    c = c + cost_bbox * (pred_boxes[:, :, None, :] - gt_boxes[:, None, :, :]).abs().sum(-1)
    c = c - cost_giou * generalized_box_iou(box_cxcywh_to_xyxy(pred_boxes),
                                            box_cxcywh_to_xyxy(gt_boxes))
    if mask_cost is not None:
        c = c + mask_cost
    return c


def hungarian_vl_match(prob, pred_boxes, gt_boxes, positive_map, gt_valid,
                       cost_class: float = 2.0, cost_bbox: float = 5.0, cost_giou: float = 2.0,
                       mask_cost: Optional[torch.Tensor] = None) -> torch.Tensor:
    """HungarianMatcherVL costs and the auction solve -> (G, Q) GT index or -1."""
    c = hungarian_vl_costs(prob, pred_boxes, gt_boxes, positive_map, cost_class, cost_bbox,
                           cost_giou, mask_cost)
    return auction_assignment(c, gt_valid)


def _mask_costs(mp: torch.Tensor, tp: torch.Tensor, num_points: int, cost_mask: float,
                cost_dice: float) -> torch.Tensor:
    """Sigmoid-CE and dice costs (G, Q, N) from (G, Q, P) logits and (G, N, P)
    labels at the same points (Mask2Former formulation)."""
    tpt = tp.transpose(1, 2)
    ce = (F.softplus(-mp) @ tpt + F.softplus(mp) @ (1 - tpt)) / num_points
    m = mp.sigmoid()
    dice = 1 - (2 * (m @ tpt) + 1) / (m.sum(-1)[..., None] + tp.sum(-1)[:, None, :] + 1)
    return cost_mask * ce + cost_dice * dice


def _match_coords(keys, num_points: int, dev) -> torch.Tensor:
    """(G, P, 2) uniform points, one key of ``keys`` each. Under data
    parallelism ``keys`` are the global batch's (G x the group's size): every
    rank draws them all, in lockstep, and keeps its own G."""
    return shard_rows(torch.stack([k.uniform((num_points, 2), dev) for k in keys]))


@torch.no_grad()
def mask_match_costs(keys, mask_logits: torch.Tensor, gt_masks: torch.Tensor,
                     num_points: int = 12544, cost_mask: float = 5.0,
                     cost_dice: float = 5.0) -> torch.Tensor:
    """Point-sampled sigmoid-CE + dice matching costs (matcher_mask.py).

    keys: G keys, one per problem (the global batch's under data
    parallelism); mask_logits (G, Q, H, W); gt_masks (G, N, H', W') -> (G, Q, N)."""
    coords = _match_coords(keys, num_points, mask_logits.device)
    mp = point_sample(mask_logits, coords[:, None].expand(-1, mask_logits.shape[1], -1, -1))
    tp = point_sample(gt_masks, coords[:, None].expand(-1, gt_masks.shape[1], -1, -1))
    return _mask_costs(mp, tp, num_points, cost_mask, cost_dice)


@torch.no_grad()
def mask_match_costs_embed(keys, mask_embeds: torch.Tensor, pixel_feats: torch.Tensor,
                           gt_masks: torch.Tensor, num_points: int = 12544,
                           cost_mask: float = 5.0, cost_dice: float = 5.0) -> torch.Tensor:
    """mask_match_costs for a linear mask head (MaskDINO: mask = emb . F).
    Sampling is linear, so the feature map is sampled once and contracted with
    the (G, Q, C) embeddings; pixel_feats (G, H, W, C)."""
    coords = _match_coords(keys, num_points, mask_embeds.device)
    fc = pixel_feats.float().permute(0, 3, 1, 2)                      # (G, C, H, W)
    fp = point_sample(fc, coords[:, None].expand(-1, fc.shape[1], -1, -1))   # (G, C, P)
    mp = mask_embeds.float() @ fp
    tp = point_sample(gt_masks, coords[:, None].expand(-1, gt_masks.shape[1], -1, -1))
    return _mask_costs(mp, tp, num_points, cost_mask, cost_dice)
