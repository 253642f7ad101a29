"""Language-derived background (stuff) queries for training.

Counterpart of hipie_tpu/train/bg_lang.py (reference ddetrs_dn.py
prepare_bg_queries_lan :1109-1148 and its criterion pass :719-729). With
``model.bg_query_from_lang`` the decoder gets ``num_slots`` extra content
queries, shared across the batch and given zero-box references: slot k holds
the k-th stuff class present in the batch (classes in order of their first
occurrence in flattened (b, n) order), as pooling weights over that element's
raw BERT tokens (its positive map, normalised); every slot left without a
class is one random real token that no valid GT (thing or stuff) covers. The
slots are supervised against the stuff GTs by fixed class identity: a GT's
slot is its class's. Where one image holds two stuff GTs of one class, the
slot keeps the last, as JAX's ``.at[].set`` does.

The negatives are JAX's Gumbel top-k: a Gumbel draw per (b, l) token built
from ``keys.uniform`` as ``jax.random.gumbel`` builds it
(-log(-log(max(u, tiny)))), masked to the eligible tokens, and the
``num_slots`` largest taken with ties to the lower index, as
``jax.lax.top_k`` takes them. A key that replays JAX's uniform draw therefore
gives JAX's negatives.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from hipie_plain.utils.rng import Keys


class BgLangQueries(NamedTuple):
    weights: torch.Tensor   # (K, B, L) f32 pooling weights over the raw lang hidden
    assign: torch.Tensor    # (B, K) int64 fixed matching: GT index or -1


@torch.no_grad()
def prepare_bg_lang_queries(keys: Keys, labels: torch.Tensor, positive_map: torch.Tensor,
                            is_thing: torch.Tensor, valid: torch.Tensor,
                            lang_mask: torch.Tensor, num_classes: int,
                            num_slots: int) -> BgLangQueries:
    """labels (B, N) int; positive_map (B, N, L) f32; is_thing, valid (B, N)
    bool; lang_mask (B, L) 1 = real token. Returns the slots' pooling weights
    (K, B, L) and the fixed assignment (B, K) of each slot to a GT or -1."""
    b, n = labels.shape
    L = positive_map.shape[-1]
    bn = b * n
    dev = labels.device
    stuff = valid & ~is_thing
    flat_lbl = labels.reshape(bn).long().clamp(0, num_classes - 1)
    order = torch.arange(bn, device=dev)
    cand = torch.where(stuff.reshape(bn), order, torch.full_like(order, bn))
    first = torch.full((num_classes,), bn, dtype=torch.long, device=dev).scatter_reduce(
        0, flat_lbl, cand, reduce="amin")                                  # (C,)
    present = first < bn
    rank = present.long().cumsum(0) - 1
    slot_of_class = torch.where(present & (rank < num_slots), rank, torch.full_like(rank, -1))

    # each slot's source (b, n); a class without a slot goes to the extra row K
    src = torch.full((num_slots + 1,), bn, dtype=torch.long, device=dev)
    src[torch.where(slot_of_class >= 0, slot_of_class, num_slots)] = first
    src = src[:num_slots]
    has_class = src < bn
    safe_src = src.clamp(max=bn - 1)
    w_pos = positive_map.reshape(bn, L)[safe_src].float()
    w_pos = w_pos / w_pos.sum(-1, keepdim=True).clamp(min=1e-9)
    b_onehot = (safe_src // n)[:, None] == torch.arange(b, device=dev)[None]   # (K, B)
    w_class = w_pos[:, None, :] * (b_onehot & has_class[:, None])[..., None]   # (K, B, L)

    # negatives: one random real token a slot that no valid GT covers
    covered = (positive_map * valid[..., None]).sum(1) > 1e-6                  # (B, L)
    neg_ok = (lang_mask > 0) & ~covered
    u = keys.uniform((b * L,), device=dev).to(dev)
    g = -torch.log(-torch.log(u.clamp(min=torch.finfo(torch.float32).tiny)))
    scores = torch.where(neg_ok.reshape(-1), g, torch.full_like(g, -float("inf")))
    neg_idx = torch.sort(scores, descending=True, stable=True).indices[:num_slots]
    w_neg = torch.zeros((num_slots, b, L), device=dev)
    w_neg[torch.arange(num_slots, device=dev), neg_idx // L, neg_idx % L] = 1.0
    weights = torch.where(has_class[:, None, None], w_class, w_neg)

    # fixed matching: slot k of image b takes the last stuff GT of its class there
    slot_per_gt = slot_of_class[flat_lbl].reshape(b, n)
    slot_per_gt = torch.where(stuff, slot_per_gt, torch.full_like(slot_per_gt, -1))
    slots = torch.arange(num_slots, device=dev)
    gt_idx = torch.arange(n, device=dev)
    hit = slot_per_gt[:, None, :] == slots[None, :, None]                      # (B, K, N)
    assign = torch.where(hit, gt_idx, torch.full_like(gt_idx, -1)).amax(-1)
    return BgLangQueries(weights=weights, assign=assign)
