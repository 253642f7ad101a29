"""BoxInst box-supervised mask losses: projection and pairwise color
consistency.

Counterpart of hipie_tpu/losses/boxinst.py (reference deformable_detr.py
loss_masks_boxinst :526-600, compute_project_term :881-890,
compute_pairwise_term :893-920, and hipie_img.py unfold_wo_center /
get_images_color_similarity :1056-1097):

  * projection: dice between the per-axis max-projections of the mask
    probabilities and of the GT box bitmask;
  * pairwise: -log P(same label) over a k x k dilated neighbourhood (centre
    removed), counted where the LAB color similarity reaches the threshold
    inside the box bitmask, warmed up linearly over ``warmup_iters``
    (clip(iteration / warmup_iters, 0, 1)).

A neighbour outside the image is zero (``F.unfold``'s zero padding, JAX's
masked roll); in the pairwise term that zero is a log-probability, so an
out-of-image neighbour counts as certain. As in JAX, nothing calls these from
the criterion.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F


def shift_stack(x: torch.Tensor, kernel_size: int, dilation: int) -> torch.Tensor:
    """(..., H, W) -> (..., K^2-1, H, W): the dilated neighbours of each
    position, centre removed, in row-major offset order; zero outside."""
    h, w = x.shape[-2:]
    r = kernel_size // 2
    pad = r * dilation
    xp = F.pad(x, (pad, pad, pad, pad))
    outs = []
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            if dy == 0 and dx == 0:
                continue
            y0, x0 = pad + dy * dilation, pad + dx * dilation
            outs.append(xp[..., y0:y0 + h, x0:x0 + w])
    return torch.stack(outs, dim=-3)


def images_color_similarity(image_lab: torch.Tensor, kernel_size: int = 3,
                            dilation: int = 2) -> torch.Tensor:
    """(H, W, 3) LAB image -> (K^2-1, H, W) exp(-||c_i - c_j|| / 2)."""
    x = image_lab.permute(2, 0, 1).float()
    diff = x[:, None] - shift_stack(x, kernel_size, dilation)
    return torch.exp(-torch.linalg.vector_norm(diff, dim=0) * 0.5)


def _dice_coefficient(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """1 - 2 |p g| / (|p|^2 + |g|^2 + 1e-5) over all but the first axis."""
    p = pred.reshape(pred.shape[0], -1)
    g = gt.reshape(gt.shape[0], -1)
    inter = (p * g).sum(-1)
    union = (p ** 2).sum(-1) + (g ** 2).sum(-1) + 1e-5
    return 1.0 - 2 * inter / union


def project_term(mask_probs: torch.Tensor, box_bitmasks: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
    """mask_probs, box_bitmasks (N, H, W): dice of the x and y max-projections,
    averaged over the valid slots (at least one)."""
    ly = _dice_coefficient(mask_probs.amax(dim=1), box_bitmasks.amax(dim=1))
    lx = _dice_coefficient(mask_probs.amax(dim=2), box_bitmasks.amax(dim=2))
    v = valid.float()
    return ((lx + ly) * v).sum() / v.sum().clamp(min=1.0)


def pairwise_term(mask_logits: torch.Tensor, kernel_size: int = 3,
                  dilation: int = 2) -> torch.Tensor:
    """(N, H, W) logits -> (N, K^2-1, H, W) -log P(same label as each neighbour)."""
    log_fg = F.logsigmoid(mask_logits)
    log_bg = F.logsigmoid(-mask_logits)
    same_fg = log_fg[:, None] + shift_stack(log_fg, kernel_size, dilation)
    same_bg = log_bg[:, None] + shift_stack(log_bg, kernel_size, dilation)
    m = torch.maximum(same_fg, same_bg)
    return -(torch.log(torch.exp(same_fg - m) + torch.exp(same_bg - m)) + m)


def boxinst_losses(mask_logits: torch.Tensor, box_bitmasks: torch.Tensor,
                   color_similarity: torch.Tensor, valid: torch.Tensor,
                   iteration, pairwise_color_thresh: float = 0.3,
                   warmup_iters: int = 10000, kernel_size: int = 3,
                   dilation: int = 2) -> Dict[str, torch.Tensor]:
    """{"loss_prj", "loss_pairwise"} of matched-query mask logits (N, H, W)
    against GT box bitmasks (N, H, W), with the image's color similarity
    (N, K^2-1, H, W), the slots' validity (N,) and the training iteration."""
    logits = mask_logits.float()
    boxes = box_bitmasks.float()
    loss_prj = project_term(torch.sigmoid(logits), boxes, valid)
    pw = pairwise_term(logits, kernel_size, dilation)
    weights = ((color_similarity >= pairwise_color_thresh).float() * boxes[:, None]
               * valid.float()[:, None, None, None])
    loss_pw = (pw * weights).sum() / weights.sum().clamp(min=1.0)
    it = torch.as_tensor(iteration, dtype=torch.float32, device=logits.device)
    warm = (it / warmup_iters).clamp(0.0, 1.0)
    return {"loss_prj": loss_prj, "loss_pairwise": loss_pw * warm}
