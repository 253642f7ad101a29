"""Point-sampled mask loss utilities (counterpart of
hipie_tpu/losses/point_features.py; reference detectron2 point_rend
point_features.py): bilinear sampling at normalised (x, y) coordinates with
``align_corners=False`` and zero padding, and the uncertainty-oversampled point
pick (uncertainty = -|logit|, oversampling x3, importance ratio 0.75).
"""

from __future__ import annotations

import torch

from hipie_plain.ops.bilinear import bilinear_sample
from hipie_plain.utils.rng import Keys, batch_uniform


def point_sample(masks: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Sample (..., H, W) masks at (..., P, 2) coords in [0, 1] -> (..., P) f32.
    Leading dims of ``masks`` and ``coords`` must agree."""
    h, w = masks.shape[-2:]
    p = coords.shape[-2]
    out = bilinear_sample(masks.reshape(-1, h, w), coords.reshape(-1, p, 2))
    return out.reshape(masks.shape[:-2] + (p,))


def point_sample_pair(a: torch.Tensor, b: torch.Tensor, coords: torch.Tensor):
    """Two same-shaped mask stacks sampled at the same coords, in one call."""
    stacked = torch.stack([a.float(), b.float()], dim=-3)
    c2 = coords[..., None, :, :].expand(coords.shape[:-2] + (2,) + coords.shape[-2:])
    out = point_sample(stacked, c2)
    return out[..., 0, :], out[..., 1, :]


@torch.no_grad()
def uncertain_point_coords(keys: Keys, mask_logits: torch.Tensor, num_points: int,
                           oversample_ratio: float = 3.0,
                           importance_sample_ratio: float = 0.75) -> torch.Tensor:
    """Uncertainty-oversampled random point coords (N, P, 2) in [0, 1] for
    (N, H, W) logits (reference get_uncertain_point_coords_with_randomness).
    N is batch-major (images, then masks), so that under data parallelism each
    rank keeps its rows of the global batch's draws.

    The pick of the most uncertain points is an exact top-k over f32 samples:
    the JAX package's ``exact_topk=True``. Its default ``lax.approx_max_k``
    (a TPU partial reduce of ~0.95 recall) has no PyTorch counterpart.
    """
    n = mask_logits.shape[0]
    dev = mask_logits.device
    k1, k2 = keys.split(2)
    n_sampled = int(num_points * oversample_ratio)
    n_unc = int(importance_sample_ratio * num_points)
    n_rand = num_points - n_unc
    coords = batch_uniform(k1, (n, n_sampled, 2), device=dev)
    if n_unc == 0:
        return batch_uniform(k2, (n, num_points, 2), device=dev)
    logits = point_sample(mask_logits, coords)
    idx = (-logits.abs()).topk(n_unc, dim=1).indices
    picked = coords.gather(1, idx[..., None].expand(-1, -1, 2))
    if n_rand == 0:
        return picked
    return torch.cat([picked, batch_uniform(k2, (n, n_rand, 2), device=dev)], dim=1)
