"""Small numeric helpers (counterpart of hipie_tpu/utils/misc.py)."""

from __future__ import annotations

import math

import torch


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps) / (1.0 - x).clamp(min=eps))


def get_valid_ratio(mask: torch.Tensor) -> torch.Tensor:
    """(B, H, W) bool pad mask (True = padding) -> (B, 2) = (ratio_w, ratio_h)."""
    not_mask = ~mask
    valid_h = not_mask[:, :, 0].float().sum(1)
    valid_w = not_mask[:, 0, :].float().sum(1)
    return torch.stack([valid_w / mask.shape[2], valid_h / mask.shape[1]], dim=-1)


def sine_position_embedding_1d(pos: torch.Tensor, num_feats: int = 128,
                               temperature: float = 10000.0, scale: float = 2 * math.pi,
                               exchange_xy: bool = True) -> torch.Tensor:
    """Sine embedding of normalised positions; the last dim of ``pos`` holds the
    coordinates, each giving num_feats interleaved sin/cos features, x and y
    swapped when exchange_xy."""
    dim_t = torch.arange(num_feats, dtype=torch.float32, device=pos.device)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor") / num_feats)
    x = pos[..., None] * scale / dim_t                       # (..., C, num_feats)
    emb = torch.stack([x[..., 0::2].sin(), x[..., 1::2].cos()], dim=-1).flatten(-2)
    parts = list(emb.unbind(-2))
    if exchange_xy and len(parts) >= 2:
        parts[0], parts[1] = parts[1], parts[0]
    return torch.cat(parts, dim=-1)
