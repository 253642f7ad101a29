"""Multi-scale deformable attention, plain: per-level ``F.grid_sample`` and a
weighted sum, differentiable by autograd (the port's ``ms_deform_attn_plain``,
frozen). Every method name runs it: the reference has no kernels."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

Shapes = Tuple[Tuple[int, int], ...]
MSDA_METHODS = ("fused", "flat4")


def ms_deform_attn_plain(value, spatial_shapes: Shapes, sampling_locations,
                         attention_weights) -> torch.Tensor:
    """Per-level ``F.grid_sample``, as the reference's ms_deform_attn_core_pytorch.

    value (B, S, M, D); sampling_locations (B, Q, M, L, P, 2) in [0, 1];
    attention_weights (B, Q, M, L, P). Samples in f32 whatever the value dtype
    and returns (B, Q, M*D) in the value's dtype.
    """
    b, s, m, d = value.shape
    _, q, _, n_levels, p, _ = sampling_locations.shape
    if sum(h * w for h, w in spatial_shapes) != s:
        raise ValueError(f"spatial shapes {spatial_shapes} do not sum to S={s}")
    grids = 2.0 * sampling_locations.float() - 1.0
    v_levels = value.float().split([h * w for h, w in spatial_shapes], dim=1)
    sampled = []
    for lvl, (h, w) in enumerate(spatial_shapes):
        v_l = v_levels[lvl].permute(0, 2, 3, 1).reshape(b * m, d, h, w)
        g_l = grids[:, :, :, lvl].transpose(1, 2).reshape(b * m, q, p, 2)
        sampled.append(F.grid_sample(v_l, g_l, mode="bilinear", padding_mode="zeros",
                                     align_corners=False))          # (B*M, D, Q, P)
    attw = attention_weights.float().transpose(1, 2).reshape(b * m, 1, q, n_levels * p)
    out = (torch.stack(sampled, dim=-2).flatten(-2) * attw).sum(-1)  # (B*M, D, Q)
    return out.reshape(b, m * d, q).transpose(1, 2).to(value.dtype)


def ms_deform_attn(value, spatial_shapes: Sequence[Tuple[int, int]],
                   sampling_locations, attention_weights, method: str = "fused") -> torch.Tensor:
    """(B, S, M, D) values sampled at (B, Q, M, L, P, 2) -> (B, Q, M*D), plain."""
    if method not in MSDA_METHODS:
        raise ValueError(f"ms_deform_attn: method must be one of {MSDA_METHODS}, got {method!r}")
    spatial_shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    return ms_deform_attn_plain(value, spatial_shapes, sampling_locations, attention_weights)


def ms_deform_attn_backward_plain(value, spatial_shapes: Shapes, sampling_locations,
                                  attention_weights, grad_out):
    """The gradients of ``ms_deform_attn_plain`` (``F.grid_sample``'s autograd)
    for the output cotangent ``grad_out`` (B, Q, M*D): (grad value in the
    value's dtype, grad locations f32, grad weights f32). K-D's reference."""
    with torch.enable_grad():
        v = value.detach().requires_grad_(True)
        loc = sampling_locations.detach().float().requires_grad_(True)
        w = attention_weights.detach().float().requires_grad_(True)
        out = ms_deform_attn_plain(v, spatial_shapes, loc, w)
        return torch.autograd.grad(out, (v, loc, w), grad_out.to(out.dtype))
