"""Core building blocks shared across hipie_torch models.

Counterpart of hipie_tpu/layers.py. Feature maps stay NHWC at module
boundaries, as in the JAX package, so the two compare like with like; a
convolution permutes to NCHW around the call (a free view: the NHWC tensor is
NCHW in channels-last memory order). Modules compute in the dtype of their
parameters (the model is cast as a whole, bf16 on the card); attention logits
and softmax run in f32 as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from hipie_torch.utils.trace import span


def _remat_span(fn, *args):
    with span("model.remat"):
        return fn(*args)


def maybe_checkpoint(remat: bool, fn, *args):
    """fn(*args); with ``remat`` and grad enabled, under activation
    checkpointing (the JAX package's ``nn.remat``): the activations inside fn
    are recomputed in the backward instead of kept. A checkpointed call runs
    inside a ``model.remat`` span, in the forward and again in the recompute."""
    if remat and torch.is_grad_enabled():
        return checkpoint(_remat_span, fn, *args, use_reentrant=False)
    return fn(*args)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU with the JAX package's dtype rule: tanh approximation in bf16, exact
    erf otherwise (hipie_tpu/layers.py gelu)."""
    return F.gelu(x, approximate="tanh" if x.dtype == torch.bfloat16 else "none")


def nhwc_to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def nchw_to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def conv_same(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """An unpadded ``conv`` of an NHWC map with flax's padding="SAME" (zeros,
    the odd one at the end): ceil(n / stride) outputs per axis."""
    pads = []
    for n, k, s in ((x.shape[2], conv.kernel_size[1], conv.stride[1]),
                    (x.shape[1], conv.kernel_size[0], conv.stride[0])):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return nchw_to_nhwc(conv(F.pad(nhwc_to_nchw(x), pads)))


class MLP(nn.Module):
    """N-layer perceptron with ReLU between layers (box heads, controllers)."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int, num_layers: int):
        super().__init__()
        dims = [input_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class FrozenBatchNorm(nn.Module):
    """BatchNorm with frozen statistics over dim 1 of an NCHW map (detectron2
    FrozenBatchNorm2d), folded into a scale and a bias in f32 and applied in the
    input's dtype, as the JAX package's FrozenBatchNorm.

    ``weight``, ``bias``, ``running_mean`` and ``running_var`` are buffers under
    those names, as the exported checkpoint names them.
    """

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(num_features))
        self.register_buffer("bias", torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x):
        scale = self.weight.float() * (self.running_var.float() + self.eps).rsqrt()
        shift = self.bias.float() - self.running_mean.float() * scale
        return x * scale.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]


class ConvGN(nn.Sequential):
    """Conv2d (symmetric k//2 padding) + GroupNorm(32) on NHWC input.

    Children are named 0 and 1, as the reference's input projections.
    """

    def __init__(self, in_channels: int, features: int, kernel_size: int = 1, stride: int = 1):
        super().__init__(
            nn.Conv2d(in_channels, features, kernel_size, stride=stride,
                      padding=kernel_size // 2),
            nn.GroupNorm(32, features, eps=1e-5))

    def forward(self, x):
        return nchw_to_nhwc(super().forward(nhwc_to_nchw(x)))


class MultiHeadAttention(nn.Module):
    """torch.nn.MultiheadAttention semantics and parameter names (in_proj_weight,
    in_proj_bias, out_proj), with f32 logits. attn_mask: True = blocked."""

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, query, key, value, attn_mask: Optional[torch.Tensor] = None):
        c = query.shape[-1]
        h = self.num_heads
        d = c // h
        w, b = self.in_proj_weight, self.in_proj_bias
        q = F.linear(query, w[:c], b[:c]).unflatten(-1, (h, d))
        k = F.linear(key, w[c:2 * c], b[c:2 * c]).unflatten(-1, (h, d))
        v = F.linear(value, w[2 * c:], b[2 * c:]).unflatten(-1, (h, d))
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(d)
        if attn_mask is not None:
            logits = logits.masked_fill(attn_mask, torch.finfo(torch.float32).min)
        attn = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v).flatten(-2)
        return self.out_proj(out)


def sine_position_embedding_2d(mask: torch.Tensor, num_pos_feats: int = 128) -> torch.Tensor:
    """Normalised sine/cosine embedding over the non-padded region (reference
    PositionEmbeddingSine, offset -0.5, temperature 10000).

    mask: (B, H, W) bool, True = padding. Returns (B, H, W, 2*num_pos_feats) f32.
    """
    scale, offset, temperature = 2 * math.pi, -0.5, 10000.0
    not_mask = (~mask).float()
    y_embed = not_mask.cumsum(1)
    x_embed = not_mask.cumsum(2)
    eps = 1e-6
    y_embed = (y_embed + offset) / (y_embed[:, -1:, :] + eps) * scale
    x_embed = (x_embed + offset) / (x_embed[:, :, -1:] + eps) * scale
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=mask.device)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor") / num_pos_feats)
    pos_x = x_embed[..., None] / dim_t
    pos_y = y_embed[..., None] / dim_t
    pos_x = torch.stack([pos_x[..., 0::2].sin(), pos_x[..., 1::2].cos()], dim=-1).flatten(-2)
    pos_y = torch.stack([pos_y[..., 0::2].sin(), pos_y[..., 1::2].cos()], dim=-1).flatten(-2)
    return torch.cat([pos_y, pos_x], dim=-1)
