"""Prediction heads (counterpart of hipie_tpu/models/heads.py)."""

from __future__ import annotations

import math

import torch
import torch.nn as nn


class VLAlign(nn.Module):
    """Vision-language dot-product classifier (reference VL_Align):
    logits = x . proj(l2norm(text) / 2) / exp(log_scale) + l2norm(text) . bias_lang + bias0.
    """

    def __init__(self, lang_dim: int = 768, hidden_dim: int = 256, prior_prob: float = 0.01):
        super().__init__()
        self.dot_product_projection_text = nn.Linear(lang_dim, hidden_dim)
        self.log_scale = nn.Parameter(torch.zeros(1))
        self.bias_lang = nn.Parameter(torch.zeros(lang_dim))
        self.bias0 = nn.Parameter(torch.full((1,), -math.log((1 - prior_prob) / prior_prob)))

    def forward(self, x, embedding):
        """x (B, Q, hidden); embedding (B, L, lang_dim). Returns (B, Q, L) f32."""
        emb = embedding.float()
        emb = emb / emb.norm(dim=-1, keepdim=True).clamp(min=1e-12)
        w = self.dot_product_projection_text.weight
        tokens = self.dot_product_projection_text((emb / 2.0).to(w.dtype))
        with torch.autocast(x.device.type, enabled=False):      # logits stay f32
            token_bias = emb @ self.bias_lang.float() + self.bias0.float()
            logits = torch.einsum("bqc,blc->bql", x.float(), tokens.float())
        return logits / self.log_scale.float().exp() + token_bias[:, None, :]


class StillClassifier(nn.Module):
    """Binary objectness head for encoder proposals (STILL_CLS_FOR_ENCODER)."""

    def __init__(self, hidden_dim: int):
        super().__init__()
        self.body = nn.Linear(hidden_dim, 1)

    def forward(self, x, embedding=None):
        return self.body(x).float()


class FeatureResizer(nn.Module):
    """Linear lang_dim -> d_model + LayerNorm for pooled language features."""

    def __init__(self, input_dim: int, output_dim: int):
        super().__init__()
        self.fc = nn.Linear(input_dim, output_dim)
        self.layer_norm = nn.LayerNorm(output_dim, eps=1e-12)

    def forward(self, x):
        return self.layer_norm(self.fc(x))


def agg_lang_feat(features: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked mean of (B, L, C) text features; mask (B, L) 1 = valid."""
    m = mask.to(features.dtype)
    return (features * m[..., None]).sum(1) / m.sum(-1)[..., None].clamp(min=1e-6)
