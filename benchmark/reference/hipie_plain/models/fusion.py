"""Vision-language early fusion (counterpart of hipie_tpu/models/fusion.py).

One joint logits matrix between vision tokens (scaled queries) and text
tokens: softmax over text (pads masked with -9e15) updates vision; softmax of
the transposed logits over image tokens (max-subtracted, no pad mask) updates
text. Pre-LN block whose residual base is the normalised input, with
per-branch layer-scale gammas (reference fuse_helper.py).

Under tensor parallelism (``tp`` > 1) the four input projections are
column-parallel by heads and the two output projections row-parallel. Under
sequence parallelism (``tokens``: the rank's share of the vision tokens) the
vision tokens are gathered whole first, so that the language side's softmax
runs over every image token on each rank, and the vision output is given back
as the rank's share: a sharded block by reduce-scatter, a whole one (heads
that tp does not divide) by a slice of its replicated result.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from hipie_plain.parallel.tensor import (TPLayout, column_input, copy_to_model, gather_tokens_replicated,
                                         row_linear, split_tokens)


class BiMultiHeadAttention(nn.Module):
    tp = 1

    def __init__(self, v_dim: int = 256, l_dim: int = 768, embed_dim: int = 2048,
                 num_heads: int = 8):
        super().__init__()
        self.num_heads = num_heads
        self.embed_dim = embed_dim
        self.v_proj = nn.Linear(v_dim, embed_dim)
        self.l_proj = nn.Linear(l_dim, embed_dim)
        self.values_v_proj = nn.Linear(v_dim, embed_dim)
        self.values_l_proj = nn.Linear(l_dim, embed_dim)
        self.out_v_proj = nn.Linear(embed_dim, v_dim)
        self.out_l_proj = nn.Linear(embed_dim, l_dim)
        self.tp_layout = TPLayout(dict.fromkeys(("v_proj", "l_proj", "values_v_proj",
                                                 "values_l_proj"), 1),
                                  ("out_v_proj", "out_l_proj"), unit=embed_dim // num_heads)

    def forward(self, v, l, text_mask=None, tokens=None):
        """v (B, S, v_dim) (the rank's share of S under ``tokens``); l (B, L,
        l_dim); text_mask (B, L) 1 = valid."""
        h = self.num_heads // self.tp
        d = self.embed_dim // self.num_heads
        if self.tp > 1:
            v, l = column_input(v, tokens), copy_to_model(l)
        elif tokens is not None:
            v = gather_tokens_replicated(v, tokens)
        q = self.v_proj(v).unflatten(-1, (h, d)) * d ** -0.5
        k = self.l_proj(l).unflatten(-1, (h, d))
        val_v = self.values_v_proj(v).unflatten(-1, (h, d))
        val_l = self.values_l_proj(l).unflatten(-1, (h, d))
        logits = torch.einsum("bshd,blhd->bhsl", q, k).float()

        logits_t = logits.transpose(-1, -2)
        logits_t = logits_t - logits_t.amax(-1, keepdim=True)
        attn_l = logits_t.softmax(-1).to(v.dtype)
        out_l = torch.einsum("bhls,bshd->blhd", attn_l, val_v)

        if text_mask is not None:
            logits = logits.masked_fill(~(text_mask[:, None, None, :] > 0), -9e15)
        attn_v = logits.softmax(-1).to(v.dtype)
        out_v = torch.einsum("bhsl,blhd->bshd", attn_v, val_l)
        if self.tp > 1:
            return (row_linear(self.out_v_proj, out_v.flatten(-2), tokens),
                    row_linear(self.out_l_proj, out_l.flatten(-2)))
        out_v = self.out_v_proj(out_v.flatten(-2))
        if tokens is not None:
            out_v = split_tokens(out_v, tokens)
        return out_v, self.out_l_proj(out_l.flatten(-2))


class BiAttentionBlock(nn.Module):
    """Pre-LN bi-attention with layer scale. Returns updated (v, l)."""

    def __init__(self, v_dim: int = 256, l_dim: int = 768, embed_dim: int = 2048,
                 num_heads: int = 8, init_gamma: float = 1.0 / 6.0):
        super().__init__()
        self.layer_norm_v = nn.LayerNorm(v_dim, eps=1e-5)
        self.layer_norm_l = nn.LayerNorm(l_dim, eps=1e-5)
        self.attn = BiMultiHeadAttention(v_dim, l_dim, embed_dim, num_heads)
        self.gamma_v = nn.Parameter(torch.full((v_dim,), init_gamma))
        self.gamma_l = nn.Parameter(torch.full((l_dim,), init_gamma))

    def forward(self, v, l, text_mask=None, tokens=None):
        v = self.layer_norm_v(v)
        l = self.layer_norm_l(l)
        delta_v, delta_l = self.attn(v, l, text_mask, tokens)
        return v + self.gamma_v * delta_v, l + self.gamma_l * delta_l

    def token_local_parameters(self):
        """The parameters that see only the rank's vision tokens under SP."""
        out = [self.layer_norm_v.weight, self.layer_norm_v.bias, self.gamma_v]
        return out + ([self.attn.out_v_proj.bias] if self.attn.tp > 1 else [])
