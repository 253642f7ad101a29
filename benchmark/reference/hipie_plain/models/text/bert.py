"""BERT text encoder (counterpart of hipie_tpu/models/text/bert.py).

Module and parameter names are Hugging Face's (embeddings.word_embeddings,
encoder.layer.N.attention.self.query, ...), so the reference's checkpoint
naming loads with strict=True. Attention logits are f32 with an additive
-1e9 bias for padded and blocked keys. ``remat`` (``text.remat``; JAX's
``nn.remat`` of the scanned layer body) runs each layer under
``torch.utils.checkpoint`` while grad is enabled.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from hipie_plain.layers import gelu, maybe_checkpoint


class BertEmbeddings(nn.Module):
    def __init__(self, vocab_size, hidden_size, max_position_embeddings, type_vocab_size):
        super().__init__()
        self.word_embeddings = nn.Embedding(vocab_size, hidden_size)
        self.position_embeddings = nn.Embedding(max_position_embeddings, hidden_size)
        self.token_type_embeddings = nn.Embedding(type_vocab_size, hidden_size)
        self.LayerNorm = nn.LayerNorm(hidden_size, eps=1e-12)

    def forward(self, input_ids):
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)[None]
        x = (self.word_embeddings(input_ids) + self.position_embeddings(pos)
             + self.token_type_embeddings(torch.zeros_like(input_ids)))
        return self.LayerNorm(x)


class BertSelfAttention(nn.Module):
    def __init__(self, hidden_size, num_heads):
        super().__init__()
        self.num_heads = num_heads
        self.query = nn.Linear(hidden_size, hidden_size)
        self.key = nn.Linear(hidden_size, hidden_size)
        self.value = nn.Linear(hidden_size, hidden_size)

    def forward(self, x, attn_bias):
        h = self.num_heads
        d = x.shape[-1] // h
        q = self.query(x).unflatten(-1, (h, d))
        k = self.key(x).unflatten(-1, (h, d))
        v = self.value(x).unflatten(-1, (h, d))
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / (d ** 0.5) + attn_bias
        attn = logits.softmax(-1).to(x.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", attn, v).flatten(-2)


class BertSelfOutput(nn.Module):
    def __init__(self, hidden_size):
        super().__init__()
        self.dense = nn.Linear(hidden_size, hidden_size)
        self.LayerNorm = nn.LayerNorm(hidden_size, eps=1e-12)


class BertAttention(nn.Module):
    def __init__(self, hidden_size, num_heads):
        super().__init__()
        self.self = BertSelfAttention(hidden_size, num_heads)
        self.output = BertSelfOutput(hidden_size)

    def forward(self, x, attn_bias):
        y = self.output.dense(self.self(x, attn_bias))
        return self.output.LayerNorm(x + y)


class BertIntermediate(nn.Module):
    def __init__(self, hidden_size, intermediate_size):
        super().__init__()
        self.dense = nn.Linear(hidden_size, intermediate_size)


class BertOutput(nn.Module):
    def __init__(self, hidden_size, intermediate_size):
        super().__init__()
        self.dense = nn.Linear(intermediate_size, hidden_size)
        self.LayerNorm = nn.LayerNorm(hidden_size, eps=1e-12)


class BertLayer(nn.Module):
    def __init__(self, hidden_size, num_heads, intermediate_size):
        super().__init__()
        self.attention = BertAttention(hidden_size, num_heads)
        self.intermediate = BertIntermediate(hidden_size, intermediate_size)
        self.output = BertOutput(hidden_size, intermediate_size)

    def forward(self, x, attn_bias):
        x = self.attention(x, attn_bias)
        y = self.output.dense(gelu(self.intermediate.dense(x)))
        return self.output.LayerNorm(x + y)


class BertEncoderStack(nn.Module):
    def __init__(self, num_layers, hidden_size, num_heads, intermediate_size):
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(hidden_size, num_heads, intermediate_size)
                                   for _ in range(num_layers))


class BertModel(nn.Module):
    """BERT encoder returning the last hidden state (no pooler)."""

    def __init__(self, vocab_size: int = 30522, hidden_size: int = 768, num_layers: int = 12,
                 num_heads: int = 12, intermediate_size: int = 3072,
                 max_position_embeddings: int = 512, type_vocab_size: int = 2,
                 remat: bool = False):
        super().__init__()
        self.remat = remat
        self.embeddings = BertEmbeddings(vocab_size, hidden_size, max_position_embeddings,
                                         type_vocab_size)
        self.encoder = BertEncoderStack(num_layers, hidden_size, num_heads, intermediate_size)

    def forward(self, input_ids, attention_mask, block_mask: Optional[torch.Tensor] = None):
        """input_ids (B, L); attention_mask (B, L) 1 = valid; block_mask (B, L, L)
        True = allowed. Returns (B, L, hidden)."""
        x = self.embeddings(input_ids)
        neg = -1e9
        zero = torch.zeros((), device=x.device)
        bias = torch.where(attention_mask[:, None, None, :] > 0, zero, neg)
        if block_mask is not None:
            bias = bias + torch.where(block_mask[:, None], zero, neg)
        for layer in self.encoder.layer:
            x = maybe_checkpoint(self.remat, layer, x, bias)
        return x


class BertEncoder(nn.Module):
    """Holds the BERT model under ``model``, as the reference's BertEncoder."""

    def __init__(self, **kwargs):
        super().__init__()
        self.model = BertModel(**kwargs)

    def forward(self, input_ids, attention_mask, block_mask=None):
        return self.model(input_ids, attention_mask, block_mask)


def parallel_det_block_mask(input_ids: torch.Tensor, sep_token_id: int, cls_token_id: int,
                            pad_token_id: int) -> torch.Tensor:
    """Block-diagonal attention mask for class-list prompts, (B, L, L) True = allowed.

    Every token attends to itself; class-name tokens also attend to the other
    tokens of the same class name (between '.' separators, exclusive).
    """
    is_sep = input_ids == sep_token_id
    seg = is_sep.int().cumsum(1) - is_sep.int()
    same = seg[:, :, None] == seg[:, None, :]
    special = (input_ids == cls_token_id) | (input_ids == pad_token_id) | is_sep
    nonspecial = ~special
    blocks = same & nonspecial[:, :, None] & nonspecial[:, None, :]
    eye = torch.eye(input_ids.shape[1], dtype=torch.bool, device=input_ids.device)[None]
    return blocks | eye
