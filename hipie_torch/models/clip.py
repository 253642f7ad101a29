"""CLIP (ViT + text transformer) and MaskCLIP mask-pooled classification.

Counterpart of hipie_tpu/models/clip.py (reference hipie/open_vocab/clip.py):
  * ClipAdapter: the frozen open_clip ViT-L-14-336 towers, kept out of the
    detector's state dict; the text side embeds prompt templates.
  * MaskCLIP: Q extra CLS tokens, each attending only to the patches inside its
    mask (mask probabilities resized to the image, max-pooled to the patch
    grid, threshold 0.5); logits = cosine(mask embed, text embed) *
    min(exp(logit_scale), 100), ensembled over synonym groups (max).
  * the fusion with the detector's probabilities is in
    hipie_torch/models/postprocess_clip.py.

Module and parameter names are open_clip's (``visual.conv1``,
``visual.transformer.resblocks.N.attn.in_proj_weight``, ``ln_1``,
``mlp.c_fc``, ``token_embedding``, ``ln_final``, ``text_projection``,
``logit_scale``), so an open_clip checkpoint loads with strict=True:
``CLIPText`` holds the text side at its root, ``MaskCLIP`` the ``visual``
tower and ``logit_scale`` (``load_open_clip`` splits a state dict between
them). ``hipie_torch.utils.export.inv_clip`` turns the JAX package's CLIP
parameters into the same names.

Attention runs through ``scaled_dot_product_attention``. Masks keep JAX's
sense at the module boundary (bool, True = BLOCKED) and are inverted at the
call (SDPA's True = ATTEND); every mask-token row keeps its CLS column, so no
row is all blocked. Resizes use JAX's resize weights (antialiased when
shrinking), as ``jax.image.resize(..., "bilinear")`` gives them.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from hipie_torch.models.backbone.vit import jax_resize_matrix

CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


class CLIPAttention(nn.Module):
    """nn.MultiheadAttention's parameters (in_proj_weight/bias, out_proj)."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, attn_mask: Optional[torch.Tensor] = None,
                causal: bool = False) -> torch.Tensor:
        """x (B, T, C); attn_mask (B, T, T) bool, True = BLOCKED; ``causal``
        blocks the keys after each query instead."""
        b, t, c = x.shape
        q, k, v = (y.unflatten(-1, (self.heads, -1)).transpose(1, 2)
                   for y in F.linear(x, self.in_proj_weight, self.in_proj_bias).chunk(3, -1))
        allowed = None if attn_mask is None else ~attn_mask[:, None]
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=allowed, is_causal=causal)
        return self.out_proj(out.transpose(1, 2).reshape(b, t, c))


class CLIPMlp(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.c_fc = nn.Linear(dim, 4 * dim)
        self.c_proj = nn.Linear(4 * dim, dim)

    def forward(self, x):
        y = self.c_fc(x)
        return self.c_proj(y * torch.sigmoid(1.702 * y))      # quick-gelu (openai CLIP)


class CLIPBlock(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.ln_1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = CLIPAttention(dim, heads)
        self.ln_2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = CLIPMlp(dim)

    def forward(self, x, attn_mask=None, causal: bool = False):
        x = x + self.attn(self.ln_1(x), attn_mask, causal)
        return x + self.mlp(self.ln_2(x))


class CLIPTransformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int):
        super().__init__()
        self.resblocks = nn.ModuleList(CLIPBlock(width, heads) for _ in range(layers))

    def forward(self, x, attn_mask=None, causal: bool = False):
        for blk in self.resblocks:
            x = blk(x, attn_mask, causal)
        return x


class CLIPVisual(nn.Module):
    """CLIP ViT visual tower with optional extra mask-CLS tokens (MaskCLIP)."""

    def __init__(self, image_size: int = 336, patch_size: int = 14, width: int = 1024,
                 layers: int = 24, heads: int = 16, output_dim: int = 768):
        super().__init__()
        self.image_size, self.patch_size = image_size, patch_size
        n_patch = (image_size // patch_size) ** 2
        self.conv1 = nn.Conv2d(3, width, patch_size, stride=patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(width))
        self.positional_embedding = nn.Parameter(torch.zeros(n_patch + 1, width))
        self.ln_pre = nn.LayerNorm(width, eps=1e-5)
        self.transformer = CLIPTransformer(width, layers, heads)
        self.ln_post = nn.LayerNorm(width, eps=1e-5)
        self.proj = nn.Parameter(torch.zeros(width, output_dim))

    def forward(self, images: torch.Tensor, mask_attn: Optional[torch.Tensor] = None):
        """images (B, S, S, 3) CLIP-normalised; mask_attn (B, Q, P) bool, True =
        patch BLOCKED for mask token q. Returns (B, Q, output_dim) mask
        embeddings with mask_attn, else (B, output_dim) CLS embeddings; f32."""
        b = images.shape[0]
        x = self.conv1(images.to(self.conv1.weight.dtype).permute(0, 3, 1, 2))
        x = x.flatten(2).transpose(1, 2)                              # (B, P, width)
        n_patch = x.shape[1]
        cls_tok = self.class_embedding.to(x.dtype).expand(b, 1, -1)
        x = torch.cat([cls_tok, x], 1) + self.positional_embedding.to(x.dtype)
        x = self.ln_pre(x)
        if mask_attn is None:
            x = self.transformer(x)
            return self.ln_post(x[:, 0]).float() @ self.proj.float()
        n_mask = mask_attn.shape[1]
        x = torch.cat([x[:, :1].expand(b, n_mask, -1), x], 1)
        t = n_mask + 1 + n_patch
        attn_mask = torch.zeros((b, t, t), dtype=torch.bool, device=x.device)
        attn_mask[:, :, :n_mask] = True                   # nobody attends to a mask token
        attn_mask[:, :n_mask, n_mask + 1:] = mask_attn    # a mask token sees its in-mask patches
        x = self.transformer(x, attn_mask)
        return self.ln_post(x[:, :n_mask]).float() @ self.proj.float()


class CLIPText(nn.Module):
    """open_clip's text side at the module root: causal transformer, the
    end-of-text token (the highest id) pooled."""

    def __init__(self, vocab_size: int = 49408, context_length: int = 77, width: int = 768,
                 layers: int = 12, heads: int = 12, output_dim: int = 768):
        super().__init__()
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.positional_embedding = nn.Parameter(torch.zeros(context_length, width))
        self.transformer = CLIPTransformer(width, layers, heads)
        self.ln_final = nn.LayerNorm(width, eps=1e-5)
        self.text_projection = nn.Parameter(torch.zeros(width, output_dim))

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """(B, T) -> (B, output_dim) f32."""
        t = input_ids.shape[1]
        x = self.token_embedding(input_ids) + self.positional_embedding[:t].to(
            self.token_embedding.weight.dtype)
        x = self.ln_final(self.transformer(x, causal=True))
        eot = input_ids.argmax(-1)
        pooled = x[torch.arange(x.shape[0], device=x.device), eot]
        return pooled.float() @ self.text_projection.float()


def clip_preprocess(images: torch.Tensor, size: int) -> torch.Tensor:
    """(B, H, W, 3) in [0, 1] -> CLIP-normalised (B, size, size, 3) f32."""
    x = images.float()
    rh = jax_resize_matrix(x.shape[1], size, "linear").to(x.device)
    rw = jax_resize_matrix(x.shape[2], size, "linear").to(x.device)
    x = torch.einsum("wj,bhjc->bhwc", rw, torch.einsum("hi,bijc->bhjc", rh, x))
    mean = torch.tensor(CLIP_IMAGE_MEAN, device=x.device)
    std = torch.tensor(CLIP_IMAGE_STD, device=x.device)
    return (x - mean) / std


def mask_attn_from_logits(mask_logits: torch.Tensor, image_size: int,
                          patch_size: int) -> torch.Tensor:
    """(B, Q, h, w) mask logits -> (B, Q, P) bool, True = patch BLOCKED:
    sigmoid, resize to the image, max-pool to the patch grid, blocked where
    the max probability is below 0.5 (reference encode_image_with_mask)."""
    b, q, h, w = mask_logits.shape
    g = image_size // patch_size
    probs = torch.sigmoid(mask_logits.float())
    rh = jax_resize_matrix(h, image_size, "linear").to(probs.device)
    rw = jax_resize_matrix(w, image_size, "linear").to(probs.device)
    probs = rh @ probs @ rw.T                                         # (B, Q, S, S)
    pooled = probs.reshape(b, q, g, patch_size, g, patch_size).amax((3, 5))
    return (pooled < 0.5).reshape(b, q, g * g)


def ensemble_logits_with_labels(logits: torch.Tensor, group_sizes: Sequence[int],
                                method: str = "max") -> torch.Tensor:
    """Synonym-group ensembling (helper.py:79-109): (..., sum(group_sizes)) ->
    (..., len(group_sizes)), the max (default) or mean of each group's logits."""
    group = torch.repeat_interleave(torch.arange(len(group_sizes), device=logits.device),
                                    torch.tensor(list(group_sizes), device=logits.device))
    out = logits.new_zeros(logits.shape[:-1] + (len(group_sizes),))
    return out.scatter_reduce(-1, group.expand_as(logits), logits,
                              "amax" if method == "max" else "mean", include_self=False)


class MaskCLIP(nn.Module):
    """Visual tower + mask-pooled logits (frozen; not in the detector's state)."""

    def __init__(self, visual: Optional[CLIPVisual] = None):
        super().__init__()
        self.visual = visual or CLIPVisual()
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07)))

    def forward(self, images01: torch.Tensor, mask_logits: torch.Tensor,
                text_embed: torch.Tensor, group_sizes: Sequence[int]) -> torch.Tensor:
        """images01 (B, H, W, 3) in [0, 1]; mask_logits (B, Q, h, w); text_embed
        (T, C) for sum(group_sizes) == T prompts. Returns (B, Q, len(group_sizes))."""
        v = self.visual
        x = clip_preprocess(images01, v.image_size)
        attn = mask_attn_from_logits(mask_logits, v.image_size, v.patch_size)
        mask_embed = v(x, attn)                                        # (B, Q, C)
        me = mask_embed / mask_embed.norm(dim=-1, keepdim=True).clamp_min(1e-9)
        te = text_embed / text_embed.norm(dim=-1, keepdim=True).clamp_min(1e-9)
        scale = self.logit_scale.float().exp().clamp(max=100.0)
        return ensemble_logits_with_labels(torch.einsum("bqc,tc->bqt", me, te) * scale,
                                           group_sizes)


def load_open_clip(text: CLIPText, maskclip: MaskCLIP, state_dict: Dict[str, torch.Tensor]):
    """Load an open_clip state dict into the two halves, strictly: ``visual.*``
    and ``logit_scale`` into ``maskclip``, the rest into ``text``."""
    vis = {k: v for k, v in state_dict.items() if k.startswith("visual.") or k == "logit_scale"}
    txt = {k: v for k, v in state_dict.items() if k not in vis}
    maskclip.load_state_dict(vis, strict=True)
    text.load_state_dict(txt, strict=True)


def clip_score_fusion(pred_prob: torch.Tensor, clip_logits: torch.Tensor,
                      category_overlap: torch.Tensor, alpha: float = 0.35,
                      beta: float = 0.7, mode: str = "MUL") -> torch.Tensor:
    """Base/novel geometric score ensemble (hipie_img.py get_clip_logits
    :811-868). pred_prob and the CLIP probabilities (Q, C); overlap (C,) 1 =
    seen in training. Returns fused logits (log space, like the reference)."""
    if clip_logits.shape[-1] == 1:
        clip_prob = torch.sigmoid(clip_logits)
    else:
        clip_prob = torch.softmax(clip_logits, -1)
    ov = category_overlap.float()
    if mode == "ADD":
        base = torch.log(pred_prob * (1 - alpha) + clip_prob * alpha + 1e-9) * ov
        novel = torch.log(pred_prob * (1 - beta) + clip_prob * beta + 1e-9) * (1 - ov)
    else:
        base = torch.log((pred_prob ** (1 - alpha) * clip_prob ** alpha).clamp_min(1e-9)) * ov
        novel = torch.log((pred_prob ** (1 - beta) * clip_prob ** beta).clamp_min(1e-9)) * (1 - ov)
    return base + novel


PROMPT_TEMPLATES = [
    "a photo of a {}.",
    "This is a photo of a {}",
    "There is a {} in the scene",
    "There is the {} in the scene",
    "a photo of a {} in the scene",
    "a photo of a small {}.",
    "a photo of a medium {}.",
    "a photo of a large {}.",
]
