"""Swin Transformer backbone, NHWC in and out.

Counterpart of hipie_tpu/models/backbone/swin.py (reference
hipie/backbone/swin.py:498-770, D2SwinTransformer): a 4x4 patch embedding,
4 stages of windowed attention (W-MSA and, every other block, SW-MSA shifted by
half a window through ``torch.roll`` with the -100 region mask) with the
relative position bias table, patch merging between stages, and one
LayerNorm per output map (res3..res5, strides 8 to 32).

As in JAX, a block rolls first and then pads to whole windows
(``window_partition``), and patch merging crops odd sizes. Module names are
timm/d2's (``patch_embed.proj``, ``layers.S.blocks.I.attn.qkv``,
``layers.S.downsample.reduction``, ``normS``), which
``hipie_torch.utils.export.inv_swin`` writes; merging concatenates the 2x2
neighbours in torch's order, (0,0), (1,0), (0,1), (1,1) (``_MERGE_PERM``
there). Attention is plain torch ops with f32 logits, as it is plain XLA in
JAX. Training drop path (rate linear from 0 to ``drop_path_rate``) runs where
``forward`` gets keep masks from ``draw_drop_masks``.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from hipie_torch.layers import conv_same
from hipie_torch.models.backbone.vit import (ViTMlp, drop_path, drop_path_rates,
                                             window_partition, window_unpartition)
from hipie_torch.utils.rng import Keys, batch_uniform

SWIN_VARIANTS = {
    # name: (embed_dim, depths, num_heads, window) — reference
    # hipie/backbone/swin.py:498-770 D2SwinTransformer configs
    "swin_tiny": (96, (2, 2, 6, 2), (3, 6, 12, 24), 7),
    "swin_small": (96, (2, 2, 18, 2), (3, 6, 12, 24), 7),
    "swin_base": (128, (2, 2, 18, 2), (4, 8, 16, 32), 12),
    "swin_large": (192, (2, 2, 18, 2), (6, 12, 24, 48), 12),
}


def relative_position_index(ws: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0) + (ws - 1)
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).astype(np.int32)


@lru_cache(maxsize=32)
def shift_region_mask(hp: int, wp: int, ws: int, shift: int, device: torch.device
                      ) -> torch.Tensor:
    """(nW, ws*ws, ws*ws) f32 additive mask of a shifted block on a padded
    (hp, wp) map: -100 between tokens of different regions. Cached by shape
    and device: every shifted block of a stage takes the same one."""
    img_mask = np.zeros((1, hp, wp, 1), np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wslice in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img_mask[:, hs, wslice] = cnt
            cnt += 1
    mw = img_mask.reshape(1, hp // ws, ws, wp // ws, ws, 1)
    mw = mw.transpose(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws)
    with torch.inference_mode(False):          # cached: usable in training too
        return torch.from_numpy((mw[:, None, :] != mw[:, :, None]) * -100.0).float().to(device)


class SwinAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int = 7):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        nn.init.trunc_normal_(self.relative_position_bias_table, std=0.02)
        self.register_buffer("relative_position_index", torch.from_numpy(
            relative_position_index(window_size)).long().reshape(-1), persistent=False)

    def forward(self, x: torch.Tensor, attn_mask: Optional[torch.Tensor] = None):
        """x (nW*B, ws*ws, C); attn_mask (nW, ws*ws, ws*ws) f32 additive, or None."""
        b, n, c = x.shape
        h = self.num_heads
        d = c // h
        q, k, v = self.qkv(x).reshape(b, n, 3, h, d).unbind(2)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * (d ** -0.5)
        bias = self.relative_position_bias_table[self.relative_position_index]
        logits = logits + bias.reshape(n, n, h).permute(2, 0, 1)[None].float()
        if attn_mask is not None:
            nw = attn_mask.shape[0]
            logits = (logits.reshape(b // nw, nw, h, n, n) + attn_mask[None, :, None]
                      ).reshape(b, h, n, n)
        attn = logits.softmax(-1).to(x.dtype)
        return self.proj(torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, n, c))


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int = 7, shift: int = 0,
                 mlp_ratio: float = 4.0, drop_path: float = 0.0):
        super().__init__()
        self.window_size, self.shift, self.drop_path = window_size, shift, drop_path
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = SwinAttention(dim, num_heads, window_size)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = ViTMlp(dim, int(dim * mlp_ratio), tensor_parallel=False)

    def forward(self, x: torch.Tensor, masks: Optional[torch.Tensor] = None):
        """x (B, H, W, C); masks (2, B) drop-path keep masks, or None."""
        m_attn, m_mlp = (None, None) if masks is None else masks
        _, hh, ww, c = x.shape
        ws, s = self.window_size, self.shift
        y = self.norm1(x)
        if s > 0:
            y = torch.roll(y, (-s, -s), dims=(1, 2))
        yw, padded = window_partition(y, ws)
        attn_mask = None
        if s > 0:
            attn_mask = shift_region_mask(*padded, ws, s, x.device)
        yw = self.attn(yw.reshape(yw.shape[0], ws * ws, c), attn_mask)
        y = window_unpartition(yw.reshape(-1, ws, ws, c), ws, padded, (hh, ww))
        if s > 0:
            y = torch.roll(y, (s, s), dims=(1, 2))
        x = x + drop_path(y, m_attn, self.drop_path)
        return x + drop_path(self.mlp(self.norm2(x)), m_mlp, self.drop_path)


class PatchMerging(nn.Module):
    """2x2 neighbours -> 4C (torch's order) -> LayerNorm -> Linear(2C, no bias)."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=1e-5)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        h, w = x.shape[1] // 2 * 2, x.shape[2] // 2 * 2
        x = x[:, :h, :w]
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                      -1)
        return self.reduction(self.norm(x))


class SwinStage(nn.Module):
    def __init__(self, dim: int, depth: int, num_heads: int, window_size: int,
                 rates, downsample: bool):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinBlock(dim, num_heads, window_size, 0 if i % 2 == 0 else window_size // 2,
                      drop_path=rates[i]) for i in range(depth))
        self.downsample = PatchMerging(dim) if downsample else None


class PatchEmbed(nn.Module):
    def __init__(self, embed_dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, embed_dim, 4, stride=4)
        self.norm = nn.LayerNorm(embed_dim, eps=1e-5)

    def forward(self, x):
        return self.norm(conv_same(self.proj, x))


class SwinTransformer(nn.Module):
    """NHWC image -> {res3, res4, res5} NHWC maps (each with its LayerNorm)."""

    def __init__(self, embed_dim: int = 96, depths: Tuple[int, ...] = (2, 2, 6, 2),
                 num_heads: Tuple[int, ...] = (3, 6, 12, 24), window_size: int = 7,
                 drop_path_rate: float = 0.2,
                 out_features: Tuple[str, ...] = ("res3", "res4", "res5")):
        super().__init__()
        self.out_features = tuple(out_features)
        self.patch_embed = PatchEmbed(embed_dim)
        rates = drop_path_rates(drop_path_rate, sum(depths))
        self.layers = nn.ModuleList()
        for s, depth in enumerate(depths):
            start = sum(depths[:s])
            self.layers.append(SwinStage(embed_dim * 2 ** s, depth, num_heads[s], window_size,
                                         rates[start:start + depth], s < len(depths) - 1))
        for s in range(len(depths)):
            if f"res{s + 2}" in self.out_features:
                self.add_module(f"norm{s}", nn.LayerNorm(embed_dim * 2 ** s, eps=1e-5))

    def draw_drop_masks(self, keys: Keys, batch: int) -> Optional[torch.Tensor]:
        """(depth, 2, batch) f32 keep masks for ``forward``, Bernoulli(1 - rate)
        per block (attention and MLP branch) and sample; None where no block drops."""
        blocks = [blk for stage in self.layers for blk in stage.blocks]
        if not any(blk.drop_path > 0 for blk in blocks):
            return None
        dev = self.patch_embed.proj.weight.device
        keep = 1.0 - torch.tensor([blk.drop_path for blk in blocks], dtype=torch.float32,
                                  device=dev)
        u = batch_uniform(keys, (len(blocks), 2, batch), axis=2, device=dev)
        return (u < keep[:, None, None]).float()

    def forward(self, x, drop_masks: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """x (B, H, W, 3); drop_masks (depth, 2, B) from ``draw_drop_masks`` in
        training, None otherwise."""
        x = self.patch_embed(x.to(self.patch_embed.proj.weight.dtype))
        outputs = {}
        bi = 0
        for s, stage in enumerate(self.layers):
            for blk in stage.blocks:
                x = blk(x, None if drop_masks is None else drop_masks[bi])
                bi += 1
            name = f"res{s + 2}"
            if name in self.out_features:
                outputs[name] = getattr(self, f"norm{s}")(x)
            if stage.downsample is not None:
                x = stage.downsample(x)
        return outputs


def swin_feature_channels(embed_dim: int = 96) -> Dict[str, int]:
    return {f"res{i + 2}": embed_dim * (2 ** i) for i in range(4)}
