"""ViTDet backbone: plain ViT, windowed and global attention with decomposed
relative positions, simple feature pyramid. NHWC in and out.

Counterpart of hipie_tpu/models/backbone/vit.py (reference hipie/backbone/vit.py).
Parameter names follow the reference (patch_embed.proj, pos_embed,
blocks.N.{norm1, attn.qkv, attn.rel_pos_h, ...}, fpn1.0). Global blocks run
``vit_global_attention`` (kernel K-A, and K-E for its gradient, on the card)
where JAX takes its Pallas kernel: bf16 compute (bf16 weights, or bf16 autocast
in training), N >= 1024 and N % 256 == 0 (``use_kernel_attention``); windowed
blocks and the rest are plain torch, as they are plain XLA in JAX. Training
adds drop path, from keep masks drawn before the forward
(``ViTDet.draw_drop_masks``), and activation checkpointing per block
(``remat``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from hipie_plain.layers import gelu, maybe_checkpoint, nchw_to_nhwc, nhwc_to_nchw
from hipie_plain.ops.vit_attention import vit_global_attention
from hipie_plain.parallel.tensor import TPLayout, copy_to_model, ffn, row_linear
from hipie_plain.utils.rng import Keys, batch_uniform

VIT_VARIANTS = {
    # name: (embed_dim, depth, num_heads, drop_path) — reference vit.py:386-398
    "vit_base": (768, 12, 12, 0.1),
    "vit_large": (1024, 24, 16, 0.4),
    "vit_huge": (1280, 32, 16, 0.5),
}


def _cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys cubic kernel (a = -0.5), as jax.image's "cubic"."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return (1.0 - x.abs()).clamp(min=0.0)


def jax_resize_matrix(in_size: int, out_size: int, kernel: str) -> torch.Tensor:
    """(out_size, in_size) f32 weights of ``jax.image.resize`` along one axis.

    Half-pixel centres, antialiasing when downsampling, weights renormalised
    per output sample and zeroed where it falls outside the input, exactly as
    jax._src.image.scale.compute_weight_mat. torch's bicubic interpolation uses
    another cubic (a = -0.75) and edge rule, so it does not reproduce JAX.
    """
    fn = {"cubic": _cubic, "linear": _triangle}[kernel]
    scale = out_size / in_size
    inv_scale = 1.0 / scale
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (torch.arange(out_size, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(in_size, dtype=torch.float32)[:, None]).abs() / kernel_scale
    w = fn(x)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).T


def resize_abs_pos(pos_embed: torch.Tensor, has_cls_token: bool, hw: Tuple[int, int]):
    """(1, N[+1], C) pretrain pos embed -> (1, H, W, C), bicubic as jax.image.resize."""
    h, w = hw
    if has_cls_token:
        pos_embed = pos_embed[:, 1:]
    n = pos_embed.shape[1]
    size = int(round(math.sqrt(n)))
    if size * size != n:
        raise ValueError(f"pos embed length {n} is not square")
    grid = pos_embed.reshape(1, size, size, -1)
    if (size, size) != (h, w):
        dev = pos_embed.device
        rh = jax_resize_matrix(size, h, "cubic").to(dev)
        rw = jax_resize_matrix(size, w, "cubic").to(dev)
        grid = torch.einsum("hi,wj,bijc->bhwc", rh, rw, grid.float())
    return grid


def window_partition(x: torch.Tensor, ws: int):
    """(B, H, W, C) -> (B*nW, ws, ws, C), zero padding H and W to multiples of ws."""
    b, h, w, c = x.shape
    pad_h = (ws - h % ws) % ws
    pad_w = (ws - w % ws) % ws
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = h + pad_h, w + pad_w
    x = x.reshape(b, hp // ws, ws, wp // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws, ws, c), (hp, wp)


def window_unpartition(x: torch.Tensor, ws: int, padded_hw: Tuple[int, int],
                       hw: Tuple[int, int]):
    hp, wp = padded_hw
    h, w = hw
    b = x.shape[0] // (hp // ws * wp // ws)
    x = x.reshape(b, hp // ws, wp // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, hp, wp, -1)[:, :h, :w]


def get_rel_pos(q_size: int, k_size: int, rel_pos: torch.Tensor) -> torch.Tensor:
    """Slice or resize a (2*L-1, dim) rel-pos table to (q_size, k_size, dim)."""
    max_rel_dist = 2 * max(q_size, k_size) - 1
    if rel_pos.shape[0] != max_rel_dist:
        r = jax_resize_matrix(rel_pos.shape[0], max_rel_dist, "linear").to(rel_pos.device)
        rel_pos = r @ rel_pos.float()
    q_coords = torch.arange(q_size, device=rel_pos.device)[:, None] * max(k_size / q_size, 1.0)
    k_coords = torch.arange(k_size, device=rel_pos.device)[None, :] * max(q_size / k_size, 1.0)
    rel = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos[rel.long()]


def add_decomposed_rel_pos(attn, q, rel_pos_h, rel_pos_w, q_hw, k_hw):
    """attn (B, qh*qw, kh*kw) + decomposed rel-pos bias from q (B, qh*qw, dim)."""
    q_h, q_w = q_hw
    k_h, k_w = k_hw
    rh = get_rel_pos(q_h, k_h, rel_pos_h).to(q.dtype)
    rw = get_rel_pos(q_w, k_w, rel_pos_w).to(q.dtype)
    b = q.shape[0]
    r_q = q.reshape(b, q_h, q_w, -1)
    rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, rh)
    rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, rw)
    attn = attn.reshape(b, q_h, q_w, k_h, k_w) + rel_h[..., :, None] + rel_w[..., None, :]
    return attn.reshape(b, q_h * q_w, k_h * k_w)


def use_kernel_attention(dtype: torch.dtype, use_rel_pos: bool, n: int) -> bool:
    """Whether a global block takes ``vit_global_attention``: JAX's condition
    for its Pallas kernel (hipie_tpu/models/backbone/vit.py:140-144) without
    the backend term. ``dtype`` is the compute dtype, q's after the qkv
    projection (bf16 under autocast although LayerNorm gives f32)."""
    return dtype == torch.bfloat16 and use_rel_pos and n >= 1024 and n % 256 == 0


def drop_path_rates(rate: float, depth: int) -> List[float]:
    """Per-block drop-path rates, linear from 0 to ``rate``, as JAX's ViTDet."""
    return [rate * i / max(depth - 1, 1) for i in range(depth)]


def drop_path(y: torch.Tensor, mask: Optional[torch.Tensor], rate: float) -> torch.Tensor:
    """JAX's ``ViTBlock._drop_path`` with its Bernoulli draw given: y (B, ...)
    times mask (B,) / keep, the scale formed in f32 and cast to y's dtype. No
    mask: the identity (eval)."""
    if mask is None:
        return y
    keep = 1.0 - torch.tensor(rate, dtype=torch.float32)
    scale = (mask.float() / keep.clamp(min=1e-6)).to(y.dtype)
    return y * scale.reshape((-1,) + (1,) * (y.dim() - 1))


class ViTAttention(nn.Module):
    """Under tensor parallelism (``tp`` > 1, set by
    ``hipie_plain.parallel.tensor.shard_module_``) the module holds its rank's
    heads of q, k and v (qkv column-parallel) and proj's matching input
    columns (row-parallel); the rel-pos tables stay whole, and each rank's
    gradient of them is its heads' part."""

    tp = 1

    def __init__(self, dim: int, num_heads: int, use_rel_pos: bool = True,
                 input_size: Tuple[int, int] = (14, 14)):
        super().__init__()
        self.num_heads = num_heads
        self.use_rel_pos = use_rel_pos
        hd = dim // num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        if use_rel_pos:
            self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size[0] - 1, hd))
            self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size[1] - 1, hd))
        self.tp_layout = TPLayout({"qkv": 3}, ("proj",),
                                  ("rel_pos_h", "rel_pos_w") if use_rel_pos else ())

    def forward(self, x, global_attn: bool):
        b, h, w, c = x.shape
        nh = self.num_heads // self.tp
        hd = c // self.num_heads
        x = x.reshape(b, h * w, c)
        qkv = self.qkv(x if self.tp == 1 else copy_to_model(x)).reshape(b, h * w, 3, nh, hd)
        q, k, v = (qkv[:, :, i].transpose(1, 2).reshape(b * nh, h * w, hd) for i in range(3))
        if global_attn and use_kernel_attention(q.dtype, self.use_rel_pos, h * w):
            # kernels K-A / K-E; the bias coefficients are q contracted with the tables
            rh = get_rel_pos(h, h, self.rel_pos_h).to(q.dtype)
            rw = get_rel_pos(w, w, self.rel_pos_w).to(q.dtype)
            r_q = q.reshape(b * nh, h, w, hd)
            rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, rh).reshape(b * nh, h * w, h).to(q.dtype)
            rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, rw).reshape(b * nh, h * w, w).to(q.dtype)
            out = vit_global_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                       rel_h.contiguous(), rel_w.contiguous(), hd ** -0.5)
        else:
            attn = torch.einsum("bqd,bkd->bqk", q, k) * (hd ** -0.5)
            if self.use_rel_pos:
                attn = add_decomposed_rel_pos(attn, q, self.rel_pos_h, self.rel_pos_w,
                                              (h, w), (h, w))
            attn = attn.float().softmax(-1).to(q.dtype)
            out = torch.einsum("bqk,bkd->bqd", attn, v)
        out = out.reshape(b, nh, h * w, hd).transpose(1, 2).reshape(b, h, w, nh * hd)
        return self.proj(out) if self.tp == 1 else row_linear(self.proj, out)


class ViTMlp(nn.Module):
    """fc1 column- and fc2 row-parallel under tensor parallelism, where
    ``tensor_parallel`` (JAX's rules shard the ViT's MLPs, not Swin's)."""

    tp = 1

    def __init__(self, dim: int, hidden: int, tensor_parallel: bool = True):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)
        self.tp_layout = TPLayout({"fc1": 1}, ("fc2",)) if tensor_parallel else None

    def forward(self, x):
        return ffn(self.fc1, self.fc2, x, self.tp, act=gelu)


class ViTBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 use_rel_pos: bool = True, window_size: int = 0,
                 input_size: Tuple[int, int] = (64, 64), drop_path: float = 0.0):
        super().__init__()
        self.window_size = window_size
        self.drop_path = drop_path
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        size = (window_size, window_size) if window_size > 0 else input_size
        self.attn = ViTAttention(dim, num_heads, use_rel_pos=use_rel_pos, input_size=size)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = ViTMlp(dim, int(dim * mlp_ratio))

    def forward(self, x, masks: Optional[torch.Tensor] = None):
        """masks: (2, B) keep masks of the attention and MLP branches' drop
        path, or None (the identity)."""
        m_attn, m_mlp = (None, None) if masks is None else masks
        y = self.norm1(x)
        if self.window_size > 0:
            hw = (y.shape[1], y.shape[2])
            y, padded = window_partition(y, self.window_size)
            y = self.attn(y, global_attn=False)
            y = window_unpartition(y, self.window_size, padded, hw)
        else:
            y = self.attn(y, global_attn=True)
        x = x + drop_path(y, m_attn, self.drop_path)
        return x + drop_path(self.mlp(self.norm2(x)), m_mlp, self.drop_path)


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, in_chans: int, embed_dim: int):
        super().__init__()
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size, stride=patch_size)

    def forward(self, x):
        return nchw_to_nhwc(self.proj(nhwc_to_nchw(x)))


class ViTDet(nn.Module):
    """Plain-ViT detection backbone: NHWC image -> {res3, res4, res5} NHWC maps.

    Drop path (rate ``drop_path_rate`` at the last block, linear from 0) runs
    where ``forward`` is given keep masks (``draw_drop_masks``), and is the
    identity otherwise. With ``remat``, each block runs under
    ``torch.utils.checkpoint`` while grad is enabled (JAX's ``nn.remat``): its
    activations are recomputed in the backward, with the same masks.
    """

    def __init__(self, img_size: int = 1024, patch_size: int = 16, embed_dim: int = 1280,
                 depth: int = 32, num_heads: int = 16, mlp_ratio: float = 4.0,
                 drop_path_rate: float = 0.0, window_size: int = 14,
                 window_block_indexes: Tuple[int, ...] = (0, 1, 3, 4, 6, 7, 9, 10),
                 use_rel_pos: bool = True, pretrain_img_size: int = 224,
                 pretrain_use_cls_token: bool = True,
                 out_features: Tuple[str, ...] = ("res3", "res4", "res5"),
                 remat: bool = False):
        super().__init__()
        self.remat = remat
        self.pretrain_use_cls_token = pretrain_use_cls_token
        self.out_features = tuple(out_features)
        self.patch_embed = PatchEmbed(patch_size, 3, embed_dim)
        n_pos = (pretrain_img_size // patch_size) ** 2 + int(pretrain_use_cls_token)
        self.pos_embed = nn.Parameter(torch.zeros(1, n_pos, embed_dim))
        nn.init.trunc_normal_(self.pos_embed, std=0.02, a=-0.04, b=0.04)
        input_size = (img_size // patch_size,) * 2
        self.blocks = nn.ModuleList(
            ViTBlock(embed_dim, num_heads, mlp_ratio, use_rel_pos,
                     window_size if i in window_block_indexes else 0, input_size, rate)
            for i, rate in enumerate(drop_path_rates(drop_path_rate, depth)))
        if "res3" in self.out_features:
            self.fpn1 = nn.Sequential(nn.ConvTranspose2d(embed_dim, embed_dim // 2, 2, stride=2))

    def draw_drop_masks(self, keys: Keys, batch: int) -> Optional[torch.Tensor]:
        """(depth, 2, batch) f32 keep masks for ``forward``, Bernoulli(1 - rate)
        per block (attention and MLP branch) and sample, drawn from ``keys``;
        None where no block drops."""
        if not any(blk.drop_path > 0 for blk in self.blocks):
            return None
        dev = self.pos_embed.device
        keep = 1.0 - torch.tensor([blk.drop_path for blk in self.blocks], dtype=torch.float32,
                                  device=dev)
        u = batch_uniform(keys, (len(self.blocks), 2, batch), axis=2, device=dev)
        return (u < keep[:, None, None]).float()

    def forward(self, x, drop_masks: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """x (B, H, W, 3); drop_masks (depth, 2, B) from ``draw_drop_masks`` in
        training, None otherwise."""
        x = self.patch_embed(x.to(self.pos_embed.dtype))
        x = x + resize_abs_pos(self.pos_embed, self.pretrain_use_cls_token,
                               (x.shape[1], x.shape[2])).to(x.dtype)
        for i, blk in enumerate(self.blocks):
            x = maybe_checkpoint(self.remat, blk, x, None if drop_masks is None else drop_masks[i])
        outputs = {}
        if "res3" in self.out_features:
            outputs["res3"] = nchw_to_nhwc(self.fpn1(nhwc_to_nchw(x)))
        if "res4" in self.out_features:
            outputs["res4"] = x
        if "res5" in self.out_features:
            outputs["res5"] = nchw_to_nhwc(F.max_pool2d(nhwc_to_nchw(x), 2, 2))
        return outputs


def vit_feature_channels(embed_dim: int):
    return {"res3": embed_dim // 2, "res4": embed_dim, "res5": embed_dim}
