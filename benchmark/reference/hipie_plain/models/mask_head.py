"""CondInst dynamic-convolution mask head (counterpart of hipie_tpu/models/mask_head.py).

MaskFeatureHead FPN-fuses the stride-8/16/32 encoder maps into stride-8 mask
features; dynamic_mask_with_coords runs a per-query 1x1 conv stack whose
weights come from the controller, over [relative coords, mask features], and
upsamples x2 with the reference's aligned bilinear scheme.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from hipie_plain.layers import nchw_to_nhwc, nhwc_to_nchw


def dynamic_conv_param_sizes(in_channels: int, channels: int, num_layers: int,
                             rel_coord: bool) -> Tuple[List[int], List[int]]:
    """(weight_nums, bias_nums) for the controller output split."""
    weight_nums, bias_nums = [], []
    for layer in range(num_layers):
        if layer == 0:
            cin = in_channels + 2 if rel_coord else in_channels
            weight_nums.append(cin * channels)
            bias_nums.append(channels)
        elif layer == num_layers - 1:
            weight_nums.append(channels)
            bias_nums.append(1)
        else:
            weight_nums.append(channels * channels)
            bias_nums.append(channels)
    return weight_nums, bias_nums


def aligned_bilinear(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Upsample NHWC x by `factor`: replicate-pad bottom/right by 1, bilinear
    with align_corners=True to (f*H+1, f*W+1), replicate-pad top/left by f//2,
    crop to (f*H, f*W)."""
    if factor == 1:
        return x
    _, h, w, _ = x.shape
    y = F.pad(nhwc_to_nchw(x), (0, 1, 0, 1), mode="replicate")
    y = F.interpolate(y, size=(factor * h + 1, factor * w + 1), mode="bilinear",
                      align_corners=True)
    p = factor // 2
    y = F.pad(y, (p, 0, p, 0), mode="replicate")
    return nchw_to_nhwc(y[:, :, :factor * h, :factor * w])


class MaskFeatureHead(nn.Module):
    """FPN-fuse [stride8, stride16, stride32] NHWC maps into stride-8 mask features.

    The top-down upsampling is "nearest-exact" (half-pixel centres), which is
    jax.image.resize's "nearest".
    """

    def __init__(self, dim: int = 256):
        super().__init__()
        conv = lambda cin, cout: nn.Conv2d(cin, cout, 3, padding=1)
        self.lay3 = conv(dim, dim)
        self.lay4 = conv(dim, dim)
        self.jia_dcn = conv(dim, dim)
        self.lay1 = conv(dim, dim // 4)
        self.lay2 = conv(dim // 4, dim // 32)

    def forward(self, feats: Sequence[torch.Tensor]):
        """Returns (fused (B, H8, W8, dim), mask_feats (B, H8, W8, dim // 32)), NHWC."""
        f8, f16, f32 = (nhwc_to_nchw(f) for f in feats)
        y = F.relu(self.lay3(f32))
        y = f16 + F.interpolate(y, size=f16.shape[2:], mode="nearest-exact")
        y = F.relu(self.lay4(y))
        y = f8 + F.interpolate(y, size=f8.shape[2:], mode="nearest-exact")
        fused = F.relu(self.jia_dcn(y))
        m = F.relu(self.lay2(F.relu(self.lay1(fused))))
        return nchw_to_nhwc(fused), nchw_to_nhwc(m)


def dynamic_mask_with_coords(mask_feats, reference_points, controller_params,
                             weight_nums: Sequence[int], bias_nums: Sequence[int],
                             channels: int, mask_feat_stride: int = 8,
                             mask_out_stride: int = 4, rel_coord: bool = True) -> torch.Tensor:
    """Per-query dynamic 1x1 conv stack -> (B, Q, H4, W4) f32 mask logits.

    mask_feats (B, H8, W8, Cm); reference_points (B, Q, 2) in valid-image pixels;
    controller_params (B, Q, num_params).
    """
    b, h, w, cm = mask_feats.shape
    q = reference_points.shape[1]
    n_layers = len(weight_nums)
    dev = mask_feats.device
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=dev) * mask_feat_stride + mask_feat_stride // 2,
        torch.arange(w, dtype=torch.float32, device=dev) * mask_feat_stride + mask_feat_stride // 2,
        indexing="ij")
    locs = torch.stack([xs, ys], -1).reshape(h * w, 2)
    feats = mask_feats.reshape(b, h * w, cm).float()
    x = feats[:, None].expand(b, q, h * w, cm)
    if rel_coord:
        rel = reference_points.float()[:, :, None, :] - locs[None, None]
        x = torch.cat([rel, x], -1)
    params = controller_params.float()
    splits = params.split(list(weight_nums) + list(bias_nums), dim=-1)
    for layer in range(n_layers):
        c_out = channels if layer < n_layers - 1 else 1
        wl = splits[layer].reshape(b, q, c_out, -1)
        bl = splits[n_layers + layer].reshape(b, q, 1, c_out)
        x = torch.einsum("bqhc,bqoc->bqho", x, wl) + bl
        if layer < n_layers - 1:
            x = F.relu(x)
    logits = aligned_bilinear(x.reshape(b * q, h, w, 1), mask_feat_stride // mask_out_stride)
    return logits.reshape(b, q, logits.shape[1], logits.shape[2])
