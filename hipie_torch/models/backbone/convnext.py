"""ConvNeXt backbone, NHWC in and out.

Counterpart of hipie_tpu/models/backbone/convnext.py (reference
hipie/backbone/convnext.py:60-264, D2ConvNeXt): a 4x4 stem, 4 stages of
blocks (depthwise 7x7, channels-last LayerNorm, pointwise MLP, layer scale),
2x2 downsampling between stages, and one LayerNorm per output map (res3..res5,
strides 8 to 32). The strided convolutions pad as flax's "SAME" does. Module
names are facebook ConvNeXt's (``downsample_layers.S.N``, ``stages.S.I.dwconv``,
``.gamma``, ``normS``), which ``hipie_torch.utils.export.inv_convnext``
writes. The JAX package builds it with drop path 0 (``build_backbone``), so
it has none.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as nn

from hipie_torch.layers import conv_same, gelu, nchw_to_nhwc, nhwc_to_nchw

CONVNEXT_VARIANTS = {
    "tiny": ((3, 3, 9, 3), (96, 192, 384, 768)),
    "small": ((3, 3, 27, 3), (96, 192, 384, 768)),
    "base": ((3, 3, 27, 3), (128, 256, 512, 1024)),
    "large": ((3, 3, 27, 3), (192, 384, 768, 1536)),
    "xlarge": ((3, 3, 27, 3), (256, 512, 1024, 2048)),
}


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int, layer_scale_init: float = 1e-6):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.pwconv2 = nn.Linear(4 * dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), layer_scale_init))

    def forward(self, x):
        y = nchw_to_nhwc(self.dwconv(nhwc_to_nchw(x)))
        y = self.pwconv2(gelu(self.pwconv1(self.norm(y))))
        return x + y * self.gamma.to(y.dtype)


class ConvNeXt(nn.Module):
    """NHWC image -> {res3, res4, res5} NHWC maps (each with its LayerNorm)."""

    def __init__(self, variant: str = "tiny",
                 out_features: Tuple[str, ...] = ("res3", "res4", "res5")):
        super().__init__()
        depths, dims = CONVNEXT_VARIANTS[variant]
        self.out_features = tuple(out_features)
        self.downsample_layers = nn.ModuleList(
            [nn.ModuleList([nn.Conv2d(3, dims[0], 4, stride=4), nn.LayerNorm(dims[0], eps=1e-6)])]
            + [nn.ModuleList([nn.LayerNorm(dims[s - 1], eps=1e-6),
                              nn.Conv2d(dims[s - 1], dims[s], 2, stride=2)])
               for s in range(1, 4)])
        self.stages = nn.ModuleList(
            nn.ModuleList(ConvNeXtBlock(dims[s]) for _ in range(depths[s])) for s in range(4))
        for s in range(4):
            if f"res{s + 2}" in self.out_features:
                self.add_module(f"norm{s}", nn.LayerNorm(dims[s], eps=1e-6))

    def forward(self, x) -> Dict[str, torch.Tensor]:
        """x (B, H, W, 3)."""
        x = x.to(self.downsample_layers[0][0].weight.dtype)
        outputs = {}
        for s, stage in enumerate(self.stages):
            if s == 0:
                conv, norm = self.downsample_layers[0]
                x = norm(conv_same(conv, x))
            else:
                norm, conv = self.downsample_layers[s]
                x = conv_same(conv, norm(x))
            for blk in stage:
                x = blk(x)
            name = f"res{s + 2}"
            if name in self.out_features:
                outputs[name] = getattr(self, f"norm{s}")(x)
        return outputs


def convnext_feature_channels(variant: str = "tiny") -> Dict[str, int]:
    dims = CONVNEXT_VARIANTS[variant][1]
    return {f"res{i + 2}": dims[i] for i in range(4)}
