"""ResNet backbone (detectron2 bottleneck ResNet with FrozenBN).

Counterpart of hipie_tpu/models/backbone/resnet.py (reference
detectron2/modeling/backbone/resnet.py: BasicStem and BottleneckBlock). Stem:
7x7/2 conv, FrozenBN, ReLU, 3x3/2 max-pool with padding 1. Stages res2..res5
of bottleneck blocks; block 0 of each stage has a 1x1 strided shortcut. As in
the JAX package, a stage's stride sits on the 3x3 ``conv2`` (not on ``conv1``
as with d2's STRIDE_IN_1X1). Module names follow the reference checkpoint
(``stem.conv1``, ``stem.conv1.norm``, ``res{2..5}.{i}.conv{1,2,3}[.norm]``,
``.shortcut[.norm]``). ``freeze_at`` (``backbone.frozen_stages + 1``) is the
JAX package's stop-gradient: the map is detached after the stem when it is
at least 1 and after stage ``res{k}`` when it is at least k, so no gradient
reaches those stages. It names no parameter: the optimizer's frozen group
(stem and res2, ``train/optimizer.py``) is set by name, as JAX's is, so a
stage detached past it keeps a zero gradient and AdamW's weight decay.

Input and outputs are NHWC, as every backbone of the port; the convolutions
run on the NCHW view of the same memory.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from hipie_plain.layers import FrozenBatchNorm, nchw_to_nhwc, nhwc_to_nchw

BLOCKS_PER_STAGE = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3),
                    101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


class Conv2d(nn.Conv2d):
    """detectron2 Conv2d: a bias-free convolution with a FrozenBN ``norm`` child."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1,
                 padding: int = 0):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride, padding=padding,
                         bias=False)
        self.norm = FrozenBatchNorm(out_channels)

    def forward(self, x):
        return self.norm(super().forward(x))


class BottleneckBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, bottleneck_channels: int,
                 stride: int = 1, has_shortcut: bool = False):
        super().__init__()
        self.shortcut = (Conv2d(in_channels, out_channels, 1, stride=stride)
                         if has_shortcut else None)
        self.conv1 = Conv2d(in_channels, bottleneck_channels, 1)
        self.conv2 = Conv2d(bottleneck_channels, bottleneck_channels, 3, stride=stride, padding=1)
        self.conv3 = Conv2d(bottleneck_channels, out_channels, 1)

    def forward(self, x):
        out = F.relu(self.conv1(x))
        out = F.relu(self.conv2(out))
        out = self.conv3(out)
        return F.relu(out + (x if self.shortcut is None else self.shortcut(x)))


class BasicStem(nn.Module):
    def __init__(self, in_channels: int = 3, out_channels: int = 64):
        super().__init__()
        self.conv1 = Conv2d(in_channels, out_channels, 7, stride=2, padding=3)

    def forward(self, x):
        return F.max_pool2d(F.relu(self.conv1(x)), kernel_size=3, stride=2, padding=1)


class ResNet(nn.Module):
    """Maps an NHWC image to {name: NHWC map} for the names in ``out_features``."""

    def __init__(self, depth: int = 50, stem_channels: int = 64, base_channels: int = 256,
                 out_features: Sequence[str] = ("res3", "res4", "res5"), freeze_at: int = 2):
        super().__init__()
        self.out_features = tuple(out_features)
        self.freeze_at = freeze_at
        self.stem = BasicStem(3, stem_channels)
        in_ch, out_ch, bottleneck_ch = stem_channels, base_channels, base_channels // 4
        self.stage_names = []
        for stage_idx, num_blocks in enumerate(BLOCKS_PER_STAGE[depth]):
            blocks = []
            for i in range(num_blocks):
                stride = 2 if stage_idx > 0 and i == 0 else 1
                blocks.append(BottleneckBlock(in_ch, out_ch, bottleneck_ch, stride,
                                              has_shortcut=i == 0))
                in_ch = out_ch
            name = f"res{stage_idx + 2}"
            self.add_module(name, nn.Sequential(*blocks))
            self.stage_names.append(name)
            out_ch *= 2
            bottleneck_ch *= 2

    def forward(self, x) -> Dict[str, torch.Tensor]:
        x = self.stem(nhwc_to_nchw(x.to(self.stem.conv1.weight.dtype)))
        if self.freeze_at >= 1:
            x = x.detach()
        outputs = {}
        for k, name in enumerate(self.stage_names, start=2):
            x = getattr(self, name)(x)
            if self.freeze_at >= k:
                x = x.detach()
            if name in self.out_features:
                outputs[name] = nchw_to_nhwc(x)
        return outputs


def resnet_feature_channels(depth: int, base_channels: int = 256) -> Dict[str, int]:
    return {f"res{i + 2}": base_channels * (2 ** i) for i in range(4)}
