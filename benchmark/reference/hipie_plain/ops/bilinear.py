"""Bilinear point sampling (counterpart of hipie_tpu/ops/bilinear.py).

``bilinear_sample`` is JAX's ``bilinear_sample`` and ``bilinear_sample_fastgrad``
in one: ``F.grid_sample`` with ``align_corners=False`` and zero padding at grid =
2 * coords - 1 (the point_rend / MSDA convention), differentiated by
``grid_sample``'s own backward. The JAX package's one-hot matmul splat backward,
and its bf16-operand variant, exist only because a scatter is serialized on a
TPU; on the card the gradient is a scatter-add.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def bilinear_sample(images: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Sample (G, H, W) images at (G, P, 2) normalised (x, y) -> (G, P) f32."""
    grid = (2.0 * coords.float() - 1.0)[:, None]                   # (G, 1, P, 2)
    out = F.grid_sample(images.float()[:, None], grid, mode="bilinear",
                        padding_mode="zeros", align_corners=False)
    return out[:, 0, 0]
