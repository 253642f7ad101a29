"""MSDeformAttn: projections and sampling-location math around the MSDA op.

Counterpart of hipie_tpu/models/msda_module.py (reference
ops/modules/ms_deform_attn.py): value projection with pad masking, per-query
sampling offsets and softmaxed attention weights, 2-d points or 4-d boxes as
reference points. Locations and weights are f32; the sampled output is cast to
the compute dtype before output_proj. ``msda_method`` picks the sampling core
as the JAX package's ``HIPIE_MSDA_METHOD`` does: "fused" (kernel K-B) or
"flat4" (quad-table gather + kernel K-C).

Under sequence parallelism (``tokens``: this rank's share of the encoder's
tokens, which are both the queries and the value) the value projection and
its pad masking run on the share, and the (B, S, M, D) value table is gathered
whole over the model group; the sampling then takes the rank's queries
against all S tokens. The gather's backward sums the ranks' partial value
gradients.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn

from hipie_torch.ops.ms_deform_attn import MSDA_METHODS, ms_deform_attn
from hipie_torch.parallel.tensor import gather_tokens
from hipie_torch.utils.trace import count

Shapes = Tuple[Tuple[int, int], ...]


class MSDeformAttn(nn.Module):
    def __init__(self, d_model: int = 256, n_levels: int = 4, n_heads: int = 8,
                 n_points: int = 4, msda_method: str = "fused"):
        super().__init__()
        if msda_method not in MSDA_METHODS:
            raise ValueError(f"msda_method must be one of {MSDA_METHODS}, got {msda_method!r}")
        self.d_model, self.n_levels, self.n_heads, self.n_points = (
            d_model, n_levels, n_heads, n_points)
        self.msda_method = msda_method
        self.sampling_offsets = nn.Linear(d_model, n_heads * n_levels * n_points * 2)
        self.attention_weights = nn.Linear(d_model, n_heads * n_levels * n_points)
        self.value_proj = nn.Linear(d_model, d_model)
        self.output_proj = nn.Linear(d_model, d_model)
        self._reset_parameters()

    def _reset_parameters(self):
        # radial grid bias: head h points at angle 2*pi*h/H, scaled by point index
        nn.init.zeros_(self.sampling_offsets.weight)
        thetas = torch.arange(self.n_heads, dtype=torch.float32) * (2.0 * math.pi / self.n_heads)
        grid = torch.stack([thetas.cos(), thetas.sin()], -1)
        grid = grid / grid.abs().max(-1, keepdim=True)[0]
        grid = grid[:, None, None, :].repeat(1, self.n_levels, self.n_points, 1)
        grid = grid * torch.arange(1, self.n_points + 1, dtype=torch.float32)[None, None, :, None]
        with torch.no_grad():
            self.sampling_offsets.bias.copy_(grid.reshape(-1))
        nn.init.zeros_(self.attention_weights.weight)
        nn.init.zeros_(self.attention_weights.bias)

    def forward(self, query, reference_points, value, spatial_shapes: Sequence[Tuple[int, int]],
                padding_mask: Optional[torch.Tensor] = None, tokens=None):
        """query (B, Q, C); reference_points (B, Q, L, 2|4) in [0, 1]; value (B, S, C);
        padding_mask (B, S) True = pad; under ``tokens`` value and padding_mask
        hold the rank's share of S. Returns (B, Q, C)."""
        b, q, _ = query.shape
        m, n_levels, p = self.n_heads, self.n_levels, self.n_points
        v = self.value_proj(value)
        if padding_mask is not None:
            v = v.masked_fill(padding_mask[..., None], 0.0)
        if tokens is not None:
            v = gather_tokens(v, tokens)
        v = v.reshape(b, v.shape[1], m, self.d_model // m)
        offsets = self.sampling_offsets(query).reshape(b, q, m, n_levels, p, 2).float()
        weights = self.attention_weights(query).reshape(b, q, m, n_levels * p).float()
        weights = weights.softmax(-1).reshape(b, q, m, n_levels, p)
        ref = reference_points.float()
        if ref.shape[-1] == 2:
            count("host_sync.msda_normalizer")      # a blocking copy to ref's device
            normalizer = torch.tensor([[w, h] for h, w in spatial_shapes], dtype=torch.float32,
                                      device=ref.device)
            loc = ref[:, :, None, :, None, :] + offsets / normalizer[None, None, None, :, None, :]
        else:
            loc = ref[:, :, None, :, None, :2] + offsets / p * ref[:, :, None, :, None, 2:] * 0.5
        out = ms_deform_attn(v, spatial_shapes, loc.contiguous(), weights.contiguous(),
                             method=self.msda_method)
        return self.output_proj(out.to(query.dtype))
