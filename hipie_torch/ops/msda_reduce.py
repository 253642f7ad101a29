"""Weighted segment sum of gathered MSDA corner rows (kernel K-C).

Counterpart of hipie_tpu/ops/pallas/msda_reduce_kernel.py::
msda_weighted_segment_sum, the reduce half of the ``flat4`` MSDA formulation:
for g (N, 4d) corner-packed rows and cw (N, 4) per-corner weights,

    out[s] = sum_{r < K} g[s*K + r] * repeat(cw[s*K + r], d)      in f32.

``msda_weighted_segment_sum`` takes a CPU tensor to the plain version and a
CUDA tensor to the hand-written kernel in ``hipie_torch/csrc/msda_reduce.cu``;
there is no fallback between the two.
"""

from __future__ import annotations

import torch

from hipie_torch import kernels


def msda_weighted_segment_sum_plain(g: torch.Tensor, cw: torch.Tensor, k: int) -> torch.Tensor:
    """The JAX function's non-TPU branch: (N, 4d), (N, 4) -> (N // k, 4d) f32."""
    n, fd = g.shape
    if n % k:
        raise ValueError(f"msda_weighted_segment_sum: N={n} is not a multiple of K={k}")
    gw = g.float() * cw.float().repeat_interleave(fd // 4, dim=1)
    return gw.reshape(n // k, k, fd).sum(1)


def msda_weighted_segment_sum(g: torch.Tensor, cw: torch.Tensor, k: int) -> torch.Tensor:
    """(N, 4d) rows and (N, 4) corner weights, bf16 or f32 alike -> (N // k, 4d) f32."""
    if g.device.type == "cpu":
        return msda_weighted_segment_sum_plain(g, cw, k)
    if g.device.type != "cuda":
        raise ValueError(f"msda_weighted_segment_sum: unsupported device {g.device}")
    if g.dim() != 2 or cw.dim() != 2:
        raise ValueError("msda_weighted_segment_sum: g and cw must be 2-d")
    n, fd = g.shape
    if fd % 4 or fd == 0:
        raise ValueError(f"msda_weighted_segment_sum: row width {fd} is not 4 * d")
    if n == 0 or k <= 0 or n % k:
        raise ValueError(f"msda_weighted_segment_sum: N={n} is not a positive multiple of K={k}")
    if tuple(cw.shape) != (n, 4) or cw.device != g.device:
        raise ValueError(f"msda_weighted_segment_sum: cw must be ({n}, 4) on {g.device}, "
                         f"got {tuple(cw.shape)} on {cw.device}")
    if g.dtype not in (torch.bfloat16, torch.float32) or cw.dtype != g.dtype:
        raise ValueError(f"msda_weighted_segment_sum: g and cw must both be bf16 or both f32, "
                         f"got {g.dtype} and {cw.dtype}")
    if not (g.is_contiguous() and cw.is_contiguous()) or g.data_ptr() % 16:
        raise ValueError("msda_weighted_segment_sum: g and cw must be contiguous, g 16-byte "
                         "aligned (the kernel reads 4 columns per vector load)")
    from hipie_torch.kernels import build

    lib = build.load()
    out = torch.empty((n // k, fd), dtype=torch.float32, device=g.device)
    err = lib.hipie_msda_reduce(g.data_ptr(), cw.data_ptr(), out.data_ptr(), n // k, k, fd // 4,
                                int(g.dtype == torch.bfloat16),
                                torch.cuda.current_stream(g.device).cuda_stream)
    build.check(err, "msda_weighted_segment_sum")
    kernels.LAUNCHES["msda_reduce"] += 1
    return out
