"""ViTDet global attention with the decomposed rel-pos bias (kernel K-A).

Counterpart of hipie_tpu/ops/pallas/vit_attention_kernel.py. ``vit_global_attention``
takes a CPU tensor to the plain version and a CUDA tensor to the hand-written
Hopper kernel in ``hipie_torch/csrc/vit_attention.cu`` (TMA loads, wgmma, online
softmax in registers); there is no fallback between the two.
"""

from __future__ import annotations

import torch

from hipie_torch import kernels


def vit_attention_plain(q, k, v, rel_h, rel_w, scale: float) -> torch.Tensor:
    """Materialised bias + softmax, as ``_attention_xla``.

    q, k, v: (BH, N, hd); rel_h: (BH, N, Kh); rel_w: (BH, N, Kw); N == Kh * Kw.
    Logits and softmax in f32, probabilities cast to v's dtype before P.V.
    """
    bh, n, _ = q.shape
    kh, kw = rel_h.shape[2], rel_w.shape[2]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    bias = (rel_h.float()[:, :, :, None] + rel_w.float()[:, :, None, :]).reshape(bh, n, kh * kw)
    p = torch.softmax(s + bias, dim=-1).to(v.dtype)
    return torch.einsum("bqk,bkd->bqd", p, v)


def vit_global_attention(q, k, v, rel_h, rel_w, scale: float) -> torch.Tensor:
    """softmax(q k^T * scale + rel_h[q, k // Kw] + rel_w[q, k % Kw]) @ v."""
    if q.device.type == "cpu":
        return vit_attention_plain(q, k, v, rel_h, rel_w, scale)
    if q.device.type != "cuda":
        raise ValueError(f"vit_global_attention: unsupported device {q.device}")
    bh, n, hd = q.shape
    kh, kw = rel_h.shape[-1], rel_w.shape[-1]
    for name, t, shape in (("q", q, (bh, n, hd)), ("k", k, (bh, n, hd)), ("v", v, (bh, n, hd)),
                           ("rel_h", rel_h, (bh, n, kh)), ("rel_w", rel_w, (bh, n, kw))):
        if t.device != q.device or t.dtype != torch.bfloat16:
            raise ValueError(f"vit_global_attention: {name} must be bf16 on {q.device}, "
                             f"got {t.dtype} on {t.device}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"vit_global_attention: {name} must be contiguous {shape}, "
                             f"got {tuple(t.shape)}")
    if kh * kw != n:
        raise ValueError(f"vit_global_attention: Kh * Kw = {kh * kw} != N = {n}")
    if hd not in (16, 64, 80):
        raise ValueError(f"vit_global_attention: head dim {hd} not built")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("vit_global_attention: q, k and v must start on 16-byte boundaries "
                         "(TMA)")
    from hipie_torch.kernels import build

    lib = build.load()
    out = torch.empty_like(q)
    err = lib.hipie_vit_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), rel_h.data_ptr(), rel_w.data_ptr(),
        out.data_ptr(), bh, n, hd, kh, kw, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "vit_global_attention")
    kernels.LAUNCHES["vit_attention"] += 1
    return out
