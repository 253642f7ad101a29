"""ViTDet global attention with the decomposed rel-pos bias, plain: the
materialised logits and softmax (the port's ``vit_attention_plain``, frozen),
differentiable by autograd. The reference has no kernels."""

from __future__ import annotations

import torch

_HEAD_DIMS = (16, 64, 80)


def vit_attention_logits(q, k, rel_h, rel_w, scale: float) -> torch.Tensor:
    """(BH, N, N) f32: q k^T * scale + rel_h[q, k // Kw] + rel_w[q, k % Kw]."""
    bh, n, _ = q.shape
    kh, kw = rel_h.shape[2], rel_w.shape[2]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    bias = (rel_h.float()[:, :, :, None] + rel_w.float()[:, :, None, :]).reshape(bh, n, kh * kw)
    return s + bias


def vit_attention_plain(q, k, v, rel_h, rel_w, scale: float) -> torch.Tensor:
    """Materialised bias + softmax, as ``_attention_xla``.

    q, k, v: (BH, N, hd); rel_h: (BH, N, Kh); rel_w: (BH, N, Kw); N == Kh * Kw.
    Logits and softmax in f32, probabilities cast to v's dtype before P.V.
    """
    p = torch.softmax(vit_attention_logits(q, k, rel_h, rel_w, scale), dim=-1).to(v.dtype)
    return torch.einsum("bqk,bkd->bqd", p, v)


def vit_attention_bwd_plain(q, k, v, rel_h, rel_w, out, lse, dout, scale: float):
    """The plain version of K-E: (dq, dk, dv, d rel_h, d rel_w), each in its
    input's dtype, of ``vit_attention_plain`` at the cotangent ``dout``, from
    its output ``out`` and the f32 per-row logsumexp ``lse`` (BH, N) of the
    logits. Step by step as the kernel: P recomputed from lse, D =
    rowsum(dout * out), dS = P (dout v^T - D), the three products (P cast to
    v's dtype for dv, as the forward rounds it), and the bias gradients as sums
    of dS over each key row (d rel_h) and each key column (d rel_w)."""
    bh, n, _ = q.shape
    kh, kw = rel_h.shape[2], rel_w.shape[2]
    p = torch.exp(vit_attention_logits(q, k, rel_h, rel_w, scale) - lse.float()[..., None])
    g = dout.float()
    dv = torch.einsum("bqk,bqd->bkd", p.to(v.dtype).float(), g)
    dp = torch.einsum("bqd,bkd->bqk", g, v.float())
    d = (g * out.float()).sum(-1, keepdim=True)
    ds = p * (dp - d)
    dq = torch.einsum("bqk,bkd->bqd", ds, k.float()) * scale
    dk = torch.einsum("bqk,bqd->bkd", ds, q.float()) * scale
    ds4 = ds.reshape(bh, n, kh, kw)
    return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), ds4.sum(-1).to(rel_h.dtype),
            ds4.sum(-2).to(rel_w.dtype))


def vit_global_attention(q, k, v, rel_h, rel_w, scale: float) -> torch.Tensor:
    """softmax(q k^T * scale + rel_h[q, k // Kw] + rel_w[q, k % Kw]) @ v, plain."""
    return vit_attention_plain(q, k, v, rel_h, rel_w, scale)
