"""ViTDet global attention with the decomposed rel-pos bias (kernels K-A and K-E).

Counterpart of hipie_tpu/ops/pallas/vit_attention_kernel.py, custom VJP
included. ``vit_global_attention`` takes a CPU tensor to the plain version (and
its autograd) and a CUDA tensor to the hand-written Hopper kernels: K-A
(``hipie_torch/csrc/vit_attention.cu``: TMA loads, wgmma, online softmax in
registers) forward and, when an input requires grad, ``ViTAttentionFunction``,
whose forward also has K-A write the per-row logsumexp and whose backward is
K-E (``hipie_torch/csrc/vit_attention_bwd.cu``: a wgmma + TMA design at the
training shapes, mma.sync passes elsewhere, chosen by shape in C). There
is no fallback between the two: on a CUDA tensor a kernel launches or the call
raises.
"""

from __future__ import annotations

import torch

from hipie_torch import kernels

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


def _check_cuda(what, q, named):
    """The kernels' contract: bf16 (f32 for lse), contiguous, on q's device,
    16-byte aligned rows of a built head dim; raises on anything else."""
    bh, n, hd = q.shape
    for name, t, shape, dtype in named:
        if t.device != q.device or t.dtype != dtype:
            raise ValueError(f"{what}: {name} must be {dtype} on {q.device}, "
                             f"got {t.dtype} on {t.device}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous {shape}, got {tuple(t.shape)}")
    if hd not in _HEAD_DIMS:
        raise ValueError(f"{what}: head dim {hd} not built")
    rows = ("q", "k", "v", "out", "dout")
    if any(t.data_ptr() % 16 for name, t, _, _ in named if name in rows):
        raise ValueError(f"{what}: the (BH, N, hd) operands must start on 16-byte boundaries")


def _inputs(q, k, v, rel_h, rel_w):
    bh, n, hd = q.shape
    kh, kw = rel_h.shape[-1], rel_w.shape[-1]
    if kh * kw != n:
        raise ValueError(f"vit_global_attention: Kh * Kw = {kh * kw} != N = {n}")
    bf = torch.bfloat16
    return [("q", q, (bh, n, hd), bf), ("k", k, (bh, n, hd), bf), ("v", v, (bh, n, hd), bf),
            ("rel_h", rel_h, (bh, n, kh), bf), ("rel_w", rel_w, (bh, n, kw), bf)]


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _forward_kernel(q, k, v, rel_h, rel_w, scale: float, with_lse: bool):
    """K-A: out, and lse (BH, N) f32 when ``with_lse`` (else None)."""
    if q.device.type != "cuda":
        raise ValueError(f"vit_global_attention: unsupported device {q.device}")
    _check_cuda("vit_global_attention", q, _inputs(q, k, v, rel_h, rel_w))
    from hipie_torch.kernels import build

    bh, n, hd = q.shape
    lib = build.load()
    out = torch.empty_like(q)
    lse = torch.empty(bh, n, device=q.device, dtype=torch.float32) if with_lse else None
    err = lib.hipie_vit_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), rel_h.data_ptr(), rel_w.data_ptr(),
        out.data_ptr(), lse.data_ptr() if with_lse else None, bh, n, hd, rel_h.shape[-1],
        rel_w.shape[-1], float(scale), _stream(q))
    build.check(err, "vit_global_attention")
    kernels.LAUNCHES["vit_attention"] += 1
    return out, lse


def vit_attention_forward(q, k, v, rel_h, rel_w, scale: float):
    """(out, lse): the attention and the f32 per-row logsumexp of its logits;
    K-A on a CUDA tensor, the plain version on a CPU one."""
    if q.device.type == "cpu":
        return (vit_attention_plain(q, k, v, rel_h, rel_w, scale),
                torch.logsumexp(vit_attention_logits(q, k, rel_h, rel_w, scale), -1))
    return _forward_kernel(q, k, v, rel_h, rel_w, scale, with_lse=True)


def vit_attention_backward(q, k, v, rel_h, rel_w, out, lse, dout, scale: float):
    """(dq, dk, dv, d rel_h, d rel_w): K-E on a CUDA tensor, its plain version
    on a CPU one."""
    if q.device.type == "cpu":
        return vit_attention_bwd_plain(q, k, v, rel_h, rel_w, out, lse, dout, scale)
    if q.device.type != "cuda":
        raise ValueError(f"vit_attention_backward: unsupported device {q.device}")
    bh, n, hd = q.shape
    _check_cuda("vit_attention_backward", q, _inputs(q, k, v, rel_h, rel_w) + [
        ("out", out, (bh, n, hd), torch.bfloat16), ("dout", dout, (bh, n, hd), torch.bfloat16),
        ("lse", lse, (bh, n), torch.float32)])
    from hipie_torch.kernels import build

    lib = build.load()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    drel_h, drel_w = torch.empty_like(rel_h), torch.empty_like(rel_w)
    # scratch between the passes: D (BH, N), then the folded bias table (BH, Kh, N)
    dvec = torch.empty(bh * n * (1 + rel_h.shape[-1]), device=q.device, dtype=torch.float32)
    err = lib.hipie_vit_attention_bwd(
        *(t.data_ptr() for t in (q, k, v, rel_h, rel_w, out, lse, dout, dq, dk, dv, drel_h,
                                 drel_w, dvec)),
        bh, n, hd, rel_h.shape[-1], rel_w.shape[-1], float(scale), _stream(q))
    build.check(err, "vit_attention_backward")
    kernels.LAUNCHES["vit_attention_bwd"] += 1
    return dq, dk, dv, drel_h, drel_w


def vit_attention_bwd_design(n: int, hd: int, kh: int, kw: int) -> str:
    """The design K-E's C entry point takes at a shape: "wgmma" (Kw = 64, hd 64
    or 80, N a multiple of 128: every ViT-H and ViT-L training call) or
    "mma.sync" (every other shape). Builds the kernels if needed."""
    from hipie_torch.kernels import build

    return "wgmma" if build.load().hipie_vit_attention_bwd_design(n, hd, kh, kw) else "mma.sync"


class ViTAttentionFunction(torch.autograd.Function):
    """vit_global_attention with its gradient, as the JAX package's custom VJP:
    the forward keeps q, k, v, rel_h, rel_w, the output and the logsumexp, and
    the backward recomputes P from them (K-E on the card) instead of keeping
    the (BH, N, N) probabilities."""

    @staticmethod
    def forward(ctx, q, k, v, rel_h, rel_w, scale):
        out, lse = vit_attention_forward(q, k, v, rel_h, rel_w, scale)
        ctx.save_for_backward(q, k, v, rel_h, rel_w, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        grads = vit_attention_backward(*ctx.saved_tensors, dout.contiguous(), ctx.scale)
        return (*grads, None)


def vit_global_attention(q, k, v, rel_h, rel_w, scale: float) -> torch.Tensor:
    """softmax(q k^T * scale + rel_h[q, k // Kw] + rel_w[q, k % Kw]) @ v.

    On the CPU the plain version, differentiable by autograd. On the card K-A;
    where grad is enabled and an input requires it, through
    ``ViTAttentionFunction`` (K-A with the logsumexp, K-E backward)."""
    if q.device.type == "cpu":
        return vit_attention_plain(q, k, v, rel_h, rel_w, scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, rel_h, rel_w)):
        return ViTAttentionFunction.apply(q, k, v, rel_h, rel_w, scale)
    return _forward_kernel(q, k, v, rel_h, rel_w, scale, with_lse=False)[0]
