"""The MSDA backward of the port on the CPU: the plain version's gradient
(``F.grid_sample``'s autograd) against JAX's ``jax.vjp`` of
``ms_deform_attn_train`` (its hand-written ``_msda_train_bwd``), and a replay of
kernel K-D's per-sample arithmetic (csrc/ms_deform_attn_bwd.cu: clamped corner
setup, per-corner validity, the corner dots s_c and the closed forms of the
three gradients, the scatter into an f32 buffer) against the same gradient.
Locations reach past every edge of the map, so that samples with one, two or
no corners inside are all covered. f32 throughout: the two sides sum the same
products in other orders, 1e-5 relative in norm.
"""

import torch_threads  # noqa: F401  (first: sizes torch's CPU threads)
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from hipie_torch.ops.ms_deform_attn import (backward_plan, ms_deform_attn,
                                            ms_deform_attn_backward_plain, ms_deform_attn_plain)

LEVELS = ((6, 7), (3, 4), (2, 1))


def inputs(seed, b=2, q=5, m=2, d=6, p=3, lo=-0.25, hi=1.25):
    r = np.random.RandomState(seed)
    s = sum(h * w for h, w in LEVELS)
    value = r.randn(b, s, m, d).astype(np.float32)
    loc = r.uniform(lo, hi, (b, q, m, len(LEVELS), p, 2)).astype(np.float32)
    w = r.uniform(0, 1, (b, q, m, len(LEVELS), p)).astype(np.float32)
    gout = r.randn(b, q, m * d).astype(np.float32)
    return value, loc, w, gout


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.mark.parametrize("seed,lo,hi", [(0, -0.25, 1.25), (1, 0.0, 1.0), (2, -1.5, 2.5)])
def test_plain_backward_matches_jax_vjp(seed, lo, hi):
    """grad value, locations and weights of the port's plain MSDA equal
    jax.vjp(ms_deform_attn_train) in f32 ("flat"), samples off the map included."""
    from hipie_tpu.ops.ms_deform_attn import ms_deform_attn_train

    value, loc, w, gout = inputs(seed, lo=lo, hi=hi)
    out, vjp = jax.vjp(lambda v, l, a: ms_deform_attn_train(v, LEVELS, l, a, "flat"),
                       jnp.asarray(value), jnp.asarray(loc), jnp.asarray(w))
    want = vjp(jnp.asarray(gout))
    got = ms_deform_attn_backward_plain(torch.from_numpy(value), LEVELS, torch.from_numpy(loc),
                                        torch.from_numpy(w), torch.from_numpy(gout))
    np.testing.assert_allclose(
        ms_deform_attn_plain(torch.from_numpy(value), LEVELS, torch.from_numpy(loc),
                             torch.from_numpy(w)).numpy(), np.asarray(out), atol=1e-5)
    for name, g, j in zip(("value", "loc", "weights"), got, want):
        assert rel(g.numpy(), j) <= 1e-5, name


def kd_replay(value, loc, attw, gout, levels):
    """K-D's arithmetic, vectorised over samples: the kernel's clamp of the
    pixel coordinates to [-2, W+1], floor, per-corner validity, s_c, and the
    three closed forms; grad value scattered into an f32 buffer."""
    b, s, m, d = value.shape
    q, n_levels, p = loc.shape[1], loc.shape[3], loc.shape[4]
    starts = np.cumsum([0] + [h * w for h, w in levels])[:-1]
    gv = torch.zeros(b, s, m, d, dtype=torch.float32)
    gl = torch.zeros_like(loc)
    ga = torch.zeros_like(attw)
    go = gout.reshape(b, q, m, d).float()
    bi = torch.arange(b)[:, None, None, None]
    mi = torch.arange(m)[None, None, :, None]
    for lvl, (h, w) in enumerate(levels):
        x = (loc[:, :, :, lvl, :, 0] * w - 0.5).clamp(-2.0, w + 1.0)        # (B, Q, M, P)
        y = (loc[:, :, :, lvl, :, 1] * h - 0.5).clamp(-2.0, h + 1.0)
        x0, y0 = x.floor(), y.floor()
        lx, ly = x - x0, y - y0
        x0, y0 = x0.long(), y0.long()
        a = attw[:, :, :, lvl]
        corners = [(y0, x0, (1 - ly) * (1 - lx)), (y0, x0 + 1, (1 - ly) * lx),
                   (y0 + 1, x0, ly * (1 - lx)), (y0 + 1, x0 + 1, ly * lx)]
        sc, cws = [], []
        for cy, cx, cw in corners:
            ok = (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h)
            row = starts[lvl] + cy.clamp(0, h - 1) * w + cx.clamp(0, w - 1)      # (B, Q, M, P)
            v = value[bi, row, mi].float() * ok[..., None]                    # (B, Q, M, P, D)
            sc.append((v * go[:, :, :, None, :]).sum(-1))
            cws.append(cw)
            upd = (a * cw * ok)[..., None] * go[:, :, :, None, :]            # (B, Q, M, P, D)
            gv.index_put_((bi.expand_as(row), row, mi.expand_as(row)), upd, accumulate=True)
        s0, s1, s2, s3 = sc
        ga[:, :, :, lvl] = sum(c * s_ for c, s_ in zip(cws, sc))
        gl[:, :, :, lvl, :, 0] = a * w * ((1 - ly) * (s1 - s0) + ly * (s3 - s2))
        gl[:, :, :, lvl, :, 1] = a * h * ((1 - lx) * (s2 - s0) + lx * (s3 - s1))
    return gv, gl, ga


@pytest.mark.parametrize("seed,lo,hi", [(0, -0.25, 1.25), (3, -1.5, 2.5)])
def test_kd_arithmetic_matches_autograd(seed, lo, hi):
    value, loc, w, gout = (torch.from_numpy(x) for x in inputs(seed, lo=lo, hi=hi))
    want = ms_deform_attn_backward_plain(value, LEVELS, loc, w, gout)
    got = kd_replay(value, loc, w, gout, LEVELS)
    for name, g, j in zip(("value", "loc", "weights"), got, want):
        assert rel(g.numpy(), j.numpy()) <= 1e-5, name


def test_kd_plan():
    """Four channels a thread where the row and its alignment allow, else one;
    threads per pair a power of two covering the row's vectors 4 at a time."""
    assert backward_plan(32, 2, 256) == (4, 8)
    assert backward_plan(32, 4, 256) == (4, 8)
    assert backward_plan(128, 4, 256) == (4, 32)
    assert backward_plan(33, 4, 256) == (1, 32)
    assert backward_plan(32, 2, 4) == (1, 32)
    assert backward_plan(6, 4, 256) == (1, 8)
    for d in range(1, 129):
        vc, tpp = backward_plan(d, 4, 16)
        assert d % vc == 0 and d // vc <= 4 * tpp and tpp & (tpp - 1) == 0 and tpp <= 32


def test_cpu_gradient_is_grid_sample_autograd():
    """On a CPU tensor ms_deform_attn is the plain version, differentiable by
    autograd, for "fused" and for "flat4" alike."""
    value, loc, w, gout = (torch.from_numpy(x) for x in inputs(4))
    want = ms_deform_attn_backward_plain(value, LEVELS, loc, w, gout)
    for method in ("fused", "flat4"):
        v, l, a = (t.clone().requires_grad_(True) for t in (value, loc, w))
        ms_deform_attn(v, LEVELS, l, a, method=method).backward(gout)
        for name, g, j in zip(("value", "loc", "weights"), (v.grad, l.grad, a.grad), want):
            assert rel(g.numpy(), j.numpy()) <= 1e-5, (method, name)
