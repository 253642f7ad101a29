"""Plain PyTorch versions of the port's kernels against the JAX package.

K-A (ViT global attention): ``vit_attention_plain`` against ``_attention_xla``
and against the Pallas kernels ``_fwd_pallas_v1`` / ``_fwd_pallas_v2`` run in
interpret mode, as tests/test_vit_flash.py runs them.
K-B (multi-scale deformable attention): ``ms_deform_attn_plain`` against
``ms_deform_attn_jnp`` ("flat" in f32, "flat6_bf16" in bf16) and the numpy
loop oracle of tests/test_ms_deform_attn.py, on its shapes, including the
4-level shape and samples outside [0, 1].
The wrappers take the plain version for CPU tensors; that is checked too.
Inputs come from numpy seeds and go to both sides.
"""

import torch_threads  # noqa: F401  (first: sizes torch's CPU threads)
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from hipie_tpu.ops.ms_deform_attn import ms_deform_attn_jnp
from hipie_tpu.ops.pallas import vit_attention_kernel as K
from hipie_torch.ops.ms_deform_attn import ms_deform_attn, ms_deform_attn_plain
from hipie_torch.ops.vit_attention import vit_attention_plain, vit_global_attention
from test_ms_deform_attn import make_inputs, naive_msda


@pytest.fixture(autouse=True)
def _no_trace_overrides(monkeypatch):
    for var in ("HIPIE_MSDA_METHOD", "HIPIE_GELU", "HIPIE_VIT_FLASH", "HIPIE_VIT_ATTN"):
        monkeypatch.delenv(var, raising=False)


def _vit_inputs(bh, kh, kw, hd, seed):
    r = np.random.RandomState(seed)
    n = kh * kw
    q, k, v = (r.randn(bh, n, hd).astype(np.float32) for _ in range(3))
    rel_h = (0.3 * r.randn(bh, n, kh)).astype(np.float32)
    rel_w = (0.3 * r.randn(bh, n, kw)).astype(np.float32)
    return q, k, v, rel_h, rel_w


@pytest.mark.parametrize("bh,kh,kw,hd", [(2, 4, 4, 16), (3, 6, 5, 80)])
def test_vit_attention_plain_matches_xla(bh, kh, kw, hd):
    """f32 on both sides, same formula: only summation order differs (1e-5)."""
    args = _vit_inputs(bh, kh, kw, hd, seed=kh)
    scale = hd ** -0.5
    want = np.asarray(K._attention_xla(*map(jnp.asarray, args), scale))
    got = vit_attention_plain(*map(torch.from_numpy, args), scale).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("variant", ["v1", "v2"])
def test_vit_attention_plain_matches_pallas_interpret(variant, monkeypatch):
    """The Pallas kernel body in interpret mode. v1 rounds q*scale into the
    kernel's dtype; in f32 both are exact to summation order (2e-5)."""
    import jax.experimental.pallas as pl

    args = _vit_inputs(2, 4, 4, 16, seed=1)
    scale = 16 ** -0.5
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call", lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))
    fwd = K._fwd_pallas_v1 if variant == "v1" else K._fwd_pallas_v2
    want = np.asarray(fwd(*map(jnp.asarray, args), scale, tq=8))
    got = vit_attention_plain(*map(torch.from_numpy, args), scale).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_vit_attention_wrapper_takes_plain_on_cpu():
    args = [torch.from_numpy(a) for a in _vit_inputs(2, 4, 4, 16, seed=2)]
    torch.testing.assert_close(vit_global_attention(*args, 0.25),
                               vit_attention_plain(*args, 0.25), rtol=0, atol=0)


MSDA_CASES = [
    dict(),                                                         # default naive shapes
    dict(d=32),
    dict(b=1, q=37, m=4, d=16, shapes=((10, 12), (5, 6), (3, 3)), p=4),
    dict(b=1, q=64, m=8, d=32, shapes=((16, 16), (8, 8), (4, 4), (2, 2)), p=4),   # 4 levels
]


@pytest.mark.parametrize("case", range(len(MSDA_CASES)))
def test_msda_plain_matches_naive_and_flat(case):
    """f32: the loop oracle (f64) and JAX "flat" agree with the plain version to
    f32 round-off (1e-5)."""
    rng = np.random.default_rng(100 + case)
    value, shapes, loc, w = make_inputs(rng, **MSDA_CASES[case])
    got = ms_deform_attn_plain(torch.from_numpy(value), shapes, torch.from_numpy(loc),
                               torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, naive_msda(value, shapes, loc, w), rtol=1e-5, atol=1e-5)
    flat = np.asarray(ms_deform_attn_jnp(jnp.asarray(value), shapes, jnp.asarray(loc),
                                         jnp.asarray(w), "flat"))
    np.testing.assert_allclose(got, flat, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", range(len(MSDA_CASES)))
def test_msda_plain_bf16_matches_flat6_bf16(case):
    """bf16 values. The plain version samples in f32 from the exact bf16 values
    and rounds once; flat6_bf16 also rounds corner weights and products to bf16,
    so they agree to a few bf16 ulps of outputs of magnitude ~1 (2e-2, the
    bound tests/test_ms_deform_attn.py gives flat6_bf16 against the oracle)."""
    rng = np.random.default_rng(200 + case)
    value, shapes, loc, w = make_inputs(rng, **MSDA_CASES[case])
    value_bf16 = torch.from_numpy(value).to(torch.bfloat16)
    got = ms_deform_attn_plain(value_bf16, shapes, torch.from_numpy(loc), torch.from_numpy(w))
    assert got.dtype == torch.bfloat16
    want = np.asarray(ms_deform_attn_jnp(jnp.asarray(value, jnp.bfloat16), shapes,
                                         jnp.asarray(loc), jnp.asarray(w), "flat6_bf16"),
                      np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2, atol=2e-2)
    # against the f64 oracle on the bf16-rounded values: one output rounding (1e-2)
    exact = naive_msda(value_bf16.float().numpy(), shapes, loc, w)
    np.testing.assert_allclose(got.float().numpy(), exact, rtol=1e-2, atol=1e-2)


def test_msda_wrapper_takes_plain_on_cpu():
    rng = np.random.default_rng(3)
    value, shapes, loc, w = (torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                             for a in make_inputs(rng))
    torch.testing.assert_close(ms_deform_attn(value, shapes, loc, w),
                               ms_deform_attn_plain(value, shapes, loc, w), rtol=0, atol=0)
