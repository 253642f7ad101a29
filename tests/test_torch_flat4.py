"""The ``flat4`` MSDA formulation and kernel K-C's plain version against JAX.

K-C's plain version ``msda_weighted_segment_sum_plain`` is held against the
JAX package's ``msda_weighted_segment_sum``, both its Pallas kernel body in
interpret mode and its non-TPU branch, on the shapes of
tests/test_ms_deform_attn.py (one block, several blocks, and a ragged N that no
block size divides), in f32 and bf16. Both sides read the same values and sum
in f32, so they agree to f32 summation order (1e-5).

``ms_deform_attn(method="flat4")`` is held against ``ms_deform_attn_jnp`` with
"flat4" (f32) and "flat4_bf16" (bf16 values), on inputs with sampling points
outside [0, 1], and ``MSDeformAttn(msda_method="flat4")`` against the JAX
module under ``HIPIE_MSDA_METHOD=flat4``. Inputs come from numpy seeds and go
to both sides.
"""

import torch_threads  # noqa: F401  (first: sizes torch's CPU threads)
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from hipie_tpu.ops.ms_deform_attn import ms_deform_attn_jnp
from hipie_tpu.ops.pallas.msda_reduce_kernel import msda_weighted_segment_sum as j_segment_sum
from hipie_torch.ops.ms_deform_attn import ms_deform_attn, ms_deform_attn_plain
from hipie_torch.ops.msda_reduce import msda_weighted_segment_sum, msda_weighted_segment_sum_plain
from test_ms_deform_attn import make_inputs, naive_msda


@pytest.fixture(autouse=True)
def _no_trace_overrides(monkeypatch):
    for var in ("HIPIE_MSDA_METHOD", "HIPIE_GELU", "HIPIE_VIT_FLASH", "HIPIE_VIT_ATTN"):
        monkeypatch.delenv(var, raising=False)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,k,fd,block_rows", [
    (96, 16, 32, 8192),     # one block
    (4096, 16, 32, 512),    # several blocks, the block divides N
    (4092, 12, 64, 500),    # ragged: N is no multiple of the block
])
def test_segment_sum_plain_matches_jax(n, k, fd, block_rows, dtype):
    rng = np.random.default_rng(n + k)
    jdt = getattr(jnp, dtype)
    g = jnp.asarray(rng.standard_normal((n, fd)).astype(np.float32), jdt)
    cw = jnp.asarray(rng.uniform(0, 1, (n, 4)).astype(np.float32), jdt)
    interp = np.asarray(j_segment_sum(g, cw, k, block_rows=block_rows, interpret=True))
    branch = np.asarray(j_segment_sum(g, cw, k))
    tdt = getattr(torch, dtype)
    tg = torch.from_numpy(np.array(g.astype(jnp.float32))).to(tdt)
    tcw = torch.from_numpy(np.array(cw.astype(jnp.float32))).to(tdt)
    got = msda_weighted_segment_sum_plain(tg, tcw, k)
    assert got.dtype == torch.float32 and tuple(got.shape) == (n // k, fd)
    np.testing.assert_allclose(got.numpy(), interp, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), branch, rtol=1e-5, atol=1e-5)
    # a CPU tensor takes the wrapper to the plain version
    assert torch.equal(msda_weighted_segment_sum(tg, tcw, k), got)


def test_segment_sum_rejects_a_partial_segment():
    with pytest.raises(ValueError):
        msda_weighted_segment_sum_plain(torch.zeros(30, 8), torch.zeros(30, 4), 16)


FLAT4_CASES = {
    "small": dict(),
    "multiblock": dict(b=2, q=37, m=4, d=16, shapes=((10, 12), (5, 6), (3, 3)), p=4),
}


@pytest.mark.parametrize("case", sorted(FLAT4_CASES))
def test_flat4_f32_matches_jax_flat4(case):
    """f32 tables on both sides: summation order only (1e-5); the numpy loop
    oracle agrees as closely."""
    value, shapes, loc, w = make_inputs(np.random.default_rng(17), **FLAT4_CASES[case])
    want = np.asarray(ms_deform_attn_jnp(jnp.array(value), shapes, jnp.array(loc),
                                         jnp.array(w), "flat4"))
    got = ms_deform_attn(torch.from_numpy(value), shapes, torch.from_numpy(loc),
                         torch.from_numpy(w), method="flat4")
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), naive_msda(value, shapes, loc, w),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", sorted(FLAT4_CASES))
def test_flat4_bf16_matches_jax_flat4_bf16(case):
    """bf16 values give bf16 tables and bf16 corner weights on both sides; the
    f32 sums differ in order only. The two bf16 outputs may then round one ulp
    apart (2^-7 of the output scale), and a corner weight whose f32 value lies
    on a bf16 rounding boundary may round one ulp apart (2^-8 of it, times the
    value scale)."""
    value, shapes, loc, w = make_inputs(np.random.default_rng(19), **FLAT4_CASES[case])
    vb = jnp.array(value, jnp.bfloat16)
    want = np.asarray(ms_deform_attn_jnp(vb, shapes, jnp.array(loc), jnp.array(w),
                                         "flat4_bf16").astype(jnp.float32))
    tv = torch.from_numpy(np.array(vb.astype(jnp.float32))).to(torch.bfloat16)
    got = ms_deform_attn(tv, shapes, torch.from_numpy(loc), torch.from_numpy(w), method="flat4")
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    tol = 2 ** -7 * np.abs(want).max() + 2 ** -8 * np.abs(value).max()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)


def test_flat4_matches_fused_at_four_levels():
    """The two port formulations on a 4-level encoder-like shape (Q = S, f32):
    the same bilinear samples, summed in another order (1e-5)."""
    shapes = ((10, 15), (5, 8), (3, 4), (2, 2))
    s = sum(h * w for h, w in shapes)
    value, shapes, loc, w = make_inputs(np.random.default_rng(23), b=1, q=s, m=8, d=4,
                                        shapes=shapes, p=4)
    args = (torch.from_numpy(value), shapes, torch.from_numpy(loc), torch.from_numpy(w))
    got = ms_deform_attn(*args, method="flat4")
    np.testing.assert_allclose(got.numpy(), ms_deform_attn_plain(*args).numpy(),
                               rtol=1e-5, atol=1e-5)


def test_unknown_method_raises():
    from hipie_torch.models.msda_module import MSDeformAttn

    value, shapes, loc, w = make_inputs(np.random.default_rng(0))
    with pytest.raises(ValueError):
        ms_deform_attn(torch.from_numpy(value), shapes, torch.from_numpy(loc),
                       torch.from_numpy(w), method="flat6_bf16")
    with pytest.raises(ValueError):
        MSDeformAttn(32, 2, 2, 3, msda_method="flat4_bf16")


@pytest.mark.parametrize("ref_dim", [2, 4])
def test_msdeformattn_flat4_matches_jax(ref_dim, monkeypatch):
    """The module with its projections and a padded value row, against the JAX
    module tracing its flat4 path (f32: 1e-5)."""
    import jax
    from hipie_tpu.models.msda_module import MSDeformAttn as JMSDA
    from hipie_tpu.utils import export as ex
    from hipie_torch.models.msda_module import MSDeformAttn

    monkeypatch.setenv("HIPIE_MSDA_METHOD", "flat4")
    shapes = ((8, 6), (4, 3), (2, 2))
    s = sum(h * w for h, w in shapes)
    b, q, c = 2, 11, 32
    r = np.random.RandomState(10 + ref_dim)
    query = r.randn(b, q, c).astype(np.float32)
    value = r.randn(b, s, c).astype(np.float32)
    ref = r.uniform(0.05, 0.95, (b, q, len(shapes), ref_dim)).astype(np.float32)
    if ref_dim == 4:
        ref[..., 2:] *= 0.5
    pad = np.zeros((b, s), bool)
    pad[1, -5:] = True
    jm = JMSDA(c, len(shapes), 4, 3)
    params = jax.tree_util.tree_map(
        lambda x: (0.2 * r.randn(*np.shape(x))).astype(np.float32),
        jax.device_get(jm.init(jax.random.PRNGKey(0), query, ref, value, shapes, pad)["params"]))
    want = np.asarray(jm.apply({"params": params}, query, ref, value, shapes, pad))

    tm = MSDeformAttn(c, len(shapes), 4, 3, msda_method="flat4")
    sd = {}
    ex.inv_msda(params, "m", sd)
    tm.load_state_dict({k[2:]: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()},
                       strict=True)
    with torch.no_grad():
        got = tm(*map(torch.from_numpy, (query, ref, value)), shapes, torch.from_numpy(pad))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
