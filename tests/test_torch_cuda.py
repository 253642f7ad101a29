"""Hand-written CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips where no CUDA device exists. The
file imports no JAX, so on a machine without it the tests run with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Inputs are made with numpy from a seed. Tolerances:
  * K-A (bf16 in and out): kernel and plain version both take f32 logits and
    round P to bf16 before P.V; they differ in summation order, in the
    kernel's exp2 of the folded logits (P unnormalised when rounded, the
    plain version's normalised), and in one bf16 rounding of the output.
    A softmax over thousands of keys gives small outputs, so the limits scale
    with the output: |diff| <= 2^-6 max|plain| (2-4 bf16 ulps of the largest
    output), and a relative norm error <= 1e-2, which a scale error or a
    dropped 128-key tile would exceed.
  * K-A's logsumexp: both take f32 logits of the same bf16 inputs; the
    kernel sums exp2 in another order: 1e-4 absolute (the values are ~8).
  * K-E (``chip_smoke.check_vit_attention_bwd``) against
    ``vit_attention_bwd_plain``: relative norm 1e-2 for dq and dk (the kernel
    rounds dS to bf16 for its products, the plain version keeps f32), 2e-3
    for dv, d rel_h and d rel_w (summation order and one output rounding).
  * K-B (``chip_smoke.check_msda``, the limits chip_smoke.py holds it to):
    both read the same values and sample in f32; they differ only in
    summation order: 1e-5 in f32. In bf16 each side then rounds its output
    once, so they differ by at most one bf16 ulp of the largest output,
    |diff| <= 2^-7 max|plain|, and by a relative norm error <= 1e-3, which a
    sample dropped or counted twice (several %) would exceed.
  * K-C: both read the same values and sum in f32: summation order only, 1e-5
    (relative and absolute) in both dtypes.
  * K-D (``chip_smoke.check_msda_bwd``, the limits chip_smoke.py holds it
    to) against the plain version's autograd: f32 summation order (K-D's
    atomics in a changing order) only, 1e-5 relative in norm; in bf16 each side
    rounds its value gradient once (4e-3 in norm) and computes the f32 location
    and weight gradients from the same values (1e-4). Location gradients are
    compared off the pixel lattice, where bilinear sampling has one derivative.
  * ``flat4`` against K-B: in f32 summation order only (1e-5). In bf16 flat4
    rounds each corner weight to bf16 (2^-9 relative), and the weights of a
    (query, head) sum to at most 1, which bounds that part by 2^-9 max|value|;
    each side then rounds its output to bf16 (2^-9 relative each).
  * K-F (greedy NMS) against the plain version on the CPU: none, the keep
    masks must be equal. The answer is discrete and both sides compute each
    IoU with the same f32 operations in the same order, rounded at each step
    (the kernel forbids FMA contraction), so no rounding separates them; one
    decision that differs can change every later one.
"""

import ctypes

import numpy as np
import pytest
import torch

from chip_smoke import (NMS_CASES, check_msda, check_msda_bwd, check_vit_attention_bwd,
                        local_locations, nms_case, predictor_launches)
from hipie_torch import kernels
from hipie_torch.ops import ms_deform_attn as msda_ops
from hipie_torch.ops.ms_deform_attn import (BLOCK_THREADS, BWD_CONSTANTS, BWD_MAX_BINS,
                                            GATHER_BATCH, MAX_PAIRS, TABLE_CHUNK, _host_shapes,
                                            _launch, _ms_deform_attn_backward_design,
                                            backward_plan, bwd_binned_stats, bwd_constants,
                                            bwd_design_rule, kernel_constants,
                                            kernel_plan, ms_deform_attn,
                                            ms_deform_attn_backward,
                                            ms_deform_attn_backward_plain,
                                            ms_deform_attn_bwd_design, ms_deform_attn_plain)
from hipie_torch.ops.msda_reduce import msda_weighted_segment_sum, msda_weighted_segment_sum_plain
from hipie_torch.ops.vit_attention import (vit_attention_backward, vit_attention_bwd_design,
                                           vit_attention_bwd_plain,
                                           vit_attention_forward, vit_attention_logits,
                                           vit_attention_plain, vit_global_attention)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _vit_inputs(bh, kh, kw, hd, seed, dev):
    r = np.random.RandomState(seed)
    n = kh * kw
    mk = lambda *s, sc=1.0: torch.from_numpy(sc * r.randn(*s).astype(np.float32)).to(
        dev, torch.bfloat16)
    return mk(bh, n, hd), mk(bh, n, hd), mk(bh, n, hd), mk(bh, n, kh, sc=0.3), mk(bh, n, kw, sc=0.3)


@pytest.mark.parametrize("bh,kh,kw,hd", [
    (2, 4, 4, 16), (3, 9, 7, 80), (2, 12, 12, 64),
    (16, 64, 64, 80),           # ViT-H, one image: Kw = 64 keeps rel_w in registers
    (32, 64, 64, 80),           # ViT-H, batch 2
    (2, 3, 64, 80),             # Kw = 64, N = 192: a partial last key tile
    (1, 5, 64, 64),             # Kw = 64, N = 320, hd 64
    (2, 20, 20, 80),            # Kw does not divide 128; N = 400
    (1, 40, 48, 64),            # Kw = 48, N = 1920
    (1, 300, 2, 16),            # Kh + Kw > 256: rel rows read from global memory
])
def test_vit_attention_kernel_matches_plain(dev, bh, kh, kw, hd):
    q, k, v, rh, rw = _vit_inputs(bh, kh, kw, hd, 0, dev)
    scale = hd ** -0.5
    before = kernels.LAUNCHES["vit_attention"]
    got = vit_global_attention(q, k, v, rh, rw, scale)
    assert kernels.LAUNCHES["vit_attention"] == before + 1
    want = vit_attention_plain(q, k, v, rh, rw, scale)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    g, w = got.float(), want.float()
    torch.testing.assert_close(g, w, rtol=0, atol=2 ** -6 * w.abs().max().item())
    assert ((g - w).norm() / w.norm()).item() <= 1e-2


def test_vit_attention_kernel_rejects_f32(dev):
    q, k, v, rh, rw = (t.float() for t in _vit_inputs(1, 4, 4, 16, 1, dev))
    with pytest.raises(ValueError):
        vit_global_attention(q, k, v, rh, rw, 0.25)


@pytest.mark.parametrize("bh,kh,kw,hd", [(2, 4, 4, 16), (3, 9, 7, 80), (2, 12, 12, 64),
                                         (16, 64, 64, 80), (2, 3, 64, 80),
                                         (32, 64, 64, 80)])   # ViT-H training, batch 2
def test_vit_attention_lse_matches_logsumexp(dev, bh, kh, kw, hd):
    q, k, v, rh, rw = _vit_inputs(bh, kh, kw, hd, 2, dev)
    scale = hd ** -0.5
    out, lse = vit_attention_forward(q, k, v, rh, rw, scale)
    want = torch.logsumexp(vit_attention_logits(q, k, rh, rw, scale), -1)
    torch.cuda.synchronize()
    assert lse.dtype == torch.float32 and lse.shape == (bh, kh * kw)
    torch.testing.assert_close(lse, want, rtol=0, atol=1e-4)
    assert torch.equal(out, vit_global_attention(q, k, v, rh, rw, scale))


@pytest.mark.parametrize("bh,kh,kw,hd", [
    (2, 4, 4, 16), (3, 9, 7, 80), (2, 12, 12, 64),
    (32, 64, 64, 80),           # ViT-H training, batch 2: the Kw = 64 path
    (16, 64, 64, 64),           # hd 64
    (2, 3, 64, 80),             # Kw = 64, N = 192
    (2, 20, 20, 80),            # N = 400: a partial last 64-row tile
    (1, 32, 48, 80),            # Kh != Kw
    (1, 5, 9, 16),              # odd widths: rel rows copied element by element
])
def test_vit_attention_backward_matches_plain(dev, bh, kh, kw, hd):
    q, k, v, rh, rw = _vit_inputs(bh, kh, kw, hd, 3, dev)
    dout = _vit_inputs(bh, kh, kw, hd, 4, dev)[0]
    scale = hd ** -0.5
    out, lse = vit_attention_forward(q, k, v, rh, rw, scale)
    before = kernels.LAUNCHES["vit_attention_bwd"]
    got = vit_attention_backward(q, k, v, rh, rw, out, lse, dout, scale)
    assert kernels.LAUNCHES["vit_attention_bwd"] == before + 1
    want = vit_attention_bwd_plain(q, k, v, rh, rw, out, lse, dout, scale)
    torch.cuda.synchronize()
    check_vit_attention_bwd(f"vit_attention_bwd {bh, kh, kw, hd}", got, want)


@pytest.mark.parametrize("bh,kh,kw,hd", [
    (32, 64, 64, 80),           # ViT-H training, batch 2
    (32, 64, 64, 64),           # ViT-L's head dim
    (2, 2, 64, 80),             # N = 128: one block of 128 rows, two key rows
    (3, 6, 64, 64),             # N = 384
])
def test_vit_attention_backward_wgmma_design_matches_plain(dev, bh, kh, kw, hd):
    """The training shapes' class (Kw = 64, hd 64 or 80, N a multiple of 128)
    takes the wgmma design; held to the plain version at the same limits."""
    assert vit_attention_bwd_design(kh * kw, hd, kh, kw) == "wgmma"
    q, k, v, rh, rw = _vit_inputs(bh, kh, kw, hd, 6, dev)
    dout = _vit_inputs(bh, kh, kw, hd, 7, dev)[0]
    scale = hd ** -0.5
    out, lse = vit_attention_forward(q, k, v, rh, rw, scale)
    got = vit_attention_backward(q, k, v, rh, rw, out, lse, dout, scale)
    want = vit_attention_bwd_plain(q, k, v, rh, rw, out, lse, dout, scale)
    torch.cuda.synchronize()
    check_vit_attention_bwd(f"vit_attention_bwd wgmma {bh, kh, kw, hd}", got, want)


@pytest.mark.parametrize("kh,kw,hd", [(40, 40, 80), (20, 20, 80), (32, 48, 80), (3, 64, 80),
                                      (64, 64, 16)])
def test_vit_attention_backward_design_outside_the_class_is_mma_sync(dev, kh, kw, hd):
    assert vit_attention_bwd_design(kh * kw, hd, kh, kw) == "mma.sync"


def test_vit_attention_backward_rejects_what_it_does_not_take(dev):
    q, k, v, rh, rw = _vit_inputs(1, 4, 4, 16, 5, dev)
    out, lse = vit_attention_forward(q, k, v, rh, rw, 0.25)
    with pytest.raises(ValueError):
        vit_attention_backward(q, k, v, rh, rw, out, lse.bfloat16(), q, 0.25)
    with pytest.raises(ValueError):
        vit_attention_backward(q, k, v, rh, rw, out, lse, q.float(), 0.25)
    q, k, v, rh, rw = _vit_inputs(1, 4, 4, 32, 5, dev)
    with pytest.raises(ValueError):
        vit_attention_backward(q, k, v, rh, rw, q, lse, q, 0.25)


def _global_block(dev):
    """A ViT-H-like global block at a small width: 4 heads of 80, 32x32 tokens
    (N = 1024, the least JAX's condition takes the kernel at), f32 weights."""
    from hipie_torch.models.backbone.vit import ViTBlock

    torch.manual_seed(0)
    blk = ViTBlock(320, 4, input_size=(32, 32)).to(dev)
    for p in blk.parameters():
        torch.nn.init.normal_(p, std=0.05)
    x = torch.randn(1, 32, 32, 320, device=dev)
    return blk, x


def test_vit_block_under_grad_launches_ka_and_ke(dev):
    """Under bf16 autocast (the train step's), a global block takes K-A with a
    grad_fn, and its backward launches K-E once; every parameter of the
    attention gets a gradient, close to the plain path's (f32 model, no
    kernel)."""
    blk, x = _global_block(dev)
    kernels.reset_launch_counts()
    with torch.autocast("cuda", dtype=torch.bfloat16):
        y = blk(x.requires_grad_())
    assert y.grad_fn is not None
    assert kernels.LAUNCHES["vit_attention"] == 1 and kernels.LAUNCHES["vit_attention_bwd"] == 0
    y.float().square().mean().backward()
    assert kernels.LAUNCHES["vit_attention"] == 1 and kernels.LAUNCHES["vit_attention_bwd"] == 1
    got = {n: p.grad.clone() for n, p in blk.named_parameters()}
    blk.zero_grad()
    kernels.reset_launch_counts()
    blk(x).square().mean().backward()               # f32: the plain path
    assert sum(kernels.LAUNCHES.values()) == 0
    for name, p in blk.named_parameters():
        if name.startswith("attn."):
            g, w = got[name].float(), p.grad.float()
            assert g.abs().max() > 0, name
            # bf16 compute against f32 through the whole block
            assert ((g - w).norm() / w.norm()).item() <= 5e-2, name


def test_vit_dispatch_under_autocast_reaches_ka(dev):
    """The train step's autocast makes LayerNorm's output f32 but the qkv
    projection's bf16: the dispatch keys on the latter, so the global block
    takes K-A; at N < 1024 it does not, as in JAX."""
    from hipie_torch.models.backbone.vit import ViTBlock

    blk, x = _global_block(dev)
    kernels.reset_launch_counts()
    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
        assert blk.norm1(x).dtype == torch.float32
        blk(x)
    assert kernels.LAUNCHES["vit_attention"] == 1
    small = ViTBlock(320, 4, input_size=(16, 16)).to(dev)
    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
        small(torch.randn(1, 16, 16, 320, device=dev))
    assert kernels.LAUNCHES["vit_attention"] == 1


def _msda_inputs(b, q, m, d, shapes, p, seed, dev, dtype, locations="uniform"):
    r = np.random.RandomState(seed)
    s = sum(h * w for h, w in shapes)
    L = len(shapes)
    value = torch.from_numpy(r.randn(b, s, m, d).astype(np.float32)).to(dev, dtype)
    if locations == "local":              # each query near its own pixel (Q = S)
        loc = np.concatenate([local_locations(np.random.default_rng(seed + i), shapes, m, p)
                              for i in range(b)])
    elif locations == "edges":            # on pixel centres and edges, and outside [0, 1]
        hw = np.array([[w, h] for h, w in shapes], np.float32)[None, None, None, :, None, :]
        k = r.randint(-3, 2 * max(max(sh) for sh in shapes) + 3, (b, q, m, L, p, 2))
        loc = (k / 2.0 / hw).astype(np.float32)
    else:
        loc = r.uniform(-0.2, 1.2, (b, q, m, L, p, 2)).astype(np.float32)
    w = r.uniform(0, 1, (b, q, m, L, p)).astype(np.float32)
    w = torch.from_numpy(w / w.sum(axis=(-1, -2), keepdims=True)).to(dev)
    return value, torch.from_numpy(loc).to(dev), w


def test_ms_deform_attn_constants_match_the_wrapper(dev):
    assert kernel_constants() == (BLOCK_THREADS, TABLE_CHUNK, GATHER_BATCH, MAX_PAIRS)


ENC_SHAPES = ((128, 128), (64, 64), (32, 32), (16, 16))
R50_SHAPES = ((100, 152), (50, 76), (25, 38), (13, 19))
ENC_S, R50_S = 21760, 20197


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,q,m,d,shapes,p,locations", [
    (2, 7, 2, 8, ((6, 4), (3, 2)), 3, "uniform"),       # L*P = 6: the generic instance
    (1, 37, 4, 16, ((10, 12), (5, 6), (3, 3)), 4, "uniform"),
    (1, 45, 2, 32, ((13, 19), (7, 10)), 8, "edges"),     # L*P = 16 on edges and outside
    (1, 33, 3, 32, ((9, 7),) * 4, 8, "uniform"),         # L*P = 32: two table fills
    (1, 300, 8, 32, ENC_SHAPES, 4, "uniform"),
    (1, 910, 8, 32, ENC_SHAPES, 4, "uniform"),
    (1, ENC_S, 8, 32, ENC_SHAPES, 4, "uniform"),
    (1, ENC_S, 8, 32, ENC_SHAPES, 4, "local"),
    (2, 910, 8, 32, ENC_SHAPES, 4, "uniform"),          # batch 2
    (1, R50_S, 8, 32, R50_SHAPES, 4, "uniform"),         # the R50 encoder
    (1, R50_S, 8, 32, R50_SHAPES, 4, "local"),
    (1, 910, 8, 32, R50_SHAPES, 4, "uniform"),           # the R50 decoder
    (1, 300, 8, 32, R50_SHAPES[::-1], 4, "uniform"),     # the R50 MaskDINO decoder
    (2, R50_S, 8, 4, R50_SHAPES, 4, "uniform"),          # D = 4 (MaskDINO's tiny width)
    (1, 50, 2, 3, ((5, 7),), 2, "uniform"),              # bf16: 2-byte vectors
    (1, 50, 2, 5, ((5, 7),), 2, "uniform"),              # f32: 4-byte vectors
    (1, 50, 2, 6, ((5, 7), (2, 3)), 2, "edges"),         # 4- or 8-byte vectors
    (1, 40, 2, 100, ((6, 5),), 4, "uniform"),            # 25 8-byte vectors a row in bf16
    (1, 40, 2, 127, ((6, 5), (3, 3)), 2, "uniform"),     # 127 vectors: 4 passes of 32 threads
    (1, 40, 2, 128, ((6, 5), (3, 3)), 4, "uniform"),     # 32 threads across a row in f32
])
def test_ms_deform_attn_kernel_matches_plain(dev, dtype, b, q, m, d, shapes, p, locations):
    value, loc, w = _msda_inputs(b, q, m, d, shapes, p, q + d, dev, dtype, locations)
    before = kernels.LAUNCHES["ms_deform_attn"]
    got = ms_deform_attn(value, shapes, loc, w)
    assert kernels.LAUNCHES["ms_deform_attn"] == before + 1
    want = ms_deform_attn_plain(value, shapes, loc, w)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (b, q, m * d)
    check_msda("ms_deform_attn", got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("groups", [1, 4])
@pytest.mark.parametrize("b,q,m,d,shapes,p", [
    (1, 910, 8, 32, ENC_SHAPES, 4),
    (2, 61, 8, 32, R50_SHAPES, 4),                      # a ragged last tile
    (1, 29, 4, 24, ((13, 19), (7, 10), (4, 5)), 3),      # L*P = 9; 3 or 6 vectors a row
])
def test_ms_deform_attn_kernel_either_split(dev, dtype, groups, b, q, m, d, shapes, p):
    """Both sample splits (1 group, or 4 groups met by warp shuffles) on one shape."""
    value, loc, w = _msda_inputs(b, q, m, d, shapes, p, 5, dev, dtype)
    plan = kernel_plan(d, value.element_size(), b * q * m, groups=groups)
    got = _launch(value, shapes, loc, w, plan)
    torch.cuda.synchronize()
    check_msda("ms_deform_attn", got, ms_deform_attn_plain(value, shapes, loc, w))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ms_deform_attn_kernel_unaligned_rows(dev, dtype):
    """A value view one element into its storage takes the narrowest vectors."""
    shapes = ((9, 11), (5, 6))
    value, loc, w = _msda_inputs(1, 70, 4, 32, shapes, 4, 3, dev, dtype)
    flat = torch.empty(value.numel() + 1, dtype=dtype, device=dev)
    shifted = flat[1:].view(value.shape)
    shifted.copy_(value)
    assert kernel_plan(32, value.element_size(), 280, shifted.data_ptr() & -shifted.data_ptr()
                       ).vec_bytes == value.element_size()
    got = ms_deform_attn(shifted, shapes, loc, w)
    torch.cuda.synchronize()
    check_msda("ms_deform_attn", got, ms_deform_attn_plain(value, shapes, loc, w))


def test_ms_deform_attn_kernel_rejects_f16(dev):
    value, loc, w = _msda_inputs(1, 5, 2, 8, ((4, 4),), 2, 0, dev, torch.float16)
    with pytest.raises(ValueError):
        ms_deform_attn(value, ((4, 4),), loc, w)


def _gout(b, q, m, d, seed, dev, dtype):
    r = np.random.RandomState(seed)
    return torch.from_numpy(r.randn(b, q, m * d).astype(np.float32)).to(dev, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,q,m,d,shapes,p,locations", [
    (2, 7, 2, 8, ((6, 4), (3, 2)), 3, "uniform"),       # L*P = 6
    (1, 45, 2, 32, ((13, 19), (7, 10)), 8, "edges"),     # L*P = 16 on edges and outside
    (1, 33, 3, 32, ((9, 7),) * 4, 8, "uniform"),         # L*P = 32
    (2, 1110, 8, 32, ENC_SHAPES, 4, "uniform"),          # the training decoder
    (2, 500, 8, 32, ENC_SHAPES[::-1], 4, "uniform"),     # the training MaskDINO decoder
    (2, ENC_S, 8, 32, ENC_SHAPES, 4, "local"),           # the training encoder
    (1, R50_S, 8, 32, R50_SHAPES, 4, "uniform"),
    (2, 300, 8, 4, R50_SHAPES, 4, "uniform"),            # D = 4: one vector a row
    (1, 50, 2, 3, ((5, 7),), 2, "uniform"),              # odd widths: one channel a thread
    (1, 50, 2, 5, ((5, 7),), 2, "edges"),
    (1, 40, 2, 33, ((6, 5), (3, 3)), 3, "uniform"),      # 33 channels: 2 vectors on thread 0
    (1, 40, 2, 127, ((6, 5), (3, 3)), 2, "uniform"),     # 127: 4 passes of 32 threads
    (1, 40, 2, 128, ((6, 5),), 4, "uniform"),            # 32 threads of 4 channels
])
def test_ms_deform_attn_backward_matches_plain_autograd(dev, dtype, b, q, m, d, shapes, p,
                                                        locations):
    value, loc, w = _msda_inputs(b, q, m, d, shapes, p, q + d + 1, dev, dtype, locations)
    gout = _gout(b, q, m, d, q + d, dev, dtype)
    before = kernels.LAUNCHES["ms_deform_attn_bwd"]
    got = ms_deform_attn_backward(value, shapes, loc, w, gout)
    assert kernels.LAUNCHES["ms_deform_attn_bwd"] == before + 1
    want = ms_deform_attn_backward_plain(value, shapes, loc, w, gout)
    torch.cuda.synchronize()
    check_msda_bwd("ms_deform_attn_bwd", got, want, loc, shapes)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ms_deform_attn_backward_unaligned_rows(dev, dtype):
    """A value view one element into its storage takes one channel a thread."""
    shapes = ((9, 11), (5, 6))
    value, loc, w = _msda_inputs(1, 70, 4, 32, shapes, 4, 3, dev, dtype)
    flat = torch.empty(value.numel() + 1, dtype=dtype, device=dev)
    shifted = flat[1:].view(value.shape)
    shifted.copy_(value)
    assert backward_plan(32, value.element_size(), shifted.data_ptr() & -shifted.data_ptr())[0] == 1
    gout = _gout(1, 70, 4, 32, 4, dev, dtype)
    got = ms_deform_attn_backward(shifted, shapes, loc, w, gout)
    torch.cuda.synchronize()
    check_msda_bwd("ms_deform_attn_bwd", got,
                   ms_deform_attn_backward_plain(value, shapes, loc, w, gout), loc, shapes)


def _binned(value, shapes, loc, w, gout):
    """K-D's binned design, asked for: (the three gradients, the launch's stats)."""
    got, design, scratch = _ms_deform_attn_backward_design(value, shapes, loc, w, gout,
                                                           force_binned=True)
    assert design == "binned"
    return got, bwd_binned_stats(scratch)


def _binned_launches(fn):
    """fn()'s launches of K-D's binned design, counted where the wrapper launches."""
    before = msda_ops.BWD_DESIGN_LAUNCHES["binned"]
    out = fn()
    return out, msda_ops.BWD_DESIGN_LAUNCHES["binned"] - before


def test_ms_deform_attn_bwd_constants_match_the_wrapper(dev):
    """The wrapper's copies of K-D's binned-design constants and plan equal
    the built library's (the CPU replay in test_torch_msda_bwd_tiles.py runs on
    the copies)."""
    assert bwd_constants() == BWD_CONSTANTS


@pytest.mark.parametrize("b,q,m,d,shapes,p,aligned,design", [
    (2, ENC_S, 8, 32, ENC_SHAPES, 4, True, "binned"),     # the training encoder, 4096 a bin
    (2, 1110, 8, 32, ENC_SHAPES, 4, True, "atomics"),     # the training decoder, 209 a bin
    (2, 500, 8, 32, ENC_SHAPES[::-1], 4, True, "atomics"),  # MaskDINO's decoder, 94 a bin
    (2, R50_S, 8, 32, R50_SHAPES, 4, True, "binned"),     # the R50 encoder, 3298 a bin
    (1, R50_S, 8, 32, R50_SHAPES, 4, False, "atomics"),   # unaligned rows
    (2, ENC_S, 8, 16, ENC_SHAPES, 4, True, "atomics"),    # D = 16
    (2, ENC_S, 8, 32, ENC_SHAPES + ((8, 8),), 4, True, "atomics"),   # 5 levels
    (1, 4000, 2, 32, ((6, 4), (3, 2)), 3, True, "binned"),  # 4 bins of 12000
    (1, 300, 2, 32, ((6, 4), (3, 2)), 3, True, "atomics"),  # 4 bins of 900
    (2, 90000, 8, 32, ((256, 320),), 4, True, "binned"),  # BWD_MAX_BINS = 5120 bins of 1125
    (2, 90000, 8, 32, ((272, 320),), 4, True, "atomics"),  # 5440 bins: over the most
])
def test_ms_deform_attn_bwd_design_rule(dev, b, q, m, d, shapes, p, aligned, design):
    """The C entry's design by shape, the wrapper's copy of its rule, and the
    scratch the C entry asks for (none for the atomics design)."""
    from hipie_torch.kernels import build

    assert ms_deform_attn_bwd_design(shapes, b, m, d, q, p, aligned) == design
    assert bwd_design_rule(shapes, b, m, d, q, p, aligned) == design
    nbytes = ctypes.c_longlong(-1)
    assert build.load().hipie_ms_deform_attn_bwd_scratch_bytes(
        _host_shapes(shapes).data_ptr(), b, m, d, q, len(shapes), p, int(aligned), 0,
        ctypes.addressof(nbytes)) == 0
    assert (nbytes.value > 0) == (design == "binned")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,q,m,shapes,p,locations", [
    (2, ENC_S, 8, ENC_SHAPES, 4, "uniform"),             # the training encoder
    (2, ENC_S, 8, ENC_SHAPES, 4, "local"),
    (2, 1110, 8, ENC_SHAPES, 4, "uniform"),              # the decoder, taken binned here
    (2, 500, 8, ENC_SHAPES[::-1], 4, "uniform"),         # levels smallest first
    (1, R50_S, 8, R50_SHAPES, 4, "uniform"),             # partial tiles: 100 x 152 ...
    (1, 45, 2, ((13, 19), (7, 10)), 8, "edges"),         # on edges and outside
    (1, 50, 2, ((5, 7),), 2, "uniform"),                 # one level
    (2, 600, 8, ((256, 320),), 4, "uniform"),            # the most bins it takes: 5120
])
def test_ms_deform_attn_backward_binned_matches_plain(dev, dtype, b, q, m, shapes, p, locations):
    """The binned design, asked for, against the plain version's autograd."""
    value, loc, w = _msda_inputs(b, q, m, 32, shapes, p, q + 7, dev, dtype, locations)
    gout = _gout(b, q, m, 32, q + 8, dev, dtype)
    (got, stats), n = _binned_launches(lambda: _binned(value, shapes, loc, w, gout))
    assert n == 1 and stats["n_bins"] <= BWD_MAX_BINS and stats["n_chunks"] >= 1
    want = ms_deform_attn_backward_plain(value, shapes, loc, w, gout)
    torch.cuda.synchronize()
    check_msda_bwd("ms_deform_attn_bwd binned", got, want, loc, shapes)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ms_deform_attn_backward_binned_overfull_bins(dev, dtype):
    """Bins of more than 4096 samples split into several chunks: each head's
    9600 samples of a 16 x 16 level go to its one tile (over 5000 of them
    inside the map), the other level's spread over 6 tiles; against the plain
    version's autograd; the launch's scratch counts more chunks than bins."""
    shapes = ((16, 16), (40, 24))
    b, q, m, p = 1, 1200, 4, 8
    value, loc, w = _msda_inputs(b, q, m, 32, shapes, p, 21, dev, dtype)
    gout = _gout(b, q, m, 32, 22, dev, dtype)
    assert ms_deform_attn_bwd_design(shapes, b, m, 32, q, p) == "binned"
    got, design, scratch = _ms_deform_attn_backward_design(value, shapes, loc, w, gout)
    assert design == "binned"
    stats = bwd_binned_stats(scratch)
    assert q * p > 2 * 4096 and stats["n_bins"] == m * (1 + 3 * 2)
    assert stats["n_chunks"] >= stats["n_bins"] + m       # each head's 16 x 16 tile split
    check_msda_bwd("ms_deform_attn_bwd overfull", got,
                   ms_deform_attn_backward_plain(value, shapes, loc, w, gout), loc, shapes)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ms_deform_attn_backward_unaligned_rows_take_atomics(dev, dtype):
    """At the training encoder's shape a value view one element into its
    storage takes the atomics design, one channel a thread, and the binned
    design refuses it."""
    value, loc, w = _msda_inputs(1, ENC_S, 8, 32, ENC_SHAPES, 4, 5, dev, dtype)
    flat = torch.empty(value.numel() + 1, dtype=dtype, device=dev)
    shifted = flat[1:].view(value.shape)
    shifted.copy_(value)
    gout = _gout(1, ENC_S, 8, 32, 6, dev, dtype)
    got, n = _binned_launches(lambda: ms_deform_attn_backward(shifted, ENC_SHAPES, loc, w, gout))
    assert n == 0
    torch.cuda.synchronize()
    check_msda_bwd("ms_deform_attn_bwd", got,
                   ms_deform_attn_backward_plain(value, ENC_SHAPES, loc, w, gout), loc, ENC_SHAPES)
    with pytest.raises(ValueError):
        _binned(shifted, ENC_SHAPES, loc, w, gout)


def test_ms_deform_attn_backward_binned_refuses_what_it_does_not_take(dev):
    """Asked for, the binned design refuses D = 16 and more than
    BWD_MAX_BINS bins."""
    value, loc, w = _msda_inputs(1, 40, 2, 16, ((6, 5),), 4, 3, dev, torch.float32)
    gout = _gout(1, 40, 2, 16, 4, dev, torch.float32)
    with pytest.raises(ValueError):
        _binned(value, ((6, 5),), loc, w, gout)
    shapes = ((272, 320),)                                # 340 tiles x 2 x 8 = 5440 bins
    value, loc, w = _msda_inputs(2, 10, 8, 32, shapes, 4, 3, dev, torch.bfloat16)
    gout = _gout(2, 10, 8, 32, 4, dev, torch.bfloat16)
    with pytest.raises(ValueError):
        _binned(value, shapes, loc, w, gout)


@pytest.mark.parametrize("method", ["fused", "flat4"])
def test_ms_deform_attn_autograd_launches_kd(dev, method):
    """With a gradient wanted, the forward (K-B, or flat4 on K-C) and K-D run
    once each, and the gradients are K-D's; under no_grad only the forward runs."""
    shapes = R50_SHAPES
    value, loc, w = _msda_inputs(2, 300, 8, 32, shapes, 4, 9, dev, torch.bfloat16)
    gout = _gout(2, 300, 8, 32, 10, dev, torch.bfloat16)
    fwd = "ms_deform_attn" if method == "fused" else "msda_reduce"
    with torch.no_grad():
        before = dict(kernels.LAUNCHES)
        ms_deform_attn(value, shapes, loc, w, method=method)
        assert kernels.LAUNCHES[fwd] == before[fwd] + 1
        assert kernels.LAUNCHES["ms_deform_attn_bwd"] == before["ms_deform_attn_bwd"]
    v, l, a = (t.clone().requires_grad_(True) for t in (value, loc, w))
    before = dict(kernels.LAUNCHES)
    ms_deform_attn(v, shapes, l, a, method=method).backward(gout)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[fwd] == before[fwd] + 1
    assert kernels.LAUNCHES["ms_deform_attn_bwd"] == before["ms_deform_attn_bwd"] + 1
    check_msda_bwd("autograd", (v.grad, l.grad, a.grad),
                   ms_deform_attn_backward_plain(value, shapes, loc, w, gout), loc, shapes)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,k,fd", [
    (96, 16, 32),               # 8 of 32 lanes busy
    (4092, 12, 64),             # K = 12, a last block with few segments
    (112, 16, 36),              # d = 9: corners straddle a lane's 4 columns
    (800, 16, 256),             # 4d > 128: two column groups per lane
    (300 * 8 * 16, 16, 128),    # MaskDINO decoder rows at the R50 path's shape
    (910 * 8 * 16, 16, 128),    # decoder rows
])
def test_msda_reduce_kernel_matches_plain(dev, dtype, n, k, fd):
    r = np.random.RandomState(n + fd)
    g = torch.from_numpy(r.randn(n, fd).astype(np.float32)).to(dev, dtype)
    cw = torch.from_numpy(r.uniform(0, 1, (n, 4)).astype(np.float32)).to(dev, dtype)
    before = kernels.LAUNCHES["msda_reduce"]
    got = msda_weighted_segment_sum(g, cw, k)
    assert kernels.LAUNCHES["msda_reduce"] == before + 1
    want = msda_weighted_segment_sum_plain(g, cw, k)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (n // k, fd) and got.is_cuda
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_msda_reduce_kernel_rejects_what_it_does_not_take(dev):
    g = torch.zeros(64, 32, device=dev)
    cw = torch.zeros(64, 4, device=dev)
    for args in ((g[:60], cw[:60], 16),                      # N % K != 0
                 (g.half(), cw.half(), 16),                   # f16
                 (g, cw.bfloat16(), 16),                      # mixed dtypes
                 (g[:, :30], cw, 16),                         # 4d % 4 != 0
                 (g.t().contiguous().t(), cw, 16),            # not contiguous
                 (g, cw[:, :3], 16)):                         # cw not (N, 4)
        with pytest.raises(ValueError):
            msda_weighted_segment_sum(*args)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("q", [300, 910, None])
def test_flat4_matches_fused(dev, dtype, q):
    """flat4 on the card reaches K-C and never K-B; Q = None is the encoder (Q = S)."""
    shapes = ENC_SHAPES
    s = sum(h * w for h, w in shapes)
    value, loc, w = _msda_inputs(1, q or s, 8, 32, shapes, 4, 7, dev, dtype)
    counts = dict(kernels.LAUNCHES)
    got = ms_deform_attn(value, shapes, loc, w, method="flat4")
    assert kernels.LAUNCHES["msda_reduce"] == counts["msda_reduce"] + 1
    assert kernels.LAUNCHES["ms_deform_attn"] == counts["ms_deform_attn"]
    want = ms_deform_attn(value, shapes, loc, w)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape and got.is_cuda
    if dtype == torch.float32:
        tol = 1e-5
    else:
        tol = 2 ** -9 * (value.float().abs().max().item() + 2 * want.float().abs().max().item())
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)


# Open-vocab serving and the new backbones on the card (tiny config, f32).
def _tiny_open_vocab(backbone="resnet_tiny", text_len=16):
    from hipie_torch.config import apply_overrides, tiny_test_config

    return apply_overrides(tiny_test_config(), {
        "data.min_size_test": 48, "data.max_size_test": 96, "data.max_text_len": text_len,
        "model.clip.enabled": True, "test.max_pool_tokens": True, "test.bg_cls_agnostic": True,
        "test.use_bg_for_pano": False, "model.backbone.name": backbone})


def _launches_per_call(pred, cats):
    img = np.random.RandomState(0).randint(0, 256, (50, 80, 3)).astype(np.uint8)
    kernels.reset_launch_counts()
    res = pred(img, test_categories=cats, score_thresh=-1.0)
    torch.cuda.synchronize()
    assert np.isfinite(res["instances"]["scores"]).all() and res["sem_seg"].shape == (50, 80)
    return dict(kernels.LAUNCHES)


@pytest.mark.parametrize("backbone", ["resnet_tiny", "swin_narrow", "convnext_narrow"])
def test_open_vocab_predictor_launches_kb(dev, backbone, monkeypatch):
    """The tiny open-vocab predictor on the card (a 640-token prompt encoded in
    chunks, narrow CLIP towers), on a ResNet and on narrow Swin and ConvNeXt
    backbones: K-B once per MSDeformAttn layer a call, K-F once (the image's
    NMS), no other kernel."""
    import hipie_torch.models.backbone.convnext as convnext
    import hipie_torch.models.backbone.swin as swin
    from hipie_torch.models.clip import CLIPText, CLIPVisual
    from hipie_torch.models.hipie import HIPIEModel
    from hipie_torch.models.postprocess_clip import CLIPScorer
    from hipie_torch.models.text.clip_tokenizer import CLIPTokenizer
    from hipie_torch.models.text.tokenizer import WordPieceTokenizer
    from hipie_torch.predictor import HIPIEPredictor
    from hipie_torch.utils.weights import random_init_

    monkeypatch.setitem(swin.SWIN_VARIANTS, "swin_narrow", (16, (2, 2, 2, 2), (2, 2, 4, 4), 4))
    monkeypatch.setitem(convnext.CONVNEXT_VARIANTS, "narrow", ((1, 1, 2, 1), (8, 16, 32, 64)))
    cfg = _tiny_open_vocab(backbone, text_len=640)
    tok = WordPieceTokenizer.toy(words=["person", "dog"])
    model = HIPIEModel(cfg.model, sep_token_id=tok.dot_token_id).eval()
    random_init_(model, torch.Generator().manual_seed(0))
    scorer = CLIPScorer(cfg.model.clip, CLIPTokenizer.toy(), visual=CLIPVisual(32, 8, 32, 2, 2, 16),
                        text=CLIPText(600, 77, 32, 2, 2, 16), device=dev)
    pred = HIPIEPredictor(cfg, model, tok, bucket=(64, 96), device=dev, clip_scorer=scorer)
    cats = [f"{w}{i}" + (":stuff" if i % 3 == 0 else "") for i in range(100)
            for w in ("person", "dog")]
    n_msda = sum(1 for m in model.modules() if type(m).__name__ == "MSDeformAttn")
    assert _launches_per_call(pred, cats) == predictor_launches(n_msda)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_mask", [900, 1200])
def test_clip_masked_attention_matches_the_cpu(dev, dtype, n_mask):
    """CLIP's masked attention (SDPA with the MaskCLIP mask: mask tokens see
    the CLS token and their in-mask patches, nobody sees a mask token; one mask
    blocks every patch) at the open-vocab phase's token counts, n_mask + 1 +
    576, width 1024, 16 heads: on the card against its f32 run on the CPU.
    f32: summation order only (relative norm 1e-5). bf16: inputs, weights and
    the output rounded to bf16 (2^-9 relative each): 1e-2."""
    from hipie_torch.models.clip import CLIPAttention

    attn = CLIPAttention(1024, 16).eval()
    g = torch.Generator().manual_seed(n_mask)
    with torch.no_grad():
        for p in attn.parameters():
            p.normal_(0.0, 1024 ** -0.5 if p.ndim == 2 else 0.02, generator=g)
    t = n_mask + 1 + 576
    x = torch.randn(1, t, 1024, generator=g)
    mask = torch.zeros(1, t, t, dtype=torch.bool)
    mask[:, :, :n_mask] = True
    mask[:, :n_mask, n_mask + 1:] = torch.rand(1, n_mask, 576, generator=g) < 0.6
    mask[:, 0, n_mask + 1:] = True
    with torch.no_grad():
        want = attn(x, mask)
        got = attn.to(dev, dtype)(x.to(dev, dtype), mask.to(dev)).float().cpu()
    assert torch.isfinite(got).all()
    rel = ((got - want).norm() / want.norm()).item()
    assert rel <= (1e-5 if dtype == torch.float32 else 1e-2), rel


# K-F: greedy NMS on the card against the plain version on the CPU.
def _nms_equal(dev, boxes, scores, cls, thr=0.7):
    from hipie_torch.ops.nms import nms_keep_mask

    b, s = torch.from_numpy(boxes), torch.from_numpy(scores)
    c = None if cls is None else torch.from_numpy(cls)
    want = nms_keep_mask(b, s, c, thr)
    before = kernels.LAUNCHES["nms"]
    got = nms_keep_mask(b.to(dev), s.to(dev), None if c is None else c.to(dev), thr)
    assert kernels.LAUNCHES["nms"] == before + 1
    assert got.device.type == "cuda" and got.dtype == torch.bool and got.shape == want.shape
    assert torch.equal(got.cpu(), want), int((got.cpu() != want).sum())
    return want


@pytest.mark.parametrize("with_classes", [True, False])
@pytest.mark.parametrize("n", [1, 63, 64, 65, 900, 2100])
def test_nms_kernel_matches_plain(dev, n, with_classes):
    """Boxes around n // 20 objects (one word, a partial word, the serving N,
    33 words), ties among the scores."""
    want = _nms_equal(dev, *nms_case("serve", n, n, with_classes))
    assert n < 63 or 0 < want.sum() < n


@pytest.mark.parametrize("with_classes", [True, False])
@pytest.mark.parametrize("case", [c for c in NMS_CASES if c != "serve"])
def test_nms_kernel_edge_cases(dev, case, with_classes):
    """Tied scores, duplicate boxes, zero-area boxes, all boxes overlapping,
    none overlapping, and pairs whose IoU lies within 1e-6 of the threshold on
    both sides of it, at the serving N."""
    want = _nms_equal(dev, *nms_case(case, 900, 7, with_classes))
    if case == "none_overlap":
        assert want.all()
    if case == "all_overlap" and not with_classes:
        assert want.sum() == 1


def test_nms_kernel_at_other_thresholds(dev):
    _nms_equal(dev, *nms_case("serve", 900, 3, True), thr=0.5)
    _nms_equal(dev, *nms_case("near_threshold", 900, 3, False), thr=0.1)


def test_nms_kernel_does_not_sync(dev):
    """No copy to the host and no blocking copy back: the call runs under the
    sync debug mode set to raise."""
    from hipie_torch.ops.nms import nms_keep_mask

    boxes, scores, cls = (torch.from_numpy(x).to(dev) for x in nms_case("serve", 900, 1, True))
    nms_keep_mask(boxes, scores, cls, 0.7)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        keep = nms_keep_mask(boxes, scores, cls, 0.7)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert keep.any()


def test_nms_kernel_empty_launches_nothing(dev):
    from hipie_torch.ops.nms import nms_keep_mask

    before = kernels.LAUNCHES["nms"]
    keep = nms_keep_mask(torch.zeros(0, 4, device=dev), torch.zeros(0, device=dev),
                         torch.zeros(0, dtype=torch.long, device=dev), 0.7)
    assert kernels.LAUNCHES["nms"] == before
    assert keep.shape == (0,) and keep.dtype == torch.bool and keep.device.type == "cuda"


@pytest.mark.parametrize("bad", ["boxes_f64", "boxes_bf16", "boxes_shape", "scores_shape",
                                 "scores_int", "class_ids_f32", "class_ids_int32",
                                 "class_ids_shape", "scores_on_cpu", "class_ids_on_cpu"])
def test_nms_kernel_rejects(dev, bad):
    from hipie_torch.ops.nms import nms_keep_mask

    boxes, scores, cls = (torch.from_numpy(x).to(dev) for x in nms_case("serve", 100, 2, True))
    args = {"boxes_f64": (boxes.double(), scores, cls),
            "boxes_bf16": (boxes.bfloat16(), scores, cls),
            "boxes_shape": (torch.cat([boxes, boxes[:, :1]], 1), scores, cls),
            "scores_shape": (boxes, scores[:-1], cls),
            "scores_int": (boxes, scores.long(), cls),
            "class_ids_f32": (boxes, scores, cls.float()),
            "class_ids_int32": (boxes, scores, cls.int()),
            "class_ids_shape": (boxes, scores, cls[:-1]),
            "scores_on_cpu": (boxes, scores.cpu(), cls),
            "class_ids_on_cpu": (boxes, scores, cls.cpu())}[bad]
    before = kernels.LAUNCHES["nms"]
    with pytest.raises(ValueError):
        nms_keep_mask(*args, 0.7)
    assert kernels.LAUNCHES["nms"] == before
