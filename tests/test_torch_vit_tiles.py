"""CPU emulation of kernel K-A's tile algorithm (hipie_torch/csrc/vit_attention.cu).

The CUDA kernel cannot run here, so this module replays what it does, thread
by thread, in numpy: blocks of 128 queries split over two warpgroups of 64
rows, key tiles of 128 with keys past N read as zeros (the TMA fill) and
masked to -inf, the online softmax over the wgmma accumulator fragment (each
thread holds 2 rows x 32 columns; row max and row sum over the quad of threads
that share a row) with exp2 of (logit - max) * log2(e), the Kw = 64 path (the
16 rel_w columns a thread reads per tile, rel_h joining the max and the
exponent per half tile) and the per-element bias otherwise, P rounded to the
working dtype before P.V, and the division by l at the end. It also checks
the layout facts the kernel relies on: S's accumulator registers are P.V's
A-operand registers unmoved, and the wgmma descriptors it builds (128-byte
swizzle for the first 64 columns, 32-byte for the rest; K-major for Q and K,
MN-major for V) address the elements the TMA boxes put in shared memory.

The emulation is held against ``vit_attention_plain`` and the JAX package's
``_attention_xla``: in f32 to 1e-5 (summation order and exp2 vs exp), in bf16
to 2e-2 (P unnormalised when rounded to bf16 in the kernel, normalised in the
references; one bf16 rounding of the output), the card's tolerance.
"""

import torch_threads  # noqa: F401  (first: sizes torch's CPU threads)
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from hipie_tpu.ops.pallas import vit_attention_kernel as K
from hipie_torch.ops.vit_attention import vit_attention_plain

TILE_Q = TILE_K = 128
FAST_KW = 64
LOG2E = np.float32(1.4426950408889634)
WIDE_BYTES = TILE_K * 64 * 2            # 64 columns, 128 B a row
SLAB_BYTES = TILE_K * 16 * 2            # 16 columns, 32 B a row


def acc_coords(ncols):
    """wgmma m64nN f32 accumulator: (thread 0..127, register) -> (row, column)."""
    t = np.arange(128)[:, None]
    r = np.arange(ncols // 2)[None, :]
    w, lane = t // 32, t % 32
    j, i, c = r // 4, (r // 2) % 2, r % 2
    return 16 * w + lane // 4 + 8 * i, 8 * j + 2 * (lane % 4) + c


def a_coords(step):
    """wgmma m64nNk16 A operand from registers, k16 step ``step``: (thread, 8
    bf16 halves of a0..a3) -> (row, key)."""
    t = np.arange(128)[:, None]
    h = np.arange(8)[None, :]
    w, lane = t // 32, t % 32
    reg, half = h // 2, h % 2
    row = 16 * w + lane // 4 + 8 * (reg % 2)
    key = 16 * step + 8 * (reg // 2) + 2 * (lane % 4) + half
    return row, key


def bf16(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).bfloat16().float().numpy()


def emulate(q, k, v, rel_h, rel_w, scale, round_p):
    """K-A on float32 numpy inputs; ``round_p`` rounds P (and the output) to bf16."""
    bh, n, hd = q.shape
    kh, kw = rel_h.shape[2], rel_w.shape[2]
    fast = kw == FAST_KW                            # the kernel's shapes here all fit
    rows_f, cols_f = acc_coords(TILE_K)             # S fragment (128 threads x 64)
    orow_f, ocol_f = acc_coords(hd)                 # O fragment (128 threads x hd / 2)
    i_of = np.arange(TILE_K // 2) // 2 % 2          # which of the thread's 2 rows
    oi_of = np.arange(hd // 2) // 2 % 2
    j_of, c_of = np.arange(TILE_K // 2) // 4, np.arange(TILE_K // 2) % 2
    lane4 = (np.arange(128) % 32 % 4)[:, None]
    n_tiles = -(-n // TILE_K)
    pad = n_tiles * TILE_K + TILE_Q
    zq = lambda x: np.concatenate([x, np.zeros((pad - n, hd), np.float32)])
    out = np.zeros_like(q)
    for b in range(bh):
        qb, kb, vb = zq(q[b]), zq(k[b]), zq(v[b])         # keys past N read as zeros
        for q0 in range(0, n, TILE_Q):
            q_valid = min(TILE_Q, n - q0)
            for wg in range(2):
                row_a = wg * 64 + np.arange(128) // 32 * 16 + np.arange(128) % 32 // 4
                rows2 = np.stack([row_a, row_a + 8], 1)                   # (128, 2)
                rq = q0 + np.minimum(rows2, q_valid - 1)                  # bias rows
                if fast:   # the 16 rel_w columns (mod 64) a thread reads per tile
                    cols16 = 8 * (np.arange(16) // 2) + 2 * lane4 + np.arange(16) % 2
                    rw = rel_w[b][rq[:, :, None], cols16[:, None, :]]         # (128, 2, 16)
                m = np.full((128, 2), -np.inf, np.float32)
                l = np.zeros((128, 2), np.float32)
                o = np.zeros((128, hd // 2), np.float32)
                q_tile = qb[q0 + wg * 64: q0 + wg * 64 + 64]
                for t in range(n_tiles):
                    k0 = t * TILE_K
                    s_tile = q_tile @ kb[k0:k0 + TILE_K].T                    # (64, 128) f32
                    acc = s_tile[rows_f, cols_f]                              # per-thread regs
                    keys = k0 + cols_f
                    r2 = rq[:, i_of]                                          # (128, 64)
                    hv = np.zeros((128, 2, 2), np.float32)                   # (thread, row, half)
                    if fast:
                        hv = rel_h[b][rq[:, :, None], np.minimum(k0 // FAST_KW + np.arange(2),
                                                                 kh - 1)]
                        w = rw[:, i_of, 2 * (j_of % 8) + c_of]
                    else:
                        kc = np.minimum(keys, n - 1)
                        w = rel_h[b][r2, kc // kw] + rel_w[b][r2, kc % kw]
                    x = (acc * np.float32(scale) + w).astype(np.float32)     # natural units
                    x[keys >= n] = -np.inf
                    hvr = hv[:, i_of, j_of // 8]                             # rel_h per register
                    tmax = np.stack([(x + hvr)[:, i_of == i].max(1) for i in range(2)], 1)
                    tmax = np.repeat(tmax.reshape(32, 4, 2).max(1), 4, 0)     # quad max
                    m_new = np.maximum(m, tmax)
                    alpha = np.exp2((m - m_new) * LOG2E)
                    m = m_new
                    off = (hvr - m[:, i_of]) * LOG2E
                    p = np.exp2(x * LOG2E + off).astype(np.float32)
                    psum = np.stack([p[:, i_of == i].sum(1) for i in range(2)], 1)
                    l = l * alpha + psum
                    o = o * alpha[:, oi_of]
                    if round_p:
                        p = bf16(p)
                    p_tile = np.zeros((64, TILE_K), np.float32)
                    p_tile[rows_f, cols_f] = p                                # A operand
                    o = o + (p_tile @ vb[k0:k0 + TILE_K])[orow_f, ocol_f]
                l = np.repeat(l.reshape(32, 4, 2).sum(1), 4, 0)               # quad sum
                res = o / l[:, oi_of]
                for tr in range(128):
                    rr = wg * 64 + orow_f[tr]
                    ok = rr < q_valid
                    out[b, q0 + rr[ok], ocol_f[tr][ok]] = res[tr][ok]
    return bf16(out) if round_p else out


def inputs(bh, kh, kw, hd, seed, dtype):
    r = np.random.RandomState(seed)
    n = kh * kw
    mk = lambda *s, sc=1.0: (sc * r.randn(*s)).astype(np.float32)
    arrs = [mk(bh, n, hd), mk(bh, n, hd), mk(bh, n, hd), mk(bh, n, kh, sc=0.3),
            mk(bh, n, kw, sc=0.3)]
    return [bf16(a) for a in arrs] if dtype == "bfloat16" else arrs


SHAPES = [(2, 4, 4, 16), (3, 9, 7, 80), (2, 12, 12, 64), (1, 16, 16, 80),
          (1, 3, 64, 80),       # Kw = 64: rel_w in registers; N = 192, a partial key tile
          (1, 2, 64, 16),       # Kw = 64, N = 128: one full tile
          (1, 300, 2, 16)]      # Kh + Kw > 256: rel rows from global memory


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bh,kh,kw,hd", SHAPES)
def test_emulation_matches_plain_and_jax(bh, kh, kw, hd, dtype):
    q, k, v, rh, rw = inputs(bh, kh, kw, hd, kh * 7 + kw, dtype)
    scale = hd ** -0.5
    got = emulate(q, k, v, rh, rw, scale, round_p=dtype == "bfloat16")
    tdt = getattr(torch, dtype)
    plain = vit_attention_plain(*(torch.from_numpy(a).to(tdt) for a in (q, k, v, rh, rw)),
                                scale).float().numpy()
    jdt = getattr(jnp, dtype)
    xla = np.asarray(K._attention_xla(*(jnp.asarray(a, jdt) for a in (q, k, v, rh, rw)),
                                      scale), np.float32)
    tol = 1e-5 if dtype == "float32" else 2e-2
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, plain, rtol=0, atol=tol)
    np.testing.assert_allclose(got, xla, rtol=0, atol=tol)


def test_accumulator_registers_are_the_a_operand():
    """P.V's k16 step s takes S's registers 8 s .. 8 s + 7 as they are."""
    rows, cols = acc_coords(TILE_K)
    for s in range(TILE_K // 16):
        ar, ak = a_coords(s)
        np.testing.assert_array_equal(rows[:, 8 * s: 8 * s + 8], ar)
        np.testing.assert_array_equal(cols[:, 8 * s: 8 * s + 8], ak)


def test_fragment_covers_the_tile_once():
    for ncols in (TILE_K, 80, 64, 16):
        rows, cols = acc_coords(ncols)
        cells = rows * ncols + cols
        assert sorted(cells.ravel().tolist()) == list(range(64 * ncols))


def test_fast_path_rel_w_is_the_column_mod_kw():
    """With Kw = 64 a thread's 32 columns of a 128-key tile hit 16 fixed k % 64:
    the rel_w value read for (j % 8, c) serves accumulator register 4 j + 2 i +
    c, and rel_h's column is the tile's first or second 64-key half."""
    _, cols = acc_coords(TILE_K)
    lane4 = (np.arange(128) % 32 % 4)[:, None]
    reg = np.arange(TILE_K // 2)
    j, c = reg // 4, reg % 2
    held = 8 * (j % 8) + 2 * lane4 + c                # rel_w column read for (j % 8, c)
    for k0 in range(0, 4 * TILE_K, TILE_K):
        np.testing.assert_array_equal((k0 + cols) % FAST_KW, held)
        np.testing.assert_array_equal((k0 + cols) // FAST_KW,
                                      np.broadcast_to(k0 // FAST_KW + j // 8, cols.shape))


def swizzle(byte, span):
    """TMA's CU_TENSOR_MAP_SWIZZLE_{32B,128B} and wgmma's B32 / B128 layouts: the
    16-byte chunk index within a span-byte row is XORed with the row's index in
    its group of span / 16 rows (address bits 4.. with bits 7..)."""
    bits = {32: 1, 128: 3}[span]
    return byte ^ (((byte >> 7) & ((1 << bits) - 1)) << 4)


def test_descriptors_address_the_tma_layout():
    """The kernel's descriptors, read through wgmma's canonical layouts, reach
    the element TMA wrote. A tile holds columns 0..63 as a 64-column box (128 B
    a row, 128-byte swizzle) and columns 64..79 as a 16-column slab (32 B a row,
    32-byte swizzle) after it. K-major (Q, K): 8-row groups SBO = 1024 B (wide)
    or 256 B (slab) apart; a k16 step in the wide box starts 32 B further.
    MN-major (V): 8-key groups SBO = 1024 B (wide) or 256 B (slab) apart."""

    def tma(row, col):
        wide = swizzle(row * 128 + 2 * col, 128)
        slab = swizzle(WIDE_BYTES + (col - 64) // 16 * SLAB_BYTES + row * 32 + 2 * (col % 16), 32)
        return np.where(col < 64, wide, slab)

    # K-major: ((8, m), (8, 2)) : ((row bytes / 2, SBO), (1, 8)) in elements
    def k_major(start, mn, kk, row_bytes, sbo, span):
        return swizzle(start + (mn % 8) * row_bytes + (mn // 8) * sbo + 2 * kk, span)

    mn, kk = np.meshgrid(np.arange(64), np.arange(16), indexing="ij")
    for wg in range(2):                    # Q: this warpgroup's 64 rows
        for step in range(4):
            np.testing.assert_array_equal(
                k_major(wg * 64 * 128 + step * 32, mn, kk, 128, 1024, 128),
                tma(wg * 64 + mn, 16 * step + kk))
        np.testing.assert_array_equal(k_major(WIDE_BYTES + wg * 64 * 32, mn, kk, 32, 256, 32),
                                      tma(wg * 64 + mn, 64 + kk))
    mn, kk = np.meshgrid(np.arange(TILE_K), np.arange(16), indexing="ij")
    for step in range(4):                  # K: 128 keys
        np.testing.assert_array_equal(k_major(step * 32, mn, kk, 128, 1024, 128),
                                      tma(mn, 16 * step + kk))
    np.testing.assert_array_equal(k_major(WIDE_BYTES, mn, kk, 32, 256, 32), tma(mn, 64 + kk))

    # MN-major: ((8, row bytes / 16, m), (8, k)) : ((1, 8, LBO), (row bytes / 2, SBO))
    def mn_major(start, nn, key, row_bytes, sbo, span):
        return swizzle(start + 2 * nn + (key % 8) * row_bytes + (key // 8) * sbo, span)

    nn, key = np.meshgrid(np.arange(64), np.arange(16), indexing="ij")
    ns, keys = np.meshgrid(np.arange(16), np.arange(16), indexing="ij")
    for s in range(TILE_K // 16):          # V: keys 16 s .. 16 s + 15
        np.testing.assert_array_equal(mn_major(s * 16 * 128, nn, key, 128, 1024, 128),
                                      tma(16 * s + key, nn))
        np.testing.assert_array_equal(mn_major(WIDE_BYTES + s * 16 * 32, ns, keys, 32, 256, 32),
                                      tma(16 * s + keys, 64 + ns))
