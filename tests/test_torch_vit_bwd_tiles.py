"""CPU emulation of kernel K-E's tile algorithms (hipie_torch/csrc/vit_attention_bwd.cu).

The CUDA kernels cannot run here, so this module replays both of K-E's designs
in numpy as the kernels tile the work. The wgmma design (the training shapes:
Kw = 64, hd 64 or 80, N a multiple of 128) is replayed by ``emulate_wgmma``
below its own section header. The mma.sync design (every other shape): blocks
of 64 rows (4 warps of 16), the other side streamed in tiles of 64 rows (rows
past N read as zeros) and consumed 16 at a time; P recomputed as exp2 of the logits in log2(e) units less lse; keys
(query-major pass) or queries (key-major pass) past N masked; the Kw = 64 path,
where a key tile is one key row (d rel_h its row sum, d rel_w accumulated
across tiles) and the per-element path (adds into d rel_h and d rel_w rows);
bf16 rounding where the kernel rounds (P for dv, dS for dq and dk, each
gradient once). It also checks the layout facts the kernel relies on: the
ldmatrix addresses it forms give mma.m16n8k16's A and B fragments, two
neighbouring accumulator tiles are one A fragment, and the shared rows of HD +
8 bf16 keep every 8-row ldmatrix phase free of bank conflicts.

Each emulation is held against ``vit_attention_bwd_plain`` and the JAX
package's VJP (``_bwd_rule``) in f32 to 1e-5 (summation order, exp2 vs exp),
and with bf16 rounding against the plain version on the same bf16 inputs to
the card's limits (chip_smoke.check_vit_attention_bwd: dq, dk 1e-2; dv, d
rel_h, d rel_w 2e-3).
"""

import torch_threads  # noqa: F401  (first: sizes torch's CPU threads)
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from hipie_tpu.ops.pallas import vit_attention_kernel as K
from hipie_torch.ops.vit_attention import vit_attention_bwd_plain, vit_attention_forward

ROWS = 64              # rows a block owns, rows of a streamed tile
CHUNK = 16             # rows of the other side per mma step
FAST_KW = 64
LOG2E = np.float32(1.4426950408889634)


def bf16(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).bfloat16().float().numpy()


def _pad(x, rows):
    out = np.zeros((x.shape[0], rows) + x.shape[2:], np.float32)
    out[:, :x.shape[1]] = x
    return out


def emulate(q, k, v, rel_h, rel_w, out, lse, dout, scale, rnd):
    """K-E on float32 numpy inputs; ``rnd`` rounds where the kernel rounds to
    bf16 (identity for the f32 emulation). Returns (dq, dk, dv, drel_h, drel_w)."""
    bh, n, hd = q.shape
    kh, kw = rel_h.shape[2], rel_w.shape[2]
    fast = kw == FAST_KW
    n_tiles = -(-n // ROWS)
    pad = n_tiles * ROWS
    qp, kp, vp, op, gp = (_pad(t, pad) for t in (q, k, v, out, dout))
    rhp, rwp = _pad(rel_h, pad), _pad(rel_w, pad)
    lsep = _pad(lse[..., None], pad)[..., 0]
    f32 = np.float32
    dq, dk, dv = (np.zeros((bh, n, hd), f32) for _ in range(3))
    drel_h, drel_w = np.zeros((bh, n, kh), f32), np.zeros((bh, n, kw), f32)
    dvec = np.zeros((bh, pad), f32)

    # ---- query-major pass: dq, d rel_h, d rel_w and D ----
    for b in range(bh):
        for q0 in range(0, n, ROWS):
            blk = slice(q0, q0 + ROWS)
            d_blk = (gp[b, blk] * op[b, blk]).sum(-1)
            dvec[b, blk] = d_blk
            nl2 = -lsep[b, blk] * LOG2E
            acc_dq = np.zeros((ROWS, hd), f32)
            dh_s, dw_s = np.zeros((ROWS, kh), f32), np.zeros((ROWS, kw), f32)
            for kt in range(n_tiles):
                dh_part = np.zeros(ROWS, f32)
                for c in range(ROWS // CHUNK):
                    keys = kt * ROWS + c * CHUNK + np.arange(CHUNK)
                    kc = np.minimum(keys, n - 1)
                    s = qp[b, blk] @ kp[b, keys].T
                    dp = gp[b, blk] @ vp[b, keys].T
                    if fast:                    # the tile is key row kt
                        bias = rhp[b, blk][:, kt:kt + 1] + rwp[b, blk][:, keys % ROWS]
                    else:
                        bias = rhp[b, blk][:, kc // kw] + rwp[b, blk][:, kc % kw]
                    x = s * f32(scale) + bias
                    p = np.exp2(x * LOG2E + nl2[:, None]) * (keys < n)[None, :]
                    ds = p * (dp - d_blk[:, None])
                    if fast:
                        dh_part += ds.sum(1)
                        dw_s[:, keys % ROWS] += ds
                    else:
                        rows = np.broadcast_to(np.arange(ROWS)[:, None], ds.shape)
                        np.add.at(dh_s, (rows, np.broadcast_to(kc // kw, ds.shape)), ds)
                        np.add.at(dw_s, (rows, np.broadcast_to(kc % kw, ds.shape)), ds)
                    acc_dq += rnd(ds) @ kp[b, keys]
                if fast:
                    dh_s[:, kt] = dh_part
            valid = min(ROWS, n - q0)
            dq[b, q0:q0 + valid] = rnd(acc_dq[:valid] * f32(scale))
            drel_h[b, q0:q0 + valid] = rnd(dh_s[:valid])
            drel_w[b, q0:q0 + valid] = rnd(dw_s[:valid])

    # ---- key-major pass: dk and dv ----
    for b in range(bh):
        for k0 in range(0, n, ROWS):
            blk = slice(k0, k0 + ROWS)
            key = np.minimum(k0 + np.arange(ROWS), n - 1)
            ih, iw = key // kw, key % kw
            acc_dk, acc_dv = np.zeros((ROWS, hd), f32), np.zeros((ROWS, hd), f32)
            for qt in range(n_tiles):
                for c in range(ROWS // CHUNK):
                    qs = qt * ROWS + c * CHUNK + np.arange(CHUNK)
                    st = kp[b, blk] @ qp[b, qs].T                      # (keys, queries)
                    dpt = vp[b, blk] @ gp[b, qs].T
                    bias = rhp[b, qs][:, ih].T + rwp[b, qs][:, iw].T
                    x = st * f32(scale) + bias
                    p = np.exp2(x * LOG2E - lsep[b, qs][None, :] * LOG2E) * (qs < n)[None, :]
                    ds = p * (dpt - dvec[b, qs][None, :])
                    acc_dv += rnd(p) @ gp[b, qs]
                    acc_dk += rnd(ds) @ qp[b, qs]
            valid = min(ROWS, n - k0)
            dk[b, k0:k0 + valid] = rnd(acc_dk[:valid] * f32(scale))
            dv[b, k0:k0 + valid] = rnd(acc_dv[:valid])
    return dq, dk, dv, drel_h, drel_w


def _inputs(bh, kh, kw, hd, seed, rnd):
    r = np.random.RandomState(seed)
    n = kh * kw
    mk = lambda *s, sc=1.0: rnd((sc * r.randn(*s)).astype(np.float32))
    return mk(bh, n, hd), mk(bh, n, hd), mk(bh, n, hd), mk(bh, n, kh, sc=0.3), \
        mk(bh, n, kw, sc=0.3), mk(bh, n, hd)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


NAMES = ("dq", "dk", "dv", "drel_h", "drel_w")
CASES = [
    (2, 8, 8, 16),      # per-element bias, N = 64: one full tile
    (1, 3, 64, 80),     # Kw = 64: key tiles are key rows, d rel_w in registers
    (2, 20, 20, 80),    # N = 400: a partial last tile on both sides
    (1, 9, 7, 16),      # odd widths, N = 63
    (1, 4, 64, 64),     # Kw = 64, hd 64
]


@pytest.mark.parametrize("bh,kh,kw,hd", CASES)
def test_emulation_matches_plain_and_jax_f32(bh, kh, kw, hd):
    q, k, v, rh, rw, g = _inputs(bh, kh, kw, hd, seed=kh + kw, rnd=lambda x: x)
    scale = hd ** -0.5
    t = list(map(torch.from_numpy, (q, k, v, rh, rw, g)))
    out, lse = vit_attention_forward(*t[:5], scale)
    got = emulate(q, k, v, rh, rw, out.numpy(), lse.numpy(), g, scale, lambda x: x)
    plain = vit_attention_bwd_plain(*t[:5], out, lse, t[5], scale)
    jax_vjp = K._bwd_rule(scale, tuple(map(jnp.asarray, (q, k, v, rh, rw))), jnp.asarray(g))
    for name, a, b, c in zip(NAMES, got, plain, jax_vjp):
        assert a.shape == tuple(b.shape), name
        assert _rel(a, b.numpy()) <= 1e-5, (name, _rel(a, b.numpy()))
        assert _rel(a, c) <= 1e-5, (name, _rel(a, c))


@pytest.mark.parametrize("bh,kh,kw,hd", CASES[1:3])
def test_emulation_with_bf16_rounding_matches_plain(bh, kh, kw, hd):
    """bf16 inputs, the kernel's roundings: within the card's limits of the
    plain version, which keeps dS in f32."""
    q, k, v, rh, rw, g = _inputs(bh, kh, kw, hd, seed=3, rnd=bf16)
    scale = hd ** -0.5
    t = [torch.from_numpy(x).bfloat16() for x in (q, k, v, rh, rw, g)]
    out, lse = vit_attention_forward(*t[:5], scale)
    got = emulate(q, k, v, rh, rw, out.float().numpy(), lse.numpy(), g, scale, bf16)
    want = vit_attention_bwd_plain(*t[:5], out, lse, t[5], scale)
    for name, a, b in zip(NAMES, got, want):
        assert b.dtype == torch.bfloat16
        tol = 1e-2 if name in ("dq", "dk") else 2e-3
        assert _rel(a, b.float().numpy()) <= tol, (name, _rel(a, b.float().numpy()))


# ---- layout: ldmatrix and mma.m16n8k16 fragments (lane l, g = l / 4, t = l % 4) ----

def ldmatrix(starts, trans):
    """ldmatrix.x4 over a tile: lane l gives the start (row, col) of row l % 8
    of matrix l / 8; returns regs[lane][m] = the two elements thread ``lane``
    receives from matrix m, as (row, col) pairs of the tile."""
    regs = [[None] * 4 for _ in range(32)]
    for m in range(4):
        rows = [starts[8 * m + i] for i in range(8)]
        for lane in range(32):
            g, t = lane // 4, lane % 4
            if trans:      # element (2t + j, g) of the matrix, j = 0, 1
                regs[lane][m] = [(rows[2 * t + j][0], rows[2 * t + j][1] + g) for j in range(2)]
            else:          # element (g, 2t + j)
                regs[lane][m] = [(rows[g][0], rows[g][1] + 2 * t + j) for j in range(2)]
    return regs


def addr_a(r0, c0, lane):
    return r0 + lane % 16, c0 + 8 * (lane // 16)


def addr_b(r0, c0, lane):
    return r0 + 8 * (lane // 16) + lane % 8, c0 + 8 * (lane // 8 % 2)


def addr_bt(r0, c0, lane):
    return r0 + 8 * (lane // 8 % 2) + lane % 8, c0 + 8 * (lane // 16)


def a_frag(lane, r):
    """A (16 x 16) register r of ``lane``: its two (row, col)."""
    g, t = lane // 4, lane % 4
    return [(g + 8 * (r % 2), 2 * t + 8 * (r // 2) + j) for j in range(2)]


def b_frag(lane, r):
    """B (16 x 8) register r of ``lane``: its two (k, n)."""
    g, t = lane // 4, lane % 4
    return [(2 * t + 8 * r + j, g) for j in range(2)]


def acc_frag(lane, e):
    g, t = lane // 4, lane % 4
    return g + 8 * (e // 2), 2 * t + e % 2


def test_ldmatrix_gives_the_a_fragment():
    r0, c0 = 16, 32
    regs = ldmatrix([addr_a(r0, c0, l) for l in range(32)], trans=False)
    for lane in range(32):
        for r in range(4):
            assert regs[lane][r] == [(r0 + i, c0 + j) for i, j in a_frag(lane, r)]


def test_ldmatrix_gives_b_of_row_products():
    """S = A . T^T (T a tile of rows, B[k][n] = T[n][k]): the registers are B
    of the n8 tiles of rows r0.. (regs 0, 1) and r0 + 8.. (regs 2, 3)."""
    r0, c0 = 32, 16
    regs = ldmatrix([addr_b(r0, c0, l) for l in range(32)], trans=False)
    for lane in range(32):
        for j in range(2):
            for r in range(2):
                want = [(r0 + 8 * j + n, c0 + kk) for kk, n in b_frag(lane, r)]
                assert regs[lane][2 * j + r] == want


def test_ldmatrix_trans_gives_b_of_column_products():
    """dQ = dS . T (B[k][n] = T[k][n], k along the tile's rows): .trans gives B
    of the n8 tiles of columns c0.. (regs 0, 1) and c0 + 8.. (regs 2, 3)."""
    r0, c0 = 16, 48
    regs = ldmatrix([addr_bt(r0, c0, l) for l in range(32)], trans=True)
    for lane in range(32):
        for j in range(2):
            for r in range(2):
                want = [(r0 + kk, c0 + 8 * j + n) for kk, n in b_frag(lane, r)]
                assert regs[lane][2 * j + r] == want


def test_two_accumulator_tiles_are_one_a_fragment():
    """acc_to_a: A register r holds accumulator tile r / 2's elements 2 (r % 2)
    and 2 (r % 2) + 1, the same (row, col) with the second tile's columns + 8."""
    for lane in range(32):
        for r in range(4):
            tile, pair = r // 2, r % 2
            acc = [acc_frag(lane, 2 * pair + j) for j in range(2)]
            assert a_frag(lane, r) == [(row, col + 8 * tile) for row, col in acc]


@pytest.mark.parametrize("hd", [16, 64, 80])
def test_shared_rows_free_of_bank_conflicts(hd):
    """Each 8-lane phase of an ldmatrix reads 8 rows of 16 bytes; rows HD + 8
    bf16 apart put them on 8 distinct groups of 4 banks."""
    stride = 2 * (hd + 8)
    assert stride % 16 == 0
    for addr in (addr_a, addr_b, addr_bt):
        for c0 in range(0, hd, 16):
            starts = [addr(0, c0, l) for l in range(32)]
            for m in range(4):
                banks = {((row * stride + 2 * col) // 4) % 32 // 4
                         for row, col in starts[8 * m:8 * m + 8]}
                assert len(banks) == 8


# ---- the wgmma design (Kw = 64, hd 64 or 80, N a multiple of 128) ----
#
# A block covers 128 own rows as two warpgroups of 64 (4 warps of 16 rows);
# the other side streams in 64-row tiles, each one key row of the key grid.
# Each warpgroup's products are wgmma m64n64 (S, dP and their transposes) and
# m64nHD (dq, dk, dv with the accumulators as the register A operand); the
# emulation keeps every accumulator as 128 threads x 32 registers and moves it
# only through the fragment maps below.

OWN_ROWS = 128
STREAM_ROWS = 64


def wg_acc_map():
    """Accumulator fragment of wgmma m64n64 (f32): (row, col) of register e
    of thread 32 w + l (w: the warp in the warpgroup, g = l / 4, t = l % 4):
    row 16 w + g + 8 i, column 8 j + 2 t + c for e = 4 j + 2 i + c."""
    thr, e = np.meshgrid(np.arange(128), np.arange(32), indexing="ij")
    w, lane = thr // 32, thr % 32
    g, t = lane // 4, lane % 4
    j, i, c = e // 4, (e // 2) % 2, e % 2
    return 16 * w + g + 8 * i, 8 * j + 2 * t + c


def wg_a_map():
    """wgmma's register A operand (m64 x k16, bf16 pairs): (row, col) of the
    two halves h of register 4 s + r of thread 32 w + l in k16 step s (the
    columns of the whole 64-wide operand): row 16 w + g + 8 (r % 2), column
    16 s + 8 (r / 2) + 2 t + h."""
    thr, reg, h = np.meshgrid(np.arange(128), np.arange(16), np.arange(2), indexing="ij")
    w, lane = thr // 32, thr % 32
    g, t = lane // 4, lane % 4
    s, r = reg // 4, reg % 4
    return 16 * w + g + 8 * (r % 2), 16 * s + 8 * (r // 2) + 2 * t + h


def to_a(regs):
    """The kernel's to_a: register r of the A operand packs accumulator
    registers 2 r and 2 r + 1 (the lower half first)."""
    return regs.reshape(regs.shape[0], 16, 2)


def swizzle128(row, chunk):
    """TMA's 128-byte swizzle of 128-byte rows (1024-byte aligned tile): the
    16-byte chunk c of row r lands at chunk c ^ (r % 8)."""
    return chunk ^ (row % 8)


def rel_w_smem(tile):
    """The staged rel_w tile (64 queries x 64 bf16 = 128-byte rows) as TMA
    writes it with the 128-byte swizzle: an (64, 8, 8) array [row][physical
    chunk][element]."""
    img = np.zeros((STREAM_ROWS, 8, 8), tile.dtype)
    for r in range(STREAM_ROWS):
        for c in range(8):
            img[r, swizzle128(r, c)] = tile[r, 8 * c:8 * c + 8]
    return img


def ldsm_x4_trans(img, rows, chunks):
    """ldmatrix.m8n8.x4.trans over the swizzled image: lane l gives row l % 8
    of matrix l / 8 at (rows[l], physical chunks[l]); thread (g, t) receives
    element (2 t + h, g) of each 8 x 8 matrix m as register m's half h, that
    is row 2 t + h of the 8 given rows, element g of that row's 16 bytes."""
    out = np.zeros((32, 4, 2), img.dtype)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for m in range(4):
            for h in range(2):
                src = 8 * m + 2 * t + h
                out[lane, m, h] = img[rows[src], chunks[src], g]
    return out


def kv_rel_w_regs(img, w4):
    """The key-major pass's 16 rel_w registers of each thread of warp w4, as
    the kernel addresses them: call x, lane l (m = l / 8, r = l % 8) points at
    query row 8 (2 x + m / 2) + r, logical chunk 2 w4 + m % 2. Returns
    (32 lanes, 16 registers, 2 halves)."""
    lanes = np.arange(32)
    lm, lr = lanes // 8, lanes % 8
    regs = np.zeros((32, 16, 2), img.dtype)
    for x in range(4):
        rows = 16 * x + 8 * (lm // 2) + lr
        chunks = swizzle128(lr, 2 * w4 + lm % 2)       # rows % 8 == lr
        regs[:, 4 * x:4 * x + 4] = ldsm_x4_trans(img, rows, chunks)
    return regs


def emulate_wgmma(q, k, v, rel_h, rel_w, out, lse, dout, scale, rnd):
    """K-E's wgmma design on float32 numpy inputs; ``rnd`` rounds where the
    kernel rounds to bf16. Returns (dq, dk, dv, drel_h, drel_w)."""
    bh, n, hd = q.shape
    kh, kw = rel_h.shape[2], rel_w.shape[2]
    assert kw == STREAM_ROWS and n % OWN_ROWS == 0
    f32 = np.float32
    rows, cols = wg_acc_map()
    dq, dk, dv = (np.zeros((bh, n, hd), f32) for _ in range(3))
    drel_h, drel_w = np.zeros((bh, n, kh), f32), np.zeros((bh, n, kw), f32)
    dvec = np.zeros((bh, n), f32)
    fold = np.zeros((bh, kh, n), f32)
    scale_l2 = f32(scale) * LOG2E

    # ---- query-major pass: D, the fold table, dq, d rel_h, d rel_w ----
    for b in range(bh):
        for q0 in range(0, n, OWN_ROWS):
            blk = slice(q0, q0 + OWN_ROWS)
            dvec[b, blk] = (dout[b, blk] * out[b, blk]).sum(-1)
            fold[b, :, blk] = ((rel_h[b, blk] - lse[b, blk, None]) * LOG2E).T
            for wg in range(2):
                r0 = q0 + 64 * wg
                own = slice(r0, r0 + 64)
                nl2 = -lse[b, r0 + rows] * LOG2E                       # (128, 32) by register
                dd = dvec[b, r0 + rows]
                rwl = rel_w[b, r0 + rows, cols] * LOG2E                 # the same in every tile
                dqa = np.zeros((64, hd), f32)
                dwa = np.zeros((128, 32), f32)
                dh_s = np.zeros((64, kh), f32)
                for kt in range(n // STREAM_ROWS):
                    keys = slice(kt * STREAM_ROWS, (kt + 1) * STREAM_ROWS)
                    s_m = q[b, own] @ k[b, keys].T                      # wgmma m64n64
                    dp_m = dout[b, own] @ v[b, keys].T
                    sacc, pacc = s_m[rows, cols], dp_m[rows, cols]
                    off = rel_h[b, r0 + rows, kt] * LOG2E + nl2
                    p = np.exp2(sacc * scale_l2 + (rwl + off))
                    ds = p * (pacc - dd)
                    dwa += ds
                    # d rel_h[q, kt]: the thread's 16 columns of each row, then the quad
                    part = np.zeros((64,), f32)
                    np.add.at(part, rows.ravel(), ds.ravel())
                    dh_s[:, kt] = rnd(part)
                    a = np.zeros((64, 64), f32)                         # dS as the A operand
                    ar, ac = wg_a_map()
                    a[ar, ac] = rnd(to_a(ds))
                    dqa += a @ k[b, keys]                               # MN-major B: the K tile
                dq[b, own] = rnd(dqa * f32(scale))
                drel_h[b, own] = dh_s
                dwm = np.zeros((64, 64), f32)
                dwm[rows, cols] = dwa
                drel_w[b, own] = rnd(dwm)

    # ---- key-major pass: dk and dv, two key rows a block ----
    for b in range(bh):
        for k0 in range(0, n, OWN_ROWS):
            for wg in range(2):
                r0 = k0 + 64 * wg
                i_row = r0 // kw                                        # the warpgroup's key row
                own = slice(r0, r0 + 64)
                dka, dva = np.zeros((64, hd), f32), np.zeros((64, hd), f32)
                for qt in range(n // STREAM_ROWS):
                    qs = slice(qt * STREAM_ROWS, (qt + 1) * STREAM_ROWS)
                    st_m = k[b, own] @ q[b, qs].T                       # (keys, queries)
                    dpt_m = v[b, own] @ dout[b, qs].T
                    sacc, pacc = st_m[rows, cols], dpt_m[rows, cols]
                    # the stage: the rel_w tile (swizzled), fold rows i_row (by
                    # warpgroup), D; the bias in the accumulator's layout
                    img = rel_w_smem(rel_w[b, qs])
                    fold2 = fold[b, i_row, qs].reshape(32, 2)           # float2 per (8 jn + 2 t) / 2
                    d2 = dvec[b, qs].reshape(32, 2)
                    # register e = 4 jn + 2 i + c: rel_w register 2 jn + i, half c;
                    # the float2 of fold and of D at 4 jn + t, half c
                    e = np.arange(32)
                    jn, i, c = e // 4, (e // 2) % 2, e % 2
                    t = (np.arange(128) % 32 % 4)[:, None]
                    bias = np.concatenate([kv_rel_w_regs(img, w4)[:, 2 * jn + i, c]
                                           for w4 in range(4)])
                    fcol, dcol = fold2[4 * jn + t, c], d2[4 * jn + t, c]
                    p = np.exp2(sacc * scale_l2 + (bias * LOG2E + fcol))
                    ds = p * (pacc - dcol)
                    ar, ac = wg_a_map()
                    a_p, a_ds = np.zeros((64, 64), f32), np.zeros((64, 64), f32)
                    a_p[ar, ac] = rnd(to_a(p))
                    a_ds[ar, ac] = rnd(to_a(ds))
                    dva += a_p @ dout[b, qs]
                    dka += a_ds @ q[b, qs]
                dk[b, own] = rnd(dka * f32(scale))
                dv[b, own] = rnd(dva)
    return dq, dk, dv, drel_h, drel_w


WGMMA_CASES = [
    (1, 2, 64, 80),     # N = 128: one block, its two warpgroups on two key rows
    (1, 4, 64, 64),     # N = 256, hd 64
    (2, 2, 64, 80),     # two bh
]


@pytest.mark.parametrize("bh,kh,kw,hd", WGMMA_CASES)
def test_wgmma_emulation_matches_plain_and_jax_f32(bh, kh, kw, hd):
    q, k, v, rh, rw, g = _inputs(bh, kh, kw, hd, seed=kh + hd, rnd=lambda x: x)
    scale = hd ** -0.5
    t = list(map(torch.from_numpy, (q, k, v, rh, rw, g)))
    out, lse = vit_attention_forward(*t[:5], scale)
    got = emulate_wgmma(q, k, v, rh, rw, out.numpy(), lse.numpy(), g, scale, lambda x: x)
    plain = vit_attention_bwd_plain(*t[:5], out, lse, t[5], scale)
    jax_vjp = K._bwd_rule(scale, tuple(map(jnp.asarray, (q, k, v, rh, rw))), jnp.asarray(g))
    for name, a, b, c in zip(NAMES, got, plain, jax_vjp):
        assert a.shape == tuple(b.shape), name
        assert _rel(a, b.numpy()) <= 1e-5, (name, _rel(a, b.numpy()))
        assert _rel(a, c) <= 1e-5, (name, _rel(a, c))


@pytest.mark.parametrize("bh,kh,kw,hd", WGMMA_CASES[:2])
def test_wgmma_emulation_with_bf16_rounding_matches_plain(bh, kh, kw, hd):
    """bf16 inputs and the kernel's roundings, within the card's limits of the
    plain version (check_vit_attention_bwd: dq, dk 1e-2; the rest 2e-3)."""
    q, k, v, rh, rw, g = _inputs(bh, kh, kw, hd, seed=5, rnd=bf16)
    scale = hd ** -0.5
    t = [torch.from_numpy(x).bfloat16() for x in (q, k, v, rh, rw, g)]
    out, lse = vit_attention_forward(*t[:5], scale)
    got = emulate_wgmma(q, k, v, rh, rw, out.float().numpy(), lse.numpy(), g, scale, bf16)
    want = vit_attention_bwd_plain(*t[:5], out, lse, t[5], scale)
    for name, a, b in zip(NAMES, got, want):
        tol = 1e-2 if name in ("dq", "dk") else 2e-3
        assert _rel(a, b.float().numpy()) <= tol, (name, _rel(a, b.float().numpy()))


def test_wgmma_accumulator_is_the_a_operand():
    """to_a moves no element: the A operand built from the accumulator's
    registers holds the accumulator's own (row, column) for every thread."""
    rows, cols = wg_acc_map()
    ar, ac = wg_a_map()
    pairs = np.stack([rows, cols], -1).reshape(128, 16, 2, 2)     # to_a of (row, col)
    assert np.array_equal(pairs[..., 0], ar) and np.array_equal(pairs[..., 1], ac)
    # the maps cover the 64 x 64 tile once each
    assert len({(r, c) for r, c in zip(rows.ravel(), cols.ravel())}) == 64 * 64


def test_wgmma_a_operand_is_mma_sync_a_fragment_per_warp():
    """wgmma's register A operand is mma.m16n8k16's A fragment, warp by warp
    (rows 16 w ..): the same layout the mma.sync design loads by ldmatrix."""
    ar, ac = wg_a_map()
    for thr in range(128):
        w, lane = thr // 32, thr % 32
        for s in range(4):
            for r in range(4):
                want = [(16 * w + row, 16 * s + col) for row, col in a_frag(lane, r)]
                assert [(ar[thr, 4 * s + r, h], ac[thr, 4 * s + r, h]) for h in range(2)] == want


def test_ldmatrix_trans_reads_rel_w_in_the_accumulator_layout():
    """Under the 128-byte swizzle, the key-major pass's four ldmatrix.x4.trans
    hand thread (w4, g, t) rel_w[q][j] for exactly the (key j, query q) of
    its S^T accumulator registers: register 2 jn + i, half c is the bias of
    register 4 jn + 2 i + c."""
    tile = np.arange(64 * 64).reshape(64, 64)                     # tile[q][j] = 64 q + j
    img = rel_w_smem(tile)
    rows, cols = wg_acc_map()
    for w4 in range(4):
        regs = kv_rel_w_regs(img, w4)
        for lane in range(32):
            thr = 32 * w4 + lane
            for jn in range(8):
                for i in range(2):
                    for c in range(2):
                        e = 4 * jn + 2 * i + c
                        key, query = rows[thr, e], cols[thr, e]
                        assert regs[lane, 2 * jn + i, c] == tile[query, key]


def test_ldmatrix_trans_of_rel_w_is_free_of_bank_conflicts():
    """Each 8-lane phase of the key-major pass's ldmatrix reads 8 rows of 16
    bytes at distinct 16-byte bank groups (the swizzle spreads them)."""
    lanes = np.arange(32)
    lm, lr = lanes // 8, lanes % 8
    for w4 in range(4):
        for x in range(4):
            rows = 16 * x + 8 * (lm // 2) + lr
            addr = rows * 128 + (swizzle128(lr, 2 * w4 + lm % 2) << 4)
            for m in range(4):
                groups = {(a // 16) % 8 for a in addr[8 * m:8 * m + 8]}
                assert len(groups) == 8


def test_fold_table_and_dvec_layout():
    """The scratch the wrapper allocates, (BH, 1 + Kh, N) f32, holds D (BH, N)
    first and the fold table (BH, Kh, N) after it; a key-major stage's TMA box
    {64 queries, 2 key rows} at (q0, k0 / 64, bh) is fold rows k0 / 64 and
    k0 / 64 + 1 of the block's two warpgroups."""
    bh, kh, n = 2, 4, 256
    scratch = np.arange(bh * n * (1 + kh))
    d = scratch[:bh * n].reshape(bh, n)
    fold = scratch[bh * n:].reshape(bh, kh, n)
    assert d[1, 5] == 1 * n + 5
    b, k0, q0 = 1, 128, 64
    box = fold[b, k0 // 64:k0 // 64 + 2, q0:q0 + 64]
    for wg in range(2):
        assert box[wg, 0] == bh * n + (b * kh + k0 // 64 + wg) * n + q0
