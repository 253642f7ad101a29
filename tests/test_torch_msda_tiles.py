"""CPU emulation of kernel K-B's work decomposition (hipie_torch/csrc/ms_deform_attn.cu).

The CUDA kernel cannot run here, so this module replays what it does, thread
by thread, in numpy, under the plan the wrapper gives it (``kernel_plan``):
blocks of 256 threads own runs of consecutive (b, q, m) pairs; per table fill
of 16 samples, thread t takes the tile's samples t, t + 256, ... in (pair,
sample) order, reads their locations and weights and writes each sample's 4
corner offsets (in vectors, out-of-range corners clamped to a valid row) and 4
weights (bilinear x attention, 0 for an out-of-range corner) into the shared
table [sample][pair + 1 pad]; each thread then gathers its vector chunk of
every corner row in batches of 4 samples, accumulates in f32, meets the other
sample groups of its pair through xor shuffles, and the first group stores.

The emulation is held against ``ms_deform_attn_plain`` and the JAX package's
``ms_deform_attn_jnp(method="flat")`` in f32 to 1e-5 (the same f32 samples
summed in another order), and in bf16 values to the card's limits (one bf16
ulp of the largest output, relative norm error 1e-3). It also checks the
layout facts the kernel's speed rests on: a warp's 16-byte loads cover whole
corner rows, a tile's locations are one contiguous stretch read in order, and
the table's writes and reads are free of bank conflicts.
"""

import torch_threads  # noqa: F401  (first: sizes torch's CPU threads)
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from hipie_tpu.ops.ms_deform_attn import ms_deform_attn_jnp
from hipie_torch.ops.ms_deform_attn import (BLOCK_THREADS, GATHER_BATCH, MAX_PAIRS, TABLE_CHUNK,
                                            kernel_plan, ms_deform_attn_plain)

THREADS, CHUNK, BATCH = BLOCK_THREADS, TABLE_CHUNK, GATHER_BATCH
STAGE_PER_THREAD = MAX_PAIRS * CHUNK // THREADS
f32 = np.float32


def level_tables(shapes):
    hw = np.array(shapes, np.int64)
    starts = np.concatenate([[0], np.cumsum(hw[:, 0] * hw[:, 1])[:-1]])
    return hw, starts


def stage(loc_flat, attw_flat, shapes, n_points, m, d, elem, plan, pair0, pairs, lp, s0):
    """One table fill for the blocks whose first pairs are ``pair0`` (nb,):
    offsets (nb, CHUNK, pb + 1, 4) in vectors and weights (nb, CHUNK, pb + 1, 4),
    and the flat sample index each thread read (nb, THREADS, STAGE_PER_THREAD),
    -1 where it read none."""
    pb = plan.pairs_per_block
    hw, starts = level_tables(shapes)
    row_vecs = m * d * elem // plan.vec_bytes
    nb = len(pair0)
    off = np.zeros((nb, CHUNK, pb + 1, 4), np.int64)
    wt = np.zeros((nb, CHUNK, pb + 1, 4), f32)
    read = np.full((nb, THREADS, STAGE_PER_THREAD), -1, np.int64)
    t = np.arange(THREADS)
    for i in range(STAGE_PER_THREAD):
        e = t + i * THREADS
        written = e < pb * CHUNK
        pe, se = e // CHUNK, e % CHUNK
        pr = pair0[:, None] + pe[None, :]
        sp = s0 + se
        has = written[None] & (pr < pairs) & (sp < lp)[None]
        k = np.where(has, pr * lp + sp, 0)
        read[:, :, i] = np.where(has, k, -1)
        xy = np.where(has[..., None], loc_flat[k], f32(0))
        a = np.where(has, attw_flat[k], f32(0))
        lvl = np.minimum(sp, lp - 1) // n_points
        h, w, start = hw[lvl, 0], hw[lvl, 1], starts[lvl]
        hf, wf = h.astype(f32), w.astype(f32)
        x = np.clip(xy[..., 0] * wf - f32(0.5), f32(-2), wf + f32(1)).astype(f32)
        y = np.clip(xy[..., 1] * hf - f32(0.5), f32(-2), hf + f32(1)).astype(f32)
        xf, yf = np.floor(x), np.floor(y)
        x0, y0 = xf.astype(np.int64), yf.astype(np.int64)
        lx, ly = x - xf, y - yf
        vx0, vx1 = (x0 >= 0) & (x0 < w), (x0 >= -1) & (x0 < w - 1)
        vy0, vy1 = (y0 >= 0) & (y0 < h), (y0 >= -1) & (y0 < h - 1)
        cx0, cx1 = np.clip(x0, 0, w - 1), np.clip(x0 + 1, 0, w - 1)
        r0 = start + np.clip(y0, 0, h - 1) * w
        r1 = start + np.clip(y0 + 1, 0, h - 1) * w
        one = f32(1)
        o = np.stack([r0 + cx0, r0 + cx1, r1 + cx0, r1 + cx1], -1) * row_vecs
        cw = np.stack([np.where(vy0 & vx0, a * (one - ly) * (one - lx), 0),
                       np.where(vy0 & vx1, a * (one - ly) * lx, 0),
                       np.where(vy1 & vx0, a * ly * (one - lx), 0),
                       np.where(vy1 & vx1, a * ly * lx, 0)], -1).astype(f32)
        off[:, se[written], pe[written]] = o[:, written]
        wt[:, se[written], pe[written]] = cw[:, written]
    return off, wt, read


def thread_roles(plan):
    t = np.arange(THREADS)
    tpp = plan.chunk_threads * plan.groups
    return t // tpp, t % tpp // plan.chunk_threads, t % plan.chunk_threads


def emulate(value, shapes, loc, attw, plan):
    """K-B on numpy inputs; ``value`` holds f32 numbers, ``plan.vec_bytes`` and
    the element size say how they lie in memory. Returns (B, Q, M*D) f32,
    before the output's rounding."""
    b, s, m, d = value.shape
    q, n_levels, n_points = loc.shape[1], loc.shape[3], loc.shape[4]
    lp = n_levels * n_points
    elem = plan.vec_bytes * plan.chunks // d
    lanes = plan.vec_bytes // elem
    pb = plan.pairs_per_block
    pairs = b * q * m
    n_blocks = -(-pairs // pb)
    pair0 = np.arange(n_blocks) * pb
    value_vecs = value.reshape(-1, lanes)
    loc_flat, attw_flat = loc.reshape(-1, 2), attw.reshape(-1)
    out_vecs = np.zeros((pairs * d // lanes, lanes), f32)

    pl, g, ctl = thread_roles(plan)
    pair = pair0[:, None] + pl[None]
    live = pair < pairs
    pc = np.where(live, pair, pairs - 1)
    bi, mi = pc // (q * m), pc % m
    vbase = (bi * s * m + mi) * d // lanes                 # the (b, 0, m) row, in vectors
    blk = np.arange(n_blocks)[:, None]
    n_fills = -(-lp // CHUNK)
    tables = [stage(loc_flat, attw_flat, shapes, n_points, m, d, elem, plan, pair0, pairs, lp,
                    fill * CHUNK)[:2] for fill in range(n_fills)]
    for it in range(plan.chunk_iters):
        c = ctl + it * plan.chunk_threads
        c_ok = c < plan.chunks
        ce = np.where(c_ok, c, 0)[None]
        acc = np.zeros((n_blocks, THREADS, lanes), f32)
        for off, wt in tables:
            for j0 in range(0, CHUNK // plan.groups, BATCH):
                for j in range(BATCH):
                    se = (j0 + j) * plan.groups + g
                    o, cw = off[blk, se[None], pl[None]], wt[blk, se[None], pl[None]]
                    for k in range(4):
                        v = value_vecs[vbase + o[..., k] + ce]
                        acc = (acc + cw[..., k, None] * v).astype(f32)
        step = 1
        while step < plan.groups:                           # __shfl_xor_sync over the groups
            acc = acc + acc[:, np.arange(THREADS) ^ (step * plan.chunk_threads)]
            step *= 2
        store = live & c_ok[None] & (g == 0)[None]
        out_vecs[(pair * d // lanes + c[None])[store]] = acc[store]
    return out_vecs.reshape(b, q, m * d)


def bf16(x):
    return torch.from_numpy(np.ascontiguousarray(x, f32)).bfloat16().float().numpy()


def make_inputs(b, q, m, d, shapes, p, seed, locations="uniform"):
    r = np.random.RandomState(seed)
    s = sum(h * w for h, w in shapes)
    n_levels = len(shapes)
    value = r.randn(b, s, m, d).astype(f32)
    if locations == "edges":   # pixel centres and edges (x = loc * W - 0.5 integer or half)
        hw = np.array([[w, h] for h, w in shapes], f32)[None, None, None, :, None, :]
        k = r.randint(-3, 2 * max(max(sh) for sh in shapes) + 3, (b, q, m, n_levels, p, 2))
        loc = (k / f32(2) / hw).astype(f32)
    else:                      # including points outside [0, 1]
        loc = r.uniform(-0.2, 1.2, (b, q, m, n_levels, p, 2)).astype(f32)
    attw = r.uniform(0, 1, (b, q, m, n_levels, p)).astype(f32)
    return value, loc, attw / attw.sum(axis=(-1, -2), keepdims=True)


CASES = [
    # b, q, m, d, shapes, p, locations, groups (None: the plan's), align
    (2, 37, 3, 32, ((13, 19), (7, 10)), 8, "uniform", None, 16),    # 222 pairs: ragged tile
    (1, 45, 2, 32, ((13, 19), (7, 10)), 8, "edges", 4, 16),         # L*P = 16, shuffles
    (2, 29, 8, 16, ((13, 19), (6, 5), (3, 2), (2, 2)), 4, "uniform", 1, 16),
    (2, 29, 8, 16, ((13, 19), (6, 5), (3, 2), (2, 2)), 4, "edges", 4, 16),
    (1, 50, 8, 4, ((13, 19), (7, 10), (4, 5), (2, 3)), 4, "uniform", None, 16),  # 1 vector a row
    (1, 21, 2, 8, ((9, 7),) * 4, 8, "uniform", None, 16),           # L*P = 32: two fills
    (2, 13, 2, 3, ((5, 7), (2, 3)), 3, "edges", None, 16),          # L*P = 6; 4-byte vectors
    (1, 19, 2, 40, ((13, 19),), 4, "uniform", None, 8),             # 8-byte vectors, 20 a row
    (1, 11, 2, 127, ((5, 4), (2, 2)), 2, "uniform", None, 16),      # 4 passes of 32 threads
]


@pytest.mark.parametrize("b,q,m,d,shapes,p,locations,groups,align", CASES)
def test_emulation_matches_plain_and_jax_f32(b, q, m, d, shapes, p, locations, groups, align):
    value, loc, attw = make_inputs(b, q, m, d, shapes, p, q * d + b, locations)
    plan = kernel_plan(d, 4, b * q * m, align, groups)
    got = emulate(value, shapes, loc, attw, plan)
    plain = ms_deform_attn_plain(torch.from_numpy(value), shapes, torch.from_numpy(loc),
                                 torch.from_numpy(attw)).numpy()
    flat = np.asarray(jax.jit(lambda v, l, a: ms_deform_attn_jnp(v, shapes, l, a, "flat"))(
        jnp.asarray(value), jnp.asarray(loc), jnp.asarray(attw)))
    np.testing.assert_allclose(got, plain, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, flat, rtol=0, atol=1e-5)


@pytest.mark.parametrize("groups", [1, 4])
def test_emulation_matches_plain_bf16(groups):
    """bf16 values, 8 to a 16-byte vector: the card's limits against the plain version."""
    shapes = ((13, 19), (7, 10), (4, 5), (2, 3))
    value, loc, attw = make_inputs(2, 40, 8, 32, shapes, 4, 11 + groups)
    value = bf16(value)
    plan = kernel_plan(32, 2, 2 * 40 * 8, groups=groups)
    assert (plan.vec_bytes, plan.chunk_threads) == (16, 4)
    got = bf16(emulate(value, shapes, loc, attw, plan))
    want = ms_deform_attn_plain(torch.from_numpy(value).bfloat16(), shapes, torch.from_numpy(loc),
                                torch.from_numpy(attw)).float().numpy()
    assert np.abs(got - want).max() <= 2 ** -7 * np.abs(want).max()
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 1e-3


def test_plans_of_the_paths():
    """ViT-H and R50: 16-byte vectors, 4 threads a bf16 row; one group where the
    grid fills the card, 4 at MaskDINO's 300 queries; the tiny slice's D = 16 and
    D = 4 in f32; narrower vectors where rows or addresses are not 16-byte."""
    assert kernel_plan(32, 2, 21760 * 8) == (16, 4, 4, 1)
    assert kernel_plan(32, 2, 20197 * 8) == (16, 4, 4, 1)
    assert kernel_plan(32, 2, 910 * 8) == (16, 4, 4, 1)
    assert kernel_plan(32, 2, 300 * 8) == (16, 4, 4, 4)
    assert kernel_plan(32, 4, 21760 * 8) == (16, 8, 8, 1)
    assert kernel_plan(32, 4, 910 * 8) == (16, 8, 8, 1)
    assert kernel_plan(32, 4, 300 * 8) == (16, 8, 8, 4)
    assert kernel_plan(16, 4, 900 * 2) == (16, 4, 4, 4)
    assert kernel_plan(4, 4, 300 * 8) == (16, 1, 1, 4)
    assert kernel_plan(4, 2, 300 * 8) == (8, 1, 1, 4)
    assert kernel_plan(3, 2, 10) == (2, 3, 4, 4)
    assert kernel_plan(32, 2, 21760 * 8, align=2) == (2, 32, 32, 1)
    assert kernel_plan(127, 4, 10).chunk_iters == 4
    assert kernel_plan(32, 2, 21760 * 8).pairs_per_block == 64      # 8 queries x 8 heads
    with pytest.raises(ValueError):
        kernel_plan(16, 2, 10, groups=1)           # 2 threads a pair


def test_warp_loads_cover_whole_corner_rows():
    """D = 32 bf16: in each load instruction a warp's 32 threads read 8 corner
    rows, each as 4 consecutive 16-byte chunks of one 64-byte row."""
    shapes = ((16, 16), (8, 8))
    value, loc, attw = make_inputs(1, 64, 8, 32, shapes, 8, 3)
    plan = kernel_plan(32, 2, 64 * 8, groups=1)
    off, _, _ = stage(loc.reshape(-1, 2), attw.reshape(-1), shapes, 8, 8, 32, 2, plan,
                      np.array([0]), 64 * 8, 16, 0)
    pl, g, ctl = thread_roles(plan)
    for se in range(CHUNK):
        for k in range(4):
            vec = (pl % 8) * 32 // 8 + off[0, se, pl, k] + ctl     # (b, 0, m) row + corner + chunk
            for warp in range(THREADS // 32):
                v = vec[32 * warp: 32 * warp + 32].reshape(8, 4)
                np.testing.assert_array_equal(v - v[:, :1], np.tile(np.arange(4), (8, 1)))
                assert (v[:, 0] % 4 == 0).all()                       # 64-byte aligned rows


def test_tile_reads_one_stretch_in_order():
    """With L*P = 16 a block reads its pairs' locations and weights once, as
    one contiguous stretch, each warp 32 consecutive samples; a ragged last
    tile reads only what exists."""
    shapes = ((13, 19), (7, 10), (4, 5), (2, 3))
    b, q, m = 1, 37, 8
    value, loc, attw = make_inputs(b, q, m, 32, shapes, 4, 5)
    plan = kernel_plan(32, 2, b * q * m, groups=1)
    pb, pairs = plan.pairs_per_block, b * q * m
    pair0 = np.arange(-(-pairs // pb)) * pb
    _, _, read = stage(loc.reshape(-1, 2), attw.reshape(-1), shapes, 4, m, 32, 2, plan, pair0,
                       pairs, 16, 0)
    for blk, p0 in enumerate(pair0):
        order = read[blk].T.reshape(-1)                 # (i, t): the order of the loads
        order = order[order >= 0]
        np.testing.assert_array_equal(order, np.arange(p0 * 16, min(p0 + pb, pairs) * 16))
        warps = read[blk].T.reshape(-1, 32)
        for w in warps[(warps >= 0).all(1)]:
            np.testing.assert_array_equal(np.diff(w), 1)


def test_out_of_range_corners_get_weight_zero_and_a_valid_row():
    shapes = ((5, 7), (2, 3))
    b, q, m, d = 1, 64, 2, 32
    value, loc, attw = make_inputs(b, q, m, d, shapes, 8, 9)
    r = np.random.RandomState(0)
    loc[..., 0, :, :] = np.array([-0.5, 1.5], f32)[r.randint(0, 2, loc[..., 0, :, :].shape)]
    loc[..., 1, :, :] = r.uniform(0.1, 0.9, loc[..., 1, :, :].shape)
    plan = kernel_plan(d, 4, b * q * m, groups=1)
    off, wt, _ = stage(loc.reshape(-1, 2), attw.reshape(-1), shapes, 8, m, d, 4, plan,
                       np.array([0, plan.pairs_per_block]), b * q * m, 16, 0)
    row_vecs = m * d * 4 // plan.vec_bytes
    s = sum(h * w for h, w in shapes)
    assert (off >= 0).all() and (off < s * row_vecs).all() and (off % row_vecs == 0).all()
    assert (wt[:, :8] == 0).all()                        # level 0: every point outside
    assert (wt[:, 8:, :-1].sum(-1) > 0).all()            # level 1: inside, weights kept


def banks(addr):
    """The 4-bank group a 16-byte shared access falls in."""
    return (addr // 16) % 8


@pytest.mark.parametrize("d,elem,pairs", [(32, 2, 21760 * 8), (32, 2, 300 * 8),
                                          (32, 4, 21760 * 8), (32, 4, 300 * 8),
                                          (16, 4, 900 * 2), (127, 2, 80)])
def test_table_accesses_are_free_of_bank_conflicts(d, elem, pairs):
    """16-byte shared accesses go in phases of 8 threads; a phase is conflict
    free when its distinct addresses fall in distinct 4-bank groups. Writes:
    thread t's i-th sample goes to slot se * (pb + 1) + pe. Reads: sample
    (j0 + j) * G + g of pair pl. This holds for every plan with 2 or more
    threads across a row; with one (rows of 16 bytes or less, the tiny
    configs' D = 4) the reads of 2 pairs x 4 groups conflict 2-way."""
    plan = kernel_plan(d, elem, pairs)
    pb = plan.pairs_per_block
    t = np.arange(THREADS)
    phases = []
    for i in range(STAGE_PER_THREAD):
        e = t + i * THREADS
        slot = (e % CHUNK) * (pb + 1) + e // CHUNK
        phases += [slot[e < pb * CHUNK].reshape(-1, 8)] if (e < pb * CHUNK).any() else []
    pl, g, _ = thread_roles(plan)
    for j0 in range(0, CHUNK // plan.groups, BATCH):
        for j in range(BATCH):
            phases.append((((j0 + j) * plan.groups + g) * (pb + 1) + pl).reshape(-1, 8))
    for phase in np.concatenate(phases):
        addr = np.unique(phase * 16)
        assert len(np.unique(banks(addr))) == len(addr)
