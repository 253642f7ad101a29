"""CPU replay of kernel K-D's binned design (hipie_torch/csrc/ms_deform_attn_bwd.cu).

The CUDA kernels cannot run here, so this module replays in numpy what they
do, under the wrapper's copy of the C plan (``binned_plan`` and the BWD_*
constants, which the card tests hold equal to the built library's):

  * bin_count: samples in blocks of 4096, each sample's bin (b, m, level,
    16 x 16 tile holding its top-left corner; y0 = -1 or x0 = -1 in tile row
    or column 0; no bin where all four corners are off the map) from K-B's
    clamped pixel coordinates, the indices split by the C entry's
    multiply-shift divisions; a histogram per block, merged;
  * bin_scan: each bin's list start and its chunks (ceil(n / 4096), chunk j
    taking every nch-th record from the j-th), the chunk count;
  * bin_scatter: in blocks of 8192 samples, each block's range of every
    bin, the samples' 16-byte records (index, x, y, weight) placed in it, and
    each sample's place;
  * accumulate, one chunk at a time: the value tile with a ring of one pixel
    (18 x 18 pixels from (y_org - 1, x_org - 1), zeros past the map, as the
    TMA box reads them), the chunk's
    records sorted by band (the tile row of their top-left corner), warp w
    taking band 2w and then band 2w + 1, eight samples to a warp of 4 lanes of
    8 channels, the corner dots, the location and weight gradients, and the
    value gradient added into the ringed f32 tile at the four corner pixels
    (0 for a corner off the map); each sample's three scalar gradients
    written into its record's place; then the tile added into the gradient
    where it lies inside the map, rows 0..TH and columns 0..TW + 1 from
    (y_org, x_org) (the TMA reduce-add);
  * unpermute: each sample's location and weight gradients, in sample order,
    from its record's place (zeros for a sample in no bin).

The replay is held against JAX's ``_msda_train_bwd`` (``jax.vjp`` of
``ms_deform_attn_train``) and the plain version's autograd in f32 to 1e-5
relative norm (the same f32 products summed in another order). It also
checks what the design's correctness rests on: the chunks of a bin add each
of its samples once; within a phase no two warps touch one word of the tile;
within a warp's step the 32 lanes touch 32 distinct words on 32 distinct
banks; and the multiply-shift divisions are exact.
"""

import torch_threads  # noqa: F401  (first: sizes torch's CPU threads)
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from hipie_torch.ops.ms_deform_attn import (BWD_ACC_THREADS, BWD_BIN_D, BWD_BIN_PER_THREAD,
                                            BWD_BIN_THREADS, BWD_CHUNK, BWD_MAX_BINS,
                                            BWD_SCATTER_PER_THREAD, BWD_SCATTER_THREADS,
                                            BWD_TILE_H, BWD_TILE_W,
                                            binned_plan, bwd_design_rule,
                                            ms_deform_attn_backward_plain)

f32 = np.float32
TH, TW, D = BWD_TILE_H, BWD_TILE_W, BWD_BIN_D
BLOCK_SAMPLES = BWD_BIN_THREADS * BWD_BIN_PER_THREAD
WARPS = BWD_ACC_THREADS // 32
SLOTS, LANES = 8, 4                 # an accumulate warp's samples at a time, lanes a sample
ROW = TW + 2                        # pixels a row of the accumulate tiles


def make_div(d):
    shift = 0
    while (1 << shift) < d:
        shift += 1
    return d, ((1 << 32) * ((1 << shift) - d)) // d + 1, shift


def fast_div(n, div):
    """The C entry's FastDiv: (umulhi(n, mul) + n) >> shift, for n < 2^31."""
    _, mul, shift = div
    n = np.asarray(n, np.uint64)
    return ((((n * np.uint64(mul)) >> np.uint64(32)) + n) >> np.uint64(shift)).astype(np.int64)


def sample_bins(loc, levels, plan):
    """Each sample's (bin or -1, clamped x, clamped y), in flat (b, q, m, l, p) order."""
    b, q, m, n_levels, p, _ = loc.shape
    k = np.arange(loc[..., 0].size, dtype=np.int64)
    lp_div, p_div, m_div, qm_div = (make_div(v) for v in (n_levels * p, p, m, q * m))
    pair = fast_div(k, lp_div)
    lvl = fast_div(k - pair * lp_div[0], p_div)
    mi = pair - fast_div(pair, m_div) * m
    bi = fast_div(pair, qm_div)
    hw = np.array(levels, np.int64)
    h, w = hw[lvl, 0], hw[lvl, 1]
    xy = loc.reshape(-1, 2)
    x = np.minimum(np.maximum(xy[:, 0] * w.astype(f32) - f32(0.5), f32(-2)), (w + 1).astype(f32))
    y = np.minimum(np.maximum(xy[:, 1] * h.astype(f32) - f32(0.5), f32(-2)), (h + 1).astype(f32))
    x0, y0 = np.floor(x).astype(np.int64), np.floor(y).astype(np.int64)
    inside = (x0 >= -1) & (x0 < w) & (y0 >= -1) & (y0 < h)
    base, tiles_x = np.array(plan.tile_base), np.array(plan.tiles_x)
    bins = ((bi * m + mi) * plan.tile_base[-1] + base[lvl]
            + (np.maximum(y0, 0) // TH) * tiles_x[lvl] + np.maximum(x0, 0) // TW)
    return np.where(inside, bins, -1), x.astype(f32), y.astype(f32)


def bin_count(bins, plan):
    """bin_count: a histogram per 4096-sample block, merged into the counts."""
    n_blocks = -(-bins.size // BLOCK_SAMPLES)
    hists = np.zeros((n_blocks, plan.n_bins), np.int64)
    for blk in range(n_blocks):
        own = bins[blk * BLOCK_SAMPLES:(blk + 1) * BLOCK_SAMPLES]
        hists[blk] = np.bincount(own[own >= 0], minlength=plan.n_bins)
    return hists.sum(0)


def bin_scan(counts):
    """bin_scan: list starts and the chunk table (bin, first record, length,
    stride): a bin of n samples makes nch = ceil(n / 4096) chunks, chunk j
    taking records j, j + nch, ... of the bin's list."""
    start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    chunks = []
    for bin_, (n, s0) in enumerate(zip(counts, start)):
        nch = -(-int(n) // BWD_CHUNK)
        chunks += [(bin_, s0 + j, -(-(int(n) - j) // nch), nch) for j in range(nch)]
    return start, np.array(chunks, np.int64).reshape(-1, 4)


def bin_scatter(bins, x, y, attw, start):
    """bin_scatter: blocks in order (any order is an execution), each taking
    its range of a bin after the earlier blocks' and placing its samples in
    thread order; records (index, x, y, weight) and each sample's record
    place (inv, -1 for none)."""
    cursor = start.copy()
    records = np.zeros((int((bins >= 0).sum()), 4), f32)
    index = np.zeros(len(records), np.int64)
    per, block = BWD_SCATTER_PER_THREAD, BWD_SCATTER_PER_THREAD * BWD_SCATTER_THREADS
    for blk in range(-(-bins.size // block)):
        t = np.arange(BWD_SCATTER_THREADS)
        k = (blk * block + t[None] + BWD_SCATTER_THREADS * np.arange(per)[:, None]).ravel()
        k = k[(k < bins.size)]
        k = k[bins[k] >= 0]
        for bin_ in np.unique(bins[k]):
            mine = k[bins[k] == bin_]
            pos = cursor[bin_] + np.arange(len(mine))
            cursor[bin_] += len(mine)
            index[pos] = mine
            records[pos] = np.stack([mine.astype(f32), x[mine], y[mine], attw[mine]], -1)
    assert np.array_equal(cursor, start + np.bincount(bins[bins >= 0], minlength=len(start)))
    inv = np.full(bins.size, -1, np.int64)
    inv[index] = np.arange(len(index))
    return index, records, inv


def accumulate(chunk, index, records, value, gout, levels, lp, plan, grad, out, seen):
    """One accumulate block. Adds its tile into ``grad`` (B, S, M, D) and writes
    each of its samples' (index, weight gradient, location gradient) into its
    record's place in ``out``; counts each sample it takes in ``seen``.
    Returns the tile words each (phase, warp) touched and the banks of every
    warp step."""
    m = value.shape[2]
    bin_, first, n, stride = (int(v) for v in chunk)
    tiles = plan.tile_base[-1]
    bm, t = divmod(bin_, tiles)
    lvl = max(i for i in range(len(levels)) if plan.tile_base[i] <= t)
    ty, tx = divmod(t - plan.tile_base[lvl], plan.tiles_x[lvl])
    bi, mi = divmod(bm, m)
    h, w = levels[lvl]
    y_org, x_org = ty * TH, tx * TW
    lstart = sum(hh * ww for hh, ww in levels[:lvl])
    vmap = value[bi, lstart:lstart + h * w, mi].reshape(h, w, D)
    # the TMA box: the tile with a ring of one pixel, from (y_org - 1, x_org - 1),
    # zeros past the map
    y_lo, x_lo = max(y_org - 1, 0), max(x_org - 1, 0)
    y_hi, x_hi = min(y_org + TH + 1, h), min(x_org + TW + 1, w)
    box = (slice(y_lo - y_org + 1, y_hi - y_org + 1), slice(x_lo - x_org + 1, x_hi - x_org + 1))
    vtile = np.zeros((TH + 2, TW + 2, D), f32)
    vtile[box] = vmap[y_lo:y_hi, x_lo:x_hi]
    vtile = vtile.reshape(-1, D)
    # the gradient tile: tile pixel (r, c) at 1 + (r + 1) * ROW + c, rows 0..TH
    # and columns 0..TW + 1 the flushed box
    gtile = np.zeros((1 + (TH + 2) * ROW, D), f32)

    assert n <= BWD_CHUNK
    rec = records[first:first + n * stride:stride]
    idx = index[first:first + n * stride:stride]
    assert np.array_equal(rec[:, 0].astype(np.int64), idx)
    band = np.maximum(np.floor(rec[:, 2]).astype(np.int64) - y_org, 0)
    assert band.max(initial=0) < TH
    order = np.argsort(band, kind="stable")                    # the counting sort by band
    band_start = np.concatenate([[0], np.cumsum(np.bincount(band, minlength=TH))])
    words, banks = {}, []
    pair = fast_div(idx, make_div(lp))                         # the cotangent row of each record
    for phase in range(2):
        for warp in range(WARPS):
            bd = 2 * warp + phase
            mine = order[band_start[bd]:band_start[bd + 1]]
            n_it = -(-len(mine) // SLOTS)
            live = np.arange(n_it * SLOTS) < len(mine)
            sel = np.where(live, np.pad(mine, (0, n_it * SLOTS - len(mine))), 0)
            # a dead lane's sample: weight 0 at the band's first row, column 0
            xs = np.where(live, rec[sel, 1], f32(x_org))
            ys = np.where(live, rec[sel, 2], f32(y_org + bd))
            a = np.where(live, rec[sel, 3], f32(0))
            xf, yf = np.floor(xs), np.floor(ys)
            x0, y0 = xf.astype(np.int64), yf.astype(np.int64)
            lx, ly = (xs - xf).astype(f32), (ys - yf).astype(f32)
            one = f32(1)
            ok = np.stack([(y0 >= 0) & (x0 >= 0), (y0 >= 0) & (x0 + 1 < w),
                           (y0 + 1 < h) & (x0 >= 0), (y0 + 1 < h) & (x0 + 1 < w)], -1) & live[:, None]
            # the corners' tile rows and columns, and their pixel in both tiles:
            # the first's, then +1, +ROW, +ROW + 1 (a corner off the map adds 0)
            ty_ = (y0 - y_org)[:, None] + np.array([0, 0, 1, 1])
            tx_ = (x0 - x_org)[:, None] + np.array([0, 1, 0, 1])
            pix = 1 + (ty_ + 1) * ROW + tx_                                  # (n, 4)
            assert (tx_ >= -1).all() and (tx_ <= TW).all()
            assert np.isin(ty_, [bd, bd + 1] + ([-1] if bd == 0 else [])).all()    # own rows
            assert (tx_ >= 0).all() or x_org == 0            # column -1: the first tile column
            cw = np.stack([(one - ly) * (one - lx), (one - ly) * lx, ly * (one - lx), ly * lx],
                          -1).astype(f32)
            k = idx[sel]
            go = gout.reshape(-1, D)[pair[sel]]
            vals = vtile[pix]                                               # (n, 4, D)
            sc = np.where(ok, (vals * go[:, None, :]).sum(-1), f32(0)).astype(f32)
            gx = (one - ly) * (sc[:, 1] - sc[:, 0]) + ly * (sc[:, 3] - sc[:, 2])
            gy = (one - lx) * (sc[:, 2] - sc[:, 0]) + lx * (sc[:, 3] - sc[:, 1])
            kl = k[live]
            slots = first + order[band_start[bd]:band_start[bd + 1]] * stride   # record places
            out[slots] = np.stack([kl.astype(f32), (cw * sc).sum(-1)[live],
                                   (a * f32(w) * gx)[live], (a * f32(h) * gy)[live]], -1)
            seen[kl] += 1
            add = np.where(ok, a[:, None] * cw, f32(0))[..., None] * go[:, None, :]   # (n, 4, D)
            np.add.at(gtile, pix.ravel(), add.reshape(-1, D))
            # the lanes' words at each step: slot = sample % 8, channel octet j,
            # add i, then corner c: channel 8j + (i + slot) % 8
            slot = np.arange(n_it * SLOTS) % SLOTS
            j, i = np.arange(LANES), np.arange(8)
            chan = 8 * j[None, None, :] + (i[None, :, None] + slot[:, None, None]) % 8  # (n, 8, 4)
            word = pix[:, None, :, None] * D + chan[:, :, None, :]              # (n, 8i, 4c, 4j)
            step = word.reshape(n_it, SLOTS, 8, 4, LANES).transpose(0, 2, 3, 1, 4).reshape(
                n_it * 32, 32)
            banks.append(step % 32)
            assert (np.sort(step, -1)[:, 1:] != np.sort(step, -1)[:, :-1]).all()
            words[(phase, warp)] = np.unique(word)
    flushed = gtile[1 + ROW:].reshape(TH + 1, ROW, D)              # rows 0..TH, columns 0..TW + 1
    assert not gtile[:1 + ROW].any() and not flushed[:, TW + 1].any()      # row and column -1: zeros
    grad_map = grad[bi, lstart:lstart + h * w, mi].reshape(h, w, D)
    rows, cols = min(TH + 1, h - y_org), min(ROW, w - x_org)               # the box inside the map
    grad_map[y_org:y_org + rows, x_org:x_org + cols] += flushed[:rows, :cols]
    return words, (np.concatenate(banks) if banks else np.zeros((0, 32), np.int64))


def replay(value, levels, loc, attw, gout):
    """The binned design end to end: (grad value, grad loc, grad weights, facts)."""
    b, s, m, d = value.shape
    q, n_levels, p = loc.shape[1], loc.shape[3], loc.shape[4]
    assert d == D
    plan = binned_plan(levels, b, m, q, p)
    bins, x, y = sample_bins(loc, levels, plan)
    counts = bin_count(bins, plan)
    start, chunks = bin_scan(counts)
    index, records, inv = bin_scatter(bins, x, y, attw.ravel(), start)
    assert len(chunks) <= plan.max_chunks
    grad = np.zeros((b, s, m, d), f32)
    out = np.full_like(records, np.nan)
    seen = np.zeros(bins.size, np.int64)
    facts = {"counts": counts, "chunks": chunks, "bins": bins, "seen": seen, "banks": []}
    for chunk in chunks:
        words, banks = accumulate(chunk, index, records, value, gout, levels, n_levels * p, plan,
                                  grad, out, seen)
        for phase in range(2):
            touched = [words[(phase, wp)] for wp in range(WARPS) if (phase, wp) in words]
            allw = np.concatenate(touched) if touched else np.zeros(0, np.int64)
            assert len(np.unique(allw)) == len(allw), "two warps of a phase share a word"
        facts["banks"].append(banks)
    # unpermute: each sample's gradients from its record's place, zeros for none
    taken = np.where(inv[:, None] >= 0, out[np.maximum(inv, 0)], f32(0))
    assert np.array_equal(taken[inv >= 0, 0].astype(np.int64), np.flatnonzero(inv >= 0))
    gl, ga = taken[:, 2:], taken[:, 1]
    return grad, gl.reshape(loc.shape), ga.reshape(attw.shape), facts


LEVELS = ((20, 35), (9, 17), (4, 5))            # tiles 2 x 3, 1 x 2, 1 x 1: partial tiles


def make_inputs(levels, b=2, q=77, m=2, p=4, seed=0):
    """Uniform locations over [-0.15, 1.15] (samples off the map, y0 or x0 =
    -1), and planted ones: on a tile's first and last pixel columns and rows,
    straddling two tiles, at -1, fully off the map; head 1 at the first level
    kept left of x = 0.4 (its last tile column's bins stay empty)."""
    r = np.random.RandomState(seed)
    s = sum(h * w for h, w in levels)
    value = r.randn(b, s, m, D).astype(f32)
    loc = r.uniform(-0.15, 1.15, (b, q, m, len(levels), p, 2)).astype(f32)
    h0, w0 = levels[0]
    px = np.array([15.3, 16.2, 15.9, -0.6, 31.5, 0.1, w0 - 0.7, -1.8, 40.0], f32)
    py = np.array([7.2, 15.4, 16.6, 4.0, -0.5, 15.999, h0 - 0.3, 3.0, -5.0], f32)
    loc[0, :len(px), 0, 0, 0, 0] = (px + 0.5) / w0
    loc[0, :len(py), 0, 0, 0, 1] = (py + 0.5) / h0
    loc[:, :, 1, 0, :, 0] = r.uniform(0.0, 0.4, loc[:, :, 1, 0, :, 0].shape)
    attw = r.uniform(0, 1, (b, q, m, len(levels), p)).astype(f32)
    attw /= attw.sum(axis=(-1, -2), keepdims=True)
    gout = r.randn(b, q, m * D).astype(f32)
    return value, loc, attw, gout


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def plain(value, levels, loc, attw, gout):
    return [t.numpy() for t in ms_deform_attn_backward_plain(
        torch.from_numpy(value), levels, torch.from_numpy(loc), torch.from_numpy(attw),
        torch.from_numpy(gout))]


@pytest.fixture(scope="module")
def largest_first():
    value, loc, attw, gout = make_inputs(LEVELS)
    return (value, loc, attw, gout), replay(value, LEVELS, loc, attw, gout)


def test_replay_matches_jax_and_plain_f32(largest_first):
    """The binned design's three gradients equal JAX's _msda_train_bwd and the
    plain version's autograd in f32 (1e-5 relative norm)."""
    from hipie_tpu.ops.ms_deform_attn import ms_deform_attn_train

    (value, loc, attw, gout), (gv, gl, ga, _) = largest_first
    _, vjp = jax.vjp(lambda v, l, a: ms_deform_attn_train(v, LEVELS, l, a, "flat"),
                     jnp.asarray(value), jnp.asarray(loc), jnp.asarray(attw))
    want = vjp(jnp.asarray(gout))
    for name, g, j, pl in zip(("value", "loc", "weights"), (gv, gl, ga), want,
                              plain(value, LEVELS, loc, attw, gout)):
        assert np.isfinite(g).all(), name
        assert rel(g, j) <= 1e-5, name
        assert rel(g, pl) <= 1e-5, name


def test_every_sample_once_and_edge_cases(largest_first):
    """The chunks of each bin add each of its samples once; every sample in a
    bin is taken, and one in no bin (all corners off the map) is not; the
    planted cases land where the design says; an empty bin makes no chunk."""
    (value, loc, attw, gout), (_, _, _, facts) = largest_first
    bins, counts, chunks, seen = facts["bins"], facts["counts"], facts["chunks"], facts["seen"]
    assert np.array_equal(seen, (bins >= 0).astype(np.int64))
    for bin_ in range(len(counts)):
        mine = chunks[chunks[:, 0] == bin_]
        assert mine[:, 2].sum() == counts[bin_]
        assert len(mine) == -(-counts[bin_] // BWD_CHUNK) and (mine[:, 3] == len(mine)).all()
    assert (counts == 0).any() and not np.isin(np.flatnonzero(counts == 0), chunks[:, 0]).any()
    plan = binned_plan(LEVELS, 2, 2, 77, 4)
    k = lambda qi: np.ravel_multi_index((0, qi, 0, 0, 0), loc.shape[:5])
    tile = lambda ty, tx: ty * plan.tiles_x[0] + tx                    # b = 0, m = 0, level 0
    assert [bins[k(i)] for i in range(9)] == [
        tile(0, 0),      # x0 = 15: straddles tiles 0 and 1, in tile 0
        tile(0, 1),      # x0 = 16, y0 = 15: the tile's first column, last row
        tile(1, 0),      # y0 = 16: the next tile row's first
        tile(0, 0),      # x0 = -1: tile column 0, its left corner off the map
        tile(0, 1),      # y0 = -1: tile row 0, its upper corner off the map
        tile(0, 0),      # y = 15.999: the last row of tile row 0
        tile(1, 2),      # the last pixel: its right and lower corners off the map
        -1, -1]          # x0 = -2 and far outside: no bin


def test_warp_steps_conflict_free(largest_first):
    """A warp's shared adds: each step's 32 lanes on 32 distinct banks."""
    banks = np.concatenate([b for b in largest_first[1][3]["banks"] if len(b)])
    assert len(banks) and (np.sort(banks, -1) == np.arange(32)).all()


def test_overfull_bin_and_levels_smallest_first():
    """Levels smallest first (MaskDINO's order) with Q != S, and one head's
    samples of the largest level all in one tile: 4800 samples, two chunks."""
    levels = LEVELS[::-1]
    value, loc, attw, gout = make_inputs(levels, b=1, q=600, m=2, p=8, seed=1)
    h, w = levels[-1]
    loc[0, :, 0, -1, :, 0] = np.random.RandomState(2).uniform(0.5, 14.5, (600, 8)) / w
    loc[0, :, 0, -1, :, 1] = np.random.RandomState(3).uniform(0.5, 14.5, (600, 8)) / h
    gv, gl, ga, facts = replay(value, levels, loc, attw, gout)
    plan = binned_plan(levels, 1, 2, 600, 8)
    full = plan.tile_base[len(levels) - 1]                    # b = 0, m = 0, its first tile
    assert facts["counts"][full] == 4800
    assert (facts["chunks"][:, 0] == full).sum() == 2
    assert np.array_equal(facts["seen"], (facts["bins"] >= 0).astype(np.int64))
    for name, g, pl in zip(("value", "loc", "weights"), (gv, gl, ga),
                           plain(value, levels, loc, attw, gout)):
        assert rel(g, pl) <= 1e-5, name


def test_fast_division_is_exact():
    """The C entry's multiply-shift divisions by L*P, P, M and Q*M."""
    n = np.concatenate([np.arange(200000), np.random.RandomState(0).randint(0, 2 ** 31 - 1,
                                                                             200000)])
    for d in (1, 2, 3, 4, 5, 7, 8, 16, 24, 32, 300 * 8, 500 * 8, 1110 * 8, 21760 * 8, 20197 * 8,
              2 ** 20 + 1, 2 ** 31 - 1):
        assert np.array_equal(fast_div(n, make_div(d)), n // d), d


def test_plan_and_rule_of_the_training_shapes():
    """binned_plan at the training encoder (B = 2, M = 8, ViT-H levels): 64 +
    16 + 4 + 1 tiles a (b, m), 1360 bins; the rule takes the binned design
    there, and the atomics one at the decoder's and MaskDINO's shapes (under
    1024 samples a bin), for other head dims, unaligned rows, over 4 levels
    or more bins than bin_scatter's shared memory holds."""
    vith = ((128, 128), (64, 64), (32, 32), (16, 16))
    plan = binned_plan(vith, 2, 8, 21760, 4)
    assert plan.tile_base == (0, 64, 80, 84, 85) and plan.tiles_x == (8, 4, 2, 1)
    assert plan.n_bins == 1360 and plan.samples == 5570560
    assert plan.max_chunks == 5570560 // BWD_CHUNK + 1360
    assert bwd_design_rule(vith, 2, 8, 32, 21760, 4) == "binned"
    assert bwd_design_rule(vith, 2, 8, 16, 21760, 4) == "atomics"
    assert bwd_design_rule(vith, 2, 8, 32, 21760, 4, aligned=False) == "atomics"
    assert bwd_design_rule(vith, 2, 8, 32, 1110, 4) == "atomics"          # 209 samples a bin
    assert bwd_design_rule(vith[::-1], 2, 8, 32, 500, 4) == "atomics"     # 94 a bin
    assert bwd_design_rule(vith + ((8, 8),), 2, 8, 32, 21760, 4, 2) == "atomics"
    assert binned_plan(((1024, 1024),), 2, 8, 10, 4) is None            # 65536 bins
    assert binned_plan(((272, 320),), 2, 8, 10, 4) is None              # 5440 bins
    assert binned_plan(((256, 320),), 2, 8, 10, 4).n_bins == BWD_MAX_BINS == 5120
    # bin_scatter at the most bins: its staged records and places (20 bytes a
    # sample), three ints a bin, warp_sum, within the 227 KB a block may take
    block = BWD_SCATTER_THREADS * BWD_SCATTER_PER_THREAD
    assert block * 20 + 12 * BWD_MAX_BINS + 4 * (BWD_SCATTER_THREADS // 32) + 128 <= 227 * 1024
