"""Multi-scale deformable attention: forward kernel K-B (and the ``flat4`` path
on K-C) and backward kernel K-D.

Counterpart of hipie_tpu/ops/ms_deform_attn.py::ms_deform_attn_jnp and, for
training, ``ms_deform_attn_train`` with its hand-written backward
``_msda_train_bwd``, with the semantics of the reference CUDA op: bilinear
sampling with ``align_corners=False`` and zero padding, weighted over levels and
points. ``ms_deform_attn`` takes a CPU tensor to the plain version (whose
gradient is ``F.grid_sample``'s autograd) and a CUDA tensor to the hand-written
kernels: the forward in ``hipie_torch/csrc/ms_deform_attn.cu`` and, where a
gradient is wanted, the backward in ``hipie_torch/csrc/ms_deform_attn_bwd.cu``
behind a ``torch.autograd.Function``; there is no fallback between the two.
The backward has two designs, chosen by shape in its C entry point
(``ms_deform_attn_bwd_design``): "binned" (samples sorted by destination tile,
the value gradient accumulated in shared memory) and "atomics" (the value
gradient added in L2 by atomics).
``method="flat4"`` instead runs the JAX package's ``flat4`` formulation, whose
segment reduce is kernel K-C (``hipie_torch/ops/msda_reduce.py``); in training
its backward is K-D too, as JAX's ``ms_deform_attn_train`` gives every method
one backward.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from hipie_torch import kernels
from hipie_torch.ops.msda_reduce import msda_weighted_segment_sum

Shapes = Tuple[Tuple[int, int], ...]


def ms_deform_attn_plain(value, spatial_shapes: Shapes, sampling_locations,
                         attention_weights) -> torch.Tensor:
    """Per-level ``F.grid_sample``, as the reference's ms_deform_attn_core_pytorch.

    value (B, S, M, D); sampling_locations (B, Q, M, L, P, 2) in [0, 1];
    attention_weights (B, Q, M, L, P). Samples in f32 whatever the value dtype
    and returns (B, Q, M*D) in the value's dtype.
    """
    b, s, m, d = value.shape
    _, q, _, n_levels, p, _ = sampling_locations.shape
    if sum(h * w for h, w in spatial_shapes) != s:
        raise ValueError(f"spatial shapes {spatial_shapes} do not sum to S={s}")
    grids = 2.0 * sampling_locations.float() - 1.0
    v_levels = value.float().split([h * w for h, w in spatial_shapes], dim=1)
    sampled = []
    for lvl, (h, w) in enumerate(spatial_shapes):
        v_l = v_levels[lvl].permute(0, 2, 3, 1).reshape(b * m, d, h, w)
        g_l = grids[:, :, :, lvl].transpose(1, 2).reshape(b * m, q, p, 2)
        sampled.append(F.grid_sample(v_l, g_l, mode="bilinear", padding_mode="zeros",
                                     align_corners=False))          # (B*M, D, Q, P)
    attw = attention_weights.float().transpose(1, 2).reshape(b * m, 1, q, n_levels * p)
    out = (torch.stack(sampled, dim=-2).flatten(-2) * attw).sum(-1)  # (B*M, D, Q)
    return out.reshape(b, m * d, q).transpose(1, 2).to(value.dtype)


_LEVEL_TABLES: Dict[Tuple[Shapes, torch.device], Tuple[torch.Tensor, torch.Tensor]] = {}


def _level_tables(spatial_shapes: Shapes, device: torch.device):
    """(L, 2) int32 shapes and (L,) int32 level starts on the device, cached."""
    key = (tuple(spatial_shapes), device)
    if key not in _LEVEL_TABLES:
        sizes = [h * w for h, w in spatial_shapes]
        starts = [sum(sizes[:i]) for i in range(len(sizes))]
        _LEVEL_TABLES[key] = (
            torch.tensor(spatial_shapes, dtype=torch.int32, device=device).contiguous(),
            torch.tensor(starts, dtype=torch.int32, device=device))
    return _LEVEL_TABLES[key]


def ms_deform_attn_flat4(value, spatial_shapes: Shapes, sampling_locations,
                         attention_weights) -> torch.Tensor:
    """The ``flat4`` formulation around kernel K-C (JAX ``_flat_quad_attn_v4``).

    Per level, a quad table holds each cell's four bilinear corners side by side,
    (B, M, (H+1)(W+1), 4D) with a one-cell zero ring, so a sample is one row of
    it. Rows are gathered in (b, q, m, l, p) order, weighted per corner by the
    bilinear weight times the attention weight (cast to the table dtype, as
    JAX does) and summed over the K = L*P samples of each (b, q, m) by
    ``msda_weighted_segment_sum``; the corners are folded last. The table dtype
    is the value's: bf16 is JAX's ``flat4_bf16``, f32 its ``flat4``. Returns
    (B, Q, M*D) in the value's dtype.
    """
    b, s, m, d = value.shape
    _, q, _, n_levels, p, _ = sampling_locations.shape
    if sum(h * w for h, w in spatial_shapes) != s:
        raise ValueError(f"spatial shapes {spatial_shapes} do not sum to S={s}")
    loc = sampling_locations.float()
    weights = attention_weights.float()
    value_t = value.permute(0, 2, 1, 3)                                 # (B, M, S, D)
    tables, idx_parts, cw_parts = [], [], []
    start = row_off = 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        vp = F.pad(value_t[:, :, start:start + h * w].reshape(b, m, h, w, d), (0, 0, 1, 1, 1, 1))
        quad = torch.cat([vp[:, :, :-1, :-1], vp[:, :, :-1, 1:],
                          vp[:, :, 1:, :-1], vp[:, :, 1:, 1:]], dim=-1)
        tables.append(quad.reshape(b, m, (h + 1) * (w + 1), 4 * d))
        x = loc[:, :, :, lvl, :, 0] * w - 0.5                            # (B, Q, M, P)
        y = loc[:, :, :, lvl, :, 1] * h - 0.5
        x0, y0 = x.floor(), y.floor()
        lx, ly = x - x0, y - y0
        x0i, y0i = x0.int(), y0.int()
        in_range = (x0i >= -1) & (x0i <= w - 1) & (y0i >= -1) & (y0i <= h - 1)
        idx_parts.append((y0i.clamp(-1, h - 1) + 1) * (w + 1) + (x0i.clamp(-1, w - 1) + 1)
                         + row_off)
        cw = torch.stack([(1 - ly) * (1 - lx), (1 - ly) * lx, ly * (1 - lx), ly * lx], dim=-1)
        cw_parts.append(cw * (in_range.float() * weights[:, :, :, lvl])[..., None])
        start += h * w
        row_off += (h + 1) * (w + 1)
    table = torch.cat(tables, dim=2)                                    # (B, M, R, 4D)
    r = table.shape[2]
    k = n_levels * p
    n_rows = b * q * m * k
    off = (torch.arange(b * m, device=value.device) * r).reshape(b, 1, m, 1, 1)
    flat_idx = (torch.stack(idx_parts, dim=3).long() + off).reshape(n_rows)
    cw = torch.stack(cw_parts, dim=3).reshape(n_rows, 4).to(table.dtype)
    g = table.reshape(b * m * r, 4 * d).index_select(0, flat_idx)
    seg = msda_weighted_segment_sum(g, cw, k)                            # (B*Q*M, 4D) f32
    return seg.reshape(b, q, m, 4, d).sum(3).reshape(b, q, m * d).to(value.dtype)


MSDA_METHODS = ("fused", "flat4")

# K-B's constants: threads a block, samples a table fill, samples a gather
# batch, most pairs a block (kThreads, kChunk, kBatch, kMaxPairs in
# csrc/ms_deform_attn.cu; kernel_constants() reads the built kernel's, and
# chip_smoke.py and the card tests hold the two equal).
BLOCK_THREADS, TABLE_CHUNK, GATHER_BATCH, MAX_PAIRS = 256, 16, 4, 64
# Below this many threads in a G = 1 grid (pairs x threads across a row), 96
# blocks for the H100's 132 SMs, each pair's samples split over 4 groups: split,
# f32 at Q = 300 (75 blocks) runs faster and bf16 at Q = 910 (114) slower.
SPLIT_BELOW = 96 * 256


def kernel_constants() -> Tuple[int, int, int, int]:
    """The built K-B's (kThreads, kChunk, kBatch, kMaxPairs). Needs nvcc."""
    from hipie_torch.kernels import build

    out = torch.zeros(4, dtype=torch.int32)
    build.check(build.load().hipie_ms_deform_attn_constants(out.data_ptr()),
                "ms_deform_attn constants")
    return tuple(out.tolist())


class KernelPlan(NamedTuple):
    """How K-B maps a launch onto threads (checked again by its C entry)."""

    vec_bytes: int       # bytes a thread loads at once from a head row: 16, 8, 4 or 2
    chunks: int          # such vectors in a head row: D * itemsize / vec_bytes
    chunk_threads: int   # threads across a row's vectors, a power of two <= 32
    groups: int          # thread groups a pair's samples split over (1 or 4)

    @property
    def pairs_per_block(self) -> int:
        return BLOCK_THREADS // (self.chunk_threads * self.groups)

    @property
    def chunk_iters(self) -> int:
        return -(-self.chunks // self.chunk_threads)


def kernel_plan(d: int, itemsize: int, pairs: int, align: int = 16,
                groups: Optional[int] = None) -> KernelPlan:
    """K-B's plan for head dim ``d`` of ``itemsize``-byte values and ``pairs``
    (b, q, m) pairs, with value rows aligned to ``align`` bytes. The widest
    vector that divides the row and its alignment; as many threads across a
    row as it has vectors, up to 32; ``groups`` 4 where the grid is small or a
    row has under 4 vectors (a pair then still has 4 threads or more), else 1."""
    row = d * itemsize
    vec = next(v for v in (16, 8, 4, 2) if v >= itemsize and row % v == 0 and align % v == 0)
    chunks = row // vec
    ct = min(32, 1 << (chunks - 1).bit_length())
    if groups is None:
        groups = 4 if ct < 4 or (ct <= 8 and pairs * ct < SPLIT_BELOW) else 1
    if groups not in (1, 4) or not BLOCK_THREADS // MAX_PAIRS <= ct * groups <= 32:
        raise ValueError(f"ms_deform_attn: {groups} sample groups of {ct} threads is not a "
                         "plan: a pair takes 4 to 32 threads")
    return KernelPlan(vec, chunks, ct, groups)


def ms_deform_attn(value, spatial_shapes: Sequence[Tuple[int, int]],
                   sampling_locations, attention_weights, method: str = "fused") -> torch.Tensor:
    """(B, S, M, D) values sampled at (B, Q, M, L, P, 2) -> (B, Q, M*D).

    ``method`` "fused" runs kernel K-B (the plain ``grid_sample`` version on a
    CPU tensor); "flat4" runs ``ms_deform_attn_flat4``, whose reduce is kernel
    K-C on a CUDA tensor. On a CUDA tensor with autograd recording and an input
    that requires a gradient, the call goes through ``MSDeformAttnFunction``,
    whose backward is kernel K-D; otherwise it does no more than the forward.
    """
    spatial_shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    if method not in MSDA_METHODS:
        raise ValueError(f"ms_deform_attn: method must be one of {MSDA_METHODS}, got {method!r}")
    if value.device.type == "cpu":
        if method == "flat4":
            return ms_deform_attn_flat4(value, spatial_shapes, sampling_locations,
                                        attention_weights)
        return ms_deform_attn_plain(value, spatial_shapes, sampling_locations,
                                    attention_weights)
    if value.device.type != "cuda":
        raise ValueError(f"ms_deform_attn: unsupported device {value.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (value, sampling_locations, attention_weights)):
        return MSDeformAttnFunction.apply(value, sampling_locations, attention_weights,
                                          spatial_shapes, method)
    return _forward(value, spatial_shapes, sampling_locations, attention_weights, method)


def _forward(value, spatial_shapes: Shapes, sampling_locations, attention_weights,
             method: str) -> torch.Tensor:
    """K-B (fused) or the flat4 formulation on K-C, on CUDA inputs."""
    if method == "flat4":
        return ms_deform_attn_flat4(value, spatial_shapes, sampling_locations, attention_weights)
    _check_inputs(value, spatial_shapes, sampling_locations, attention_weights)
    b, s, m, d = value.shape
    q = sampling_locations.shape[1]
    plan = kernel_plan(d, value.element_size(), b * q * m, value.data_ptr() & -value.data_ptr())
    return _launch(value, spatial_shapes, sampling_locations, attention_weights, plan)


def _check_inputs(value, spatial_shapes: Shapes, sampling_locations, attention_weights):
    """What K-B and K-D take: bf16 or f32 contiguous values with head dim <= 128,
    f32 contiguous locations and weights of matching shapes, on one device."""
    b, s, m, d = value.shape
    q, n_levels, p = sampling_locations.shape[1], len(spatial_shapes), sampling_locations.shape[4]
    if value.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"ms_deform_attn: value must be bf16 or f32, got {value.dtype}")
    if not value.is_contiguous():
        raise ValueError("ms_deform_attn: value must be contiguous")
    if sum(h * w for h, w in spatial_shapes) != s:
        raise ValueError(f"ms_deform_attn: spatial shapes {spatial_shapes} do not sum to S={s}")
    if not 0 < d <= 128:
        raise ValueError(f"ms_deform_attn: head dim {d} outside 1..128")
    for name, t, shape in (("sampling_locations", sampling_locations, (b, q, m, n_levels, p, 2)),
                           ("attention_weights", attention_weights, (b, q, m, n_levels, p))):
        if t.device != value.device or t.dtype != torch.float32:
            raise ValueError(f"ms_deform_attn: {name} must be f32 on {value.device}, "
                             f"got {t.dtype} on {t.device}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"ms_deform_attn: {name} must be contiguous {shape}, "
                             f"got {tuple(t.shape)}")


class MSDeformAttnFunction(torch.autograd.Function):
    """MSDA with K-B (or flat4 on K-C) forward and K-D backward, on CUDA tensors.

    Saves the value, locations and weights; the backward gives the gradients of
    all three (the value's in its dtype, cast once from K-D's f32 buffer)."""

    @staticmethod
    def forward(ctx, value, sampling_locations, attention_weights, spatial_shapes, method):
        ctx.spatial_shapes = spatial_shapes
        ctx.save_for_backward(value, sampling_locations, attention_weights)
        return _forward(value, spatial_shapes, sampling_locations, attention_weights, method)

    @staticmethod
    def backward(ctx, grad_out):
        value, loc, attw = ctx.saved_tensors
        gv, gl, gw = ms_deform_attn_backward(value, ctx.spatial_shapes, loc, attw, grad_out)
        return gv, gl, gw, None, None


def ms_deform_attn_backward_plain(value, spatial_shapes: Shapes, sampling_locations,
                                  attention_weights, grad_out):
    """The gradients of ``ms_deform_attn_plain`` (``F.grid_sample``'s autograd)
    for the output cotangent ``grad_out`` (B, Q, M*D): (grad value in the
    value's dtype, grad locations f32, grad weights f32). K-D's reference."""
    with torch.enable_grad():
        v = value.detach().requires_grad_(True)
        loc = sampling_locations.detach().float().requires_grad_(True)
        w = attention_weights.detach().float().requires_grad_(True)
        out = ms_deform_attn_plain(v, spatial_shapes, loc, w)
        return torch.autograd.grad(out, (v, loc, w), grad_out.to(out.dtype))


def backward_plan(d: int, itemsize: int, align: int) -> Tuple[int, int]:
    """K-D's atomics design: (channels a thread owns, threads per pair) for head
    dim ``d`` of ``itemsize``-byte values whose rows and gradient rows are
    ``align``-byte aligned: 4 channels where the row allows it, else 1; as many
    threads as the row has such vectors, a power of two up to 32 (a thread then
    holds up to 4 vectors)."""
    vc = 4 if d % 4 == 0 and align % (4 * itemsize) == 0 else 1
    vecs = d // vc
    return vc, min(32, 1 << (vecs - 1).bit_length())


# K-D's binned design (csrc/ms_deform_attn_bwd.cu): copies of its constants
# (kBinThreads, kBinPerThread, kScanThreads, kScatterThreads,
# kScatterPerThread, kMaxBins, kAccThreads, kChunk, kMaxLevels, kBinD, kTileH,
# kTileW, kMinSamplesPerBin), for the CPU replay
# (tests/test_torch_msda_bwd_tiles.py); bwd_constants() reads the built
# kernel's, and the card tests hold the two equal.
BWD_BIN_THREADS, BWD_BIN_PER_THREAD, BWD_SCAN_THREADS = 1024, 4, 1024
BWD_SCATTER_THREADS, BWD_SCATTER_PER_THREAD = 1024, 8
BWD_MAX_BINS, BWD_ACC_THREADS, BWD_CHUNK, BWD_MAX_LEVELS, BWD_BIN_D = 5120, 256, 4096, 4, 32
BWD_TILE_H, BWD_TILE_W = 16, 16
BWD_MIN_SAMPLES_PER_BIN = 1024
BWD_CONSTANTS = (BWD_BIN_THREADS, BWD_BIN_PER_THREAD, BWD_SCAN_THREADS, BWD_SCATTER_THREADS,
                 BWD_SCATTER_PER_THREAD, BWD_MAX_BINS, BWD_ACC_THREADS, BWD_CHUNK, BWD_MAX_LEVELS,
                 BWD_BIN_D, BWD_TILE_H, BWD_TILE_W, BWD_MIN_SAMPLES_PER_BIN)
BWD_DESIGNS = ("atomics", "binned")     # as the C entry numbers them
# launches of each design, counted where the wrapper launches K-D
BWD_DESIGN_LAUNCHES = {name: 0 for name in BWD_DESIGNS}


def bwd_constants() -> Tuple[int, ...]:
    """The built K-D's binned-design constants, in BWD_*'s order. Needs nvcc."""
    from hipie_torch.kernels import build

    out = torch.zeros(len(BWD_CONSTANTS), dtype=torch.int32)
    build.check(build.load().hipie_ms_deform_attn_bwd_constants(out.data_ptr()),
                "ms_deform_attn_bwd constants")
    return tuple(out.tolist())


class BinnedPlan(NamedTuple):
    """How K-D's binned design lays out a launch: the CPU replay's copy of
    the C entry's bin_plan."""

    tile_h: int
    tile_w: int
    tile_base: Tuple[int, ...]   # a level's first tile within a (b, m); the last: tiles a (b, m)
    tiles_x: Tuple[int, ...]     # a level's tiles across
    n_bins: int                  # B * M * tiles
    samples: int                 # B * Q * M * L * P
    max_chunks: int              # the accumulate grid: samples // BWD_CHUNK + n_bins


def binned_plan(spatial_shapes: Shapes, b: int, m: int, q: int,
                n_points: int) -> Optional[BinnedPlan]:
    """K-D's binned layout for these levels and sizes, or None where the
    design cannot take them (more than BWD_MAX_LEVELS levels or BWD_MAX_BINS
    bins, or too many samples for int32 indices)."""
    n_levels = len(spatial_shapes)
    if not 1 <= n_levels <= BWD_MAX_LEVELS or min(b, m, q, n_points) <= 0:
        return None
    samples = b * q * m * n_levels * n_points
    if samples > (1 << 31) - 2 * BWD_SCATTER_THREADS * BWD_SCATTER_PER_THREAD:
        return None
    th, tw = BWD_TILE_H, BWD_TILE_W
    base, tiles_x, tiles = [], [], 0
    for h, w in spatial_shapes:
        if h <= 0 or w <= 0:
            return None
        base.append(tiles)
        tiles_x.append(-(-w // tw))
        tiles += -(-h // th) * tiles_x[-1]
    n_bins = b * m * tiles
    if n_bins > BWD_MAX_BINS:
        return None
    return BinnedPlan(th, tw, tuple(base) + (tiles,), tuple(tiles_x), n_bins, samples,
                      samples // BWD_CHUNK + n_bins)


def bwd_design_rule(spatial_shapes: Shapes, b: int, m: int, d: int, q: int, n_points: int,
                    aligned: bool = True) -> str:
    """The design K-D's C entry takes (the CPU replay's copy of its rule; the
    card tests hold the two equal): "binned" for head dim 32 with value and
    cotangent rows 16-byte aligned where binned_plan takes the shape and its
    bins get at least BWD_MIN_SAMPLES_PER_BIN samples on average, else
    "atomics"."""
    plan = binned_plan(spatial_shapes, b, m, q, n_points) if aligned else None
    if d != BWD_BIN_D or plan is None or plan.samples < BWD_MIN_SAMPLES_PER_BIN * plan.n_bins:
        return "atomics"
    return "binned"


_HOST_SHAPES: Dict[Shapes, torch.Tensor] = {}


def _host_shapes(spatial_shapes: Shapes) -> torch.Tensor:
    """(L, 2) int32 (H, W) on the host, cached: what K-D's C entry plans from."""
    if spatial_shapes not in _HOST_SHAPES:
        _HOST_SHAPES[spatial_shapes] = torch.tensor(spatial_shapes, dtype=torch.int32).contiguous()
    return _HOST_SHAPES[spatial_shapes]


def ms_deform_attn_bwd_design(spatial_shapes: Shapes, b: int, m: int, d: int, q: int,
                              n_points: int, aligned: bool = True) -> str:
    """The design K-D's C entry point takes at a shape ("binned" or
    "atomics"), from the built library's rule. Builds the kernels if needed."""
    from hipie_torch.kernels import build

    spatial_shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    design = build.load().hipie_ms_deform_attn_bwd_design(
        _host_shapes(spatial_shapes).data_ptr(), b, m, d, q, len(spatial_shapes), n_points,
        int(aligned))
    return BWD_DESIGNS[design]


def ms_deform_attn_backward(value, spatial_shapes: Shapes, sampling_locations,
                            attention_weights, grad_out):
    """Kernel K-D: the gradients of MSDA with respect to the value, the
    locations and the weights, for the output cotangent ``grad_out`` (B, Q, M*D),
    on CUDA tensors, on the design the C entry point's rule takes at the shape
    (``ms_deform_attn_bwd_design``). Returns (grad value in the value's dtype,
    grad locations f32, grad weights f32)."""
    return _ms_deform_attn_backward_design(value, spatial_shapes, sampling_locations,
                                           attention_weights, grad_out)[0]


def _ms_deform_attn_backward_design(value, spatial_shapes: Shapes, sampling_locations,
                                    attention_weights, grad_out, force_binned: bool = False):
    """K-D's launch: ((grad value, grad locations, grad weights), the design
    the C entry launched, the binned design's scratch or None). With
    ``force_binned`` the binned design at any shape it can take (a ValueError
    elsewhere), for the card tests and msda_bwd_bench.py; ``bwd_binned_stats``
    reads a launch's chunks and global adds from its scratch."""
    from hipie_torch.kernels import build

    if value.device.type != "cuda":
        raise ValueError(f"ms_deform_attn_backward: K-D runs on CUDA tensors, got {value.device}")
    spatial_shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    _check_inputs(value, spatial_shapes, sampling_locations, attention_weights)
    b, s, m, d = value.shape
    q, n_levels, p = sampling_locations.shape[1], len(spatial_shapes), sampling_locations.shape[4]
    if tuple(grad_out.shape) != (b, q, m * d):
        raise ValueError(f"ms_deform_attn_backward: grad_out must be {(b, q, m * d)}, "
                         f"got {tuple(grad_out.shape)}")
    gout = grad_out.to(value.dtype).contiguous()
    align = value.data_ptr() & -value.data_ptr()
    align = min(align, gout.data_ptr() & -gout.data_ptr())
    vc, tpp = backward_plan(d, value.element_size(), align)
    aligned = align >= 16 and sampling_locations.data_ptr() % 8 == 0
    lib = build.load()
    host_shapes = _host_shapes(spatial_shapes).data_ptr()
    nbytes = ctypes.c_longlong(0)
    if lib.hipie_ms_deform_attn_bwd_scratch_bytes(host_shapes, b, m, d, q, n_levels, p,
                                                  int(aligned), int(force_binned),
                                                  ctypes.addressof(nbytes)):
        raise ValueError(f"ms_deform_attn_backward: the binned design does not take levels "
                         f"{spatial_shapes} at B={b}, M={m}, D={d}, Q={q}, P={p}"
                         f"{'' if aligned else ', unaligned rows'}")
    shapes_t, starts_t = _level_tables(spatial_shapes, value.device)
    grad_value = torch.zeros((b, s, m, d), dtype=torch.float32, device=value.device)
    grad_loc = torch.empty_like(sampling_locations)
    grad_attw = torch.empty_like(attention_weights)
    scratch = (torch.empty(nbytes.value, dtype=torch.uint8, device=value.device)
               if nbytes.value else None)
    design = ctypes.c_int(-1)
    err = lib.hipie_ms_deform_attn_bwd(
        value.data_ptr(), shapes_t.data_ptr(), starts_t.data_ptr(),
        sampling_locations.data_ptr(), attention_weights.data_ptr(), gout.data_ptr(),
        grad_value.data_ptr(), grad_loc.data_ptr(), grad_attw.data_ptr(),
        b, s, m, d, q, n_levels, p, int(value.dtype == torch.bfloat16), vc, tpp,
        host_shapes, int(force_binned), None if scratch is None else scratch.data_ptr(),
        nbytes.value, ctypes.addressof(design), torch.cuda.current_stream(value.device).cuda_stream)
    build.check(err, "ms_deform_attn_backward")
    kernels.LAUNCHES["ms_deform_attn_bwd"] += 1
    BWD_DESIGN_LAUNCHES[BWD_DESIGNS[design.value]] += 1
    return ((grad_value.to(value.dtype), grad_loc, grad_attw), BWD_DESIGNS[design.value],
            scratch)


def bwd_binned_stats(scratch: torch.Tensor) -> Dict[str, int]:
    """A binned K-D launch's bins, chunks and global f32 adds (each chunk's
    flush box, its part past the map included), from the header the launch
    wrote at the head of its scratch. Waits for the launch."""
    n_chunks, n_bins, flush_words = scratch[:12].view(torch.int32).tolist()
    return {"n_bins": n_bins, "n_chunks": n_chunks, "global_adds": n_chunks * flush_words}


def _launch(value, spatial_shapes: Shapes, sampling_locations, attention_weights,
            plan: KernelPlan) -> torch.Tensor:
    """K-B on checked CUDA inputs with the given plan."""
    from hipie_torch.kernels import build

    b, s, m, d = value.shape
    q, p = sampling_locations.shape[1], sampling_locations.shape[4]
    lib = build.load()
    shapes_t, starts_t = _level_tables(spatial_shapes, value.device)
    out = torch.empty((b, q, m * d), dtype=value.dtype, device=value.device)
    err = lib.hipie_ms_deform_attn(
        value.data_ptr(), shapes_t.data_ptr(), starts_t.data_ptr(),
        sampling_locations.data_ptr(), attention_weights.data_ptr(), out.data_ptr(),
        b, s, m, d, q, len(spatial_shapes), p, int(value.dtype == torch.bfloat16),
        plan.vec_bytes, plan.chunk_threads, plan.groups,
        torch.cuda.current_stream(value.device).cuda_stream)
    build.check(err, "ms_deform_attn")
    kernels.LAUNCHES["ms_deform_attn"] += 1
    return out
