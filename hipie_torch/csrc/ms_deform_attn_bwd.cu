// Multi-scale deformable attention, backward (kernel K-D): the gradients of
// K-B's output with respect to the value map, the sampling locations and the
// attention weights.
//
// Replaces: hipie_tpu/ops/ms_deform_attn.py::_msda_train_bwd (the hand-written
// VJP of ms_deform_attn_train; an XLA corner regather plus one-hot matmul
// "splat" in JAX), with the semantics of the reference CUDA backward
// (ms_deform_im2col_cuda.cuh ms_deformable_col2im). For every (b, q, m), a
// "pair", and each of its L*P samples at pixel (x, y) = (loc_x * W_l - 0.5,
// loc_y * H_l - 0.5), with x0 = floor(x), lx = x - x0 (likewise y) and the
// corners c = (y0, x0), (y0, x0+1), (y0+1, x0), (y0+1, x0+1) of bilinear
// weights cw_c, zero outside the level:
//
//     s_c             = <V_l[b, row_c, m, :], gout[b, q, m, :]>   (0 off the map)
//     grad_attw       = sum_c cw_c s_c
//     grad_loc        = A * (W_l * sum_c a_c s_c, H_l * sum_c b_c s_c),
//                       a = (-(1-ly), 1-ly, -ly, ly), b = (-(1-lx), -lx, 1-lx, lx)
//     grad_value[row_c] += A * cw_c * gout[b, q, m, :]
//
// with A the sample's attention weight. value: (B, S, M, D) bf16 or f32; loc
// (B, Q, M, L, P, 2) f32; attw (B, Q, M, L, P) f32; gout (B, Q, M*D) in the
// value's dtype; shapes (L, 2) int32 (H, W); level_start (L,) int32. Outputs:
// grad_value (B, S, M, D) f32, zeroed by the caller, which casts it once to the
// value's dtype; grad_loc and grad_attw f32 in the shapes of loc and attw.
// Corner clamping and zeroing are K-B's (ms_deform_attn.cu): x and y clamped
// to [-2, W+1] and [-2, H+1] before the floor, so that the int conversion is
// defined, and each corner off the map contributes nothing. Main path
// (R50 and ViT-H training, B = 2, M = 8, D = 32, L = P = 4, bf16): the encoder
// at Q = S = 21760, the decoder at Q = 1110, MaskDINO's decoder at Q = 500; 21
// launches a step.
//
// What bounds it on the H100: the value gradient's scatter. At the encoder
// shape 5.57 M samples x 4 corners x 32 channels = 713 M f32 adds, against
// 200.5 MB of inputs and outputs in bf16 (0.060 ms at 3.35 TB/s). Two
// designs, chosen by shape in the C entry point
// (hipie_ms_deform_attn_bwd_design; the rule and the times it rests on at
// kMinSamplesPerBin):
//
// "atomics" (the first design). A group of threads per pair, each thread
// owning VC consecutive channels (4 where D and the row addresses allow it,
// else 1), adds A*cw_c*gout into the f32 gradient in global memory with one
// 16-byte vector atomic (atomicAdd on float4) per corner; the four corner dots
// meet by xor shuffles. Pairs go out in query order. Its adds resolve in L2
// at ~0.66 T adds/s: 1.08 ms at the encoder. It takes every head dim and
// alignment, and the small-Q shapes (decoder, MaskDINO), where the binned
// design's fixed cost does not pay.
//
// "binned" (D = 32, 16-byte aligned rows, up to 4 levels and kMaxBins bins,
// at least kMinSamplesPerBin samples a bin): the adds move from L2 into
// shared memory. A counting sort bins the samples by destination tile, a bin being
// (b, m, level, a 16 x 16 tile of the level) and a sample's tile the one
// that holds its top-left corner (y0, x0), with y0 = -1 (x0 = -1) counted in
// tile row (column) 0; a sample with all four corners off the map (x0 < -1 or
// x0 >= W or y0 < -1 or y0 >= H) is in no bin, and gets zero gradients.
//   bin_count: a per-block shared histogram of 4096 samples, merged into the
//     global counts with one atomic per nonzero bin;
//   bin_scan: one block scans the counts into each bin's list start and
//     splits each bin into ceil(n / kChunk) chunks, chunk j taking every
//     nch-th record from the j-th (each chunk a sample of the whole bin),
//     and writes the chunk count at the head of the scratch;
//   bin_scatter: each sample's 16-byte record (index, clamped x, y, attention
//     weight) into its bin's list and its place into inv, a block's 8192
//     records staged in shared memory so that they go out in runs;
//   accumulate: one block per chunk stages the tile's value rows with a ring
//     of one pixel (18 x 18 pixels of D values from (y_org - 1, x_org - 1))
//     by one 5-D TMA load ({D, M, W, H, B} with the pixel stride M*D; pixels
//     past the map read as zeros), zeroes an f32 gradient tile in shared
//     memory, sorts its records by band (tile row), and walks them 8 to a
//     warp, 4 lanes of 8 channels a sample: the corner dots from the staged
//     values, the three closed forms (written into the record's slot), and
//     A*cw_c*gout added into the shared tile. Shared f32 atomics are
//     compare-and-swap loops on sm_90 (ATOMS.CAST.SPIN in the SASS), so the
//     adds are plain loads and FMAs and stores under ownership: warp w takes
//     band 2w, then band 2w + 1, a band touching its own row and the next
//     only. The tile is flushed once by a TMA reduce-add
//     (cp.reduce.async.bulk.tensor .add.f32) into the zeroed gradient;
//   unpermute: each sample's location and weight gradients, in sample order,
//     from its record's slot through inv: the accumulate's own scattered 4-
//     and 8-byte stores of them took longer than the write-back and this
//     pass together.
// At the encoder the global adds fall from 713 M to (chunks x tile pixels x
// D), 19.4 M. What bounds it then: shared-memory bandwidth (each add a load
// and a store, 5.7 GB a launch at the encoder) and the binning's scattered
// record writes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;      // a block
constexpr int kMaxVecs = 4;        // channel vectors a thread holds (D <= 128)

template <typename T, int VC>
__device__ __forceinline__ void load_row(const T* p, float* f) {
  if constexpr (VC == 4 && std::is_same<T, float>::value) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  } else if constexpr (VC == 4) {                     // 4 bf16 = 8 bytes
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    f[0] = __uint_as_float(v.x << 16);
    f[1] = __uint_as_float(v.x & 0xffff0000u);
    f[2] = __uint_as_float(v.y << 16);
    f[3] = __uint_as_float(v.y & 0xffff0000u);
  } else if constexpr (std::is_same<T, float>::value) {
    f[0] = __ldg(p);
  } else {
    f[0] = __bfloat162float(p[0]);
  }
}

struct Params {
  const void* value;
  const int* shapes;
  const int* level_start;
  const float* loc;
  const float* attw;
  const void* gout;
  float* grad_value;
  float* grad_loc;
  float* grad_attw;
  int b, s, m, d, q, n_levels, n_points;
  int tpp;          // threads per pair: a power of two <= 32
  int vecs;         // channel vectors in a head row: D / VC
};

template <typename T, int VC>
__global__ void __launch_bounds__(kThreads) ms_deform_attn_bwd_kernel(const Params p) {
  const int tpp = p.tpp;
  const int lane = threadIdx.x % tpp;
  const long long pairs = (long long)p.b * p.q * p.m;
  const long long pair = (long long)blockIdx.x * (kThreads / tpp) + threadIdx.x / tpp;
  const bool live = pair < pairs;
  // dead pairs run the loop on a valid pair with nothing written, so that every
  // lane of a warp takes part in the shuffles
  const long long pc = live ? pair : pairs - 1;
  const long long bi = pc / ((long long)p.q * p.m);
  const int mi = (int)(pc % p.m);
  const int lp = p.n_levels * p.n_points;
  const long long row_stride = (long long)p.m * p.d;      // elements between positions
  const T* v_bm = static_cast<const T*>(p.value) + (bi * p.s * p.m + mi) * p.d;
  float* g_bm = p.grad_value + (bi * p.s * p.m + mi) * p.d;

  // this thread's channels of gout, held for every sample of the pair
  float go[kMaxVecs][VC];
  const T* gout = static_cast<const T*>(p.gout) + pc * p.d;
#pragma unroll
  for (int k = 0; k < kMaxVecs; ++k) {
    const int c = lane + k * tpp;
#pragma unroll
    for (int i = 0; i < VC; ++i) go[k][i] = 0.f;
    if (c < p.vecs) load_row<T, VC>(gout + c * VC, go[k]);
  }

  for (int sp = 0; sp < lp; ++sp) {
    const int l = sp / p.n_points;
    const int h = __ldg(p.shapes + 2 * l), w = __ldg(p.shapes + 2 * l + 1);
    const int start = __ldg(p.level_start + l);
    const long long k_s = pc * lp + sp;
    const float2 xy = __ldg(reinterpret_cast<const float2*>(p.loc) + k_s);
    const float a = __ldg(p.attw + k_s);
    const float x = fminf(fmaxf(xy.x * w - 0.5f, -2.f), (float)w + 1.f);
    const float y = fminf(fmaxf(xy.y * h - 0.5f, -2.f), (float)h + 1.f);
    const float xf = floorf(x), yf = floorf(y);
    const int x0 = (int)xf, y0 = (int)yf;
    const float lx = x - xf, ly = y - yf;
    const bool vx0 = x0 >= 0 && x0 < w, vx1 = x0 >= -1 && x0 < w - 1;
    const bool vy0 = y0 >= 0 && y0 < h, vy1 = y0 >= -1 && y0 < h - 1;
    const bool ok[4] = {vy0 && vx0, vy0 && vx1, vy1 && vx0, vy1 && vx1};
    const int rows[4] = {start + y0 * w + x0, start + y0 * w + x0 + 1,
                         start + (y0 + 1) * w + x0, start + (y0 + 1) * w + x0 + 1};
    const float cw[4] = {(1.f - ly) * (1.f - lx), (1.f - ly) * lx, ly * (1.f - lx), ly * lx};
    float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int c4 = 0; c4 < 4; ++c4) {
      if (!ok[c4]) continue;                           // uniform across the pair's threads
      const long long off = (long long)rows[c4] * row_stride;
      const float scale = a * cw[c4];
#pragma unroll
      for (int k = 0; k < kMaxVecs; ++k) {
        const int c = lane + k * tpp;
        if (c >= p.vecs) break;
        float v[VC], add[VC];
        load_row<T, VC>(v_bm + off + c * VC, v);
#pragma unroll
        for (int i = 0; i < VC; ++i) {
          s[c4] = fmaf(v[i], go[k][i], s[c4]);
          add[i] = scale * go[k][i];
        }
        if (!live) continue;
        float* dst = g_bm + off + c * VC;
        if constexpr (VC == 4) {
          atomicAdd(reinterpret_cast<float4*>(dst), make_float4(add[0], add[1], add[2], add[3]));
        } else {
#pragma unroll
          for (int i = 0; i < VC; ++i) atomicAdd(dst + i, add[i]);
        }
      }
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      if (off >= tpp) break;
#pragma unroll
      for (int c4 = 0; c4 < 4; ++c4) s[c4] += __shfl_xor_sync(0xffffffffu, s[c4], off);
    }
    if (live && lane == 0) {
      const float gw = cw[0] * s[0] + cw[1] * s[1] + cw[2] * s[2] + cw[3] * s[3];
      const float gx = (1.f - ly) * (s[1] - s[0]) + ly * (s[3] - s[2]);
      const float gy = (1.f - lx) * (s[2] - s[0]) + lx * (s[3] - s[1]);
      p.grad_attw[k_s] = gw;
      reinterpret_cast<float2*>(p.grad_loc)[k_s] = make_float2(a * w * gx, a * h * gy);
    }
  }
}

template <typename T, int VC>
cudaError_t launch(const Params& p, long long blocks, cudaStream_t st) {
  ms_deform_attn_bwd_kernel<T, VC><<<(unsigned)blocks, kThreads, 0, st>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The binned design.

constexpr int kBinD = 32;             // the head dim it takes
constexpr int kMaxLevels = 4;
constexpr int kBinThreads = 1024;     // a bin_count block
constexpr int kBinPerThread = 4;      // samples a thread bins
constexpr int kBinSamples = kBinThreads * kBinPerThread;   // 4096 a block
constexpr int kMaxBins = 5120;        // the shared histograms' entries (a multiple of 1024)
constexpr int kScanThreads = 1024;    // the one bin_scan block
constexpr int kScatterThreads = 1024;  // a bin_scatter block
constexpr int kScatterPerThread = 8;   // samples a bin_scatter thread places
constexpr int kScatterSamples = kScatterThreads * kScatterPerThread;   // 8192 a block
constexpr int kChunk = 4096;          // most samples a chunk
constexpr int kTileH = 16, kTileW = 16;   // a tile's rows and columns (both dtypes)
constexpr int kAccThreads = kTileH / 2 * 32;   // an accumulate block: a warp per two bands
// the f32 words a chunk's flush adds into the gradient: its box of (kTileH +
// 1) x (kTileW + 2) pixels of kBinD (BinSmem), the part past the map included
constexpr int kFlushWords = (kTileH + 1) * (kTileW + 2) * kBinD;
constexpr int kMaxSharedOptin = 227 * 1024;    // dynamic + static shared memory a block may take
// The design rule: the binned design where its bins get at least this many
// samples on average (samples >= kMinSamplesPerBin * bins), the atomics
// design below. Measured (msda_bwd_bench.py, NVIDIA H100 80GB HBM3, 700 W;
// B = 2, M = 8, L = P = 4, 1360 bins), binned against atomics in ms: the
// training encoder (Q = 21760, 4096 samples a bin) 0.727 / 1.070 in bf16,
// 0.715 / 1.120 with local locations, 0.835 / 1.200 in f32; the decoder
// (Q = 1110, 209 a bin) 0.160 / 0.123; MaskDINO's (Q = 500, 94 a bin) 0.146
// / 0.080. A line through the bf16 ones, binned ~0.13 ms a launch (the
// chunks' staging and flushes, the binning's fixed part) plus 0.11 us a
// thousand samples against the atomics' 0.19, crosses at ~1100 samples a bin.
constexpr int kMinSamplesPerBin = 1024;

// n / d for n < 2^31 by a multiply-high, an add and a shift (Granlund and
// Montgomery, with mul = floor(2^32 (2^shift - d) / d) + 1, 2^shift >= d).
struct FastDiv {
  uint32_t d, mul, shift;
  __device__ __forceinline__ uint32_t div(uint32_t n) const {
    return (__umulhi(n, mul) + n) >> shift;
  }
};

FastDiv make_div(uint32_t d) {
  FastDiv f{d, 0, 0};
  while ((1ull << f.shift) < d) ++f.shift;
  f.mul = static_cast<uint32_t>(((1ull << 32) * ((1ull << f.shift) - d)) / d + 1);
  return f;
}

struct Levels {
  int n;
  int h[kMaxLevels], w[kMaxLevels];
  int tile_base[kMaxLevels + 1];   // a level's first tile within a (b, m); [n]: tiles a (b, m)
  int tiles_x[kMaxLevels];         // a level's tiles across
};

struct BinParams {
  const float* loc;
  const float* attw;
  float* grad_loc;
  float* grad_attw;
  int* header;                     // (4,) chunks, bins, kFlushWords, 0: see bin_plan
  int* counts;                     // (bins,) samples a bin, zeroed first
  int* cursor;                     // (bins,) a bin's list start, then its next free slot
  int4* chunks;                    // (max chunks,) bin, first record, length, stride
  int4* records;                   // (samples,) index, x, y, A as bits, grouped by bin
  int* inv;                        // (samples,) each sample's record, -1 for none
  Levels lv;
  FastDiv lp_div, p_div, m_div, qm_div;   // by L*P, P, M and Q*M
  int m, samples, n_bins;
};

// The bin of sample k, or -1 where all four corners are off the map; x and
// y get its clamped pixel coordinates.
template <int TH, int TW>
__device__ __forceinline__ int sample_bin(const BinParams& p, uint32_t k, float& x, float& y) {
  const uint32_t pair = p.lp_div.div(k);
  const uint32_t l = p.p_div.div(k - pair * p.lp_div.d);
  const uint32_t mi = pair - p.m_div.div(pair) * p.m_div.d;
  const uint32_t bi = p.qm_div.div(pair);
  const int h = p.lv.h[l], w = p.lv.w[l];
  const float2 xy = __ldg(reinterpret_cast<const float2*>(p.loc) + k);
  x = fminf(fmaxf(xy.x * w - 0.5f, -2.f), (float)w + 1.f);
  y = fminf(fmaxf(xy.y * h - 0.5f, -2.f), (float)h + 1.f);
  const int x0 = (int)floorf(x), y0 = (int)floorf(y);
  if (x0 < -1 || x0 >= w || y0 < -1 || y0 >= h) return -1;
  return (int)(bi * p.m + mi) * p.lv.tile_base[p.lv.n] + p.lv.tile_base[l]
         + (max(y0, 0) / TH) * p.lv.tiles_x[l] + max(x0, 0) / TW;
}

// Pass 1: each bin's samples, by a shared histogram of the block's 4096 (4 a
// thread, their locations loaded together).
template <int TH, int TW>
__global__ void __launch_bounds__(kBinThreads)
ms_deform_attn_bwd_bin_count(const __grid_constant__ BinParams p) {
  constexpr int kPer = kBinSamples / kBinThreads;
  __shared__ int hist[kMaxBins];
  for (int i = threadIdx.x; i < p.n_bins; i += kBinThreads) hist[i] = 0;
  const int k0 = blockIdx.x * kBinSamples + threadIdx.x;
  int bins[kPer];
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int k = k0 + r * kBinThreads;
    float x, y;
    bins[r] = k < p.samples ? sample_bin<TH, TW>(p, k, x, y) : -1;
  }
  __syncthreads();                                 // the histogram zeroed
#pragma unroll
  for (int r = 0; r < kPer; ++r)
    if (bins[r] >= 0) atomicAdd(&hist[bins[r]], 1);
  __syncthreads();
  for (int i = threadIdx.x; i < p.n_bins; i += kBinThreads)
    if (hist[i]) atomicAdd(p.counts + i, hist[i]);
}

// One block: the exclusive scan of the counts into each bin's list start
// (cursor) and of the bins' chunk counts into the chunk table. A bin of n
// samples splits into nch = ceil(n / kChunk) chunks, chunk j taking records
// j, j + nch, j + 2 nch, ... of the bin's list: each chunk a sample of the whole
// bin, so that a chunk's bands are as even as the bin's.
__global__ void __launch_bounds__(kScanThreads)
ms_deform_attn_bwd_bin_scan(const __grid_constant__ BinParams p) {
  constexpr int kPer = kMaxBins / kScanThreads;
  __shared__ int2 warp_sum[kScanThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int first = threadIdx.x * kPer;
  int cnt[kPer];
  int n = 0, c = 0;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    cnt[i] = first + i < p.n_bins ? p.counts[first + i] : 0;
    n += cnt[i];
    c += (cnt[i] + kChunk - 1) / kChunk;
  }
  int in = n, ic = c;                          // inclusive scans within the warp
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int un = __shfl_up_sync(0xffffffffu, in, off);
    const int uc = __shfl_up_sync(0xffffffffu, ic, off);
    if (lane >= off) { in += un; ic += uc; }
  }
  if (lane == 31) warp_sum[warp] = make_int2(in, ic);
  __syncthreads();
  if (warp == 0) {
    const int2 v = warp_sum[lane];
    int wn = v.x, wc = v.y;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int un = __shfl_up_sync(0xffffffffu, wn, off);
      const int uc = __shfl_up_sync(0xffffffffu, wc, off);
      if (lane >= off) { wn += un; wc += uc; }
    }
    warp_sum[lane] = make_int2(wn - v.x, wc - v.y);
  }
  __syncthreads();
  int off_n = warp_sum[warp].x + in - n, off_c = warp_sum[warp].y + ic - c;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int bin = first + i;
    if (bin >= p.n_bins) break;
    p.cursor[bin] = off_n;
    const int nch = (cnt[i] + kChunk - 1) / kChunk;
    for (int j = 0; j < nch; ++j)
      p.chunks[off_c + j] = make_int4(bin, off_n + j, (cnt[i] - j + nch - 1) / nch, nch);
    off_n += cnt[i];
    off_c += nch;
  }
  if (threadIdx.x == kScanThreads - 1) {
    p.header[0] = off_c;
    p.header[1] = p.n_bins;
    p.header[2] = kFlushWords;
  }
}

// Pass 2: each sample's record into its bin's list, and its place into inv.
// A block of kScatterThreads threads takes 8192 samples, 8 a thread held in
// registers (the more samples a block, the longer its runs of one bin's
// records; 8192 fill the shared memory of one block an SM): their counts into a shared
// histogram, scanned into the block's own offsets; one global atomic a bin
// for the block's range of it; each sample's place by a shared atomic; the
// records staged in shared memory in that order and written out from it, so
// that a warp's stores run along a bin's range instead of going to 32
// scattered 16-byte places (the kernel's largest cost).
template <int TH, int TW>
__global__ void __launch_bounds__(kScatterThreads)
ms_deform_attn_bwd_bin_scatter(const __grid_constant__ BinParams p) {
  constexpr int kPer = kScatterPerThread;
  constexpr int kBinsPer = kMaxBins / kScatterThreads;
  extern __shared__ __align__(16) unsigned char scatter_smem[];
  int4* staged = reinterpret_cast<int4*>(scatter_smem);                   // [kScatterSamples]
  int* staged_pos = reinterpret_cast<int*>(staged + kScatterSamples);      // [kScatterSamples]
  int* hist = staged_pos + kScatterSamples;                                // [n_bins]
  int* local = hist + p.n_bins;                                            // [n_bins]
  int* base = local + p.n_bins;                                            // [n_bins]
  __shared__ int warp_sum[kScatterThreads / 32];
  for (int i = threadIdx.x; i < p.n_bins; i += kScatterThreads) hist[i] = 0;
  const int k0 = blockIdx.x * kScatterSamples + threadIdx.x;
  float x[kPer], y[kPer], a[kPer];
  int bins[kPer];
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int k = k0 + r * kScatterThreads;
    bins[r] = -1;
    a[r] = 0.f;
    if (k < p.samples) {
      bins[r] = sample_bin<TH, TW>(p, k, x[r], y[r]);
      a[r] = __ldg(p.attw + k);
    }
  }
  __syncthreads();                                 // the histogram zeroed
#pragma unroll
  for (int r = 0; r < kPer; ++r)
    if (bins[r] >= 0) atomicAdd(&hist[bins[r]], 1);
  __syncthreads();
  // the block's exclusive scan of its counts (kBinsPer bins a thread), and
  // its range of each bin it holds samples of
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int first = threadIdx.x * kBinsPer;
  int own = 0;
#pragma unroll
  for (int i = 0; i < kBinsPer; ++i) own += first + i < p.n_bins ? hist[first + i] : 0;
  int in = own;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, in, off);
    if (lane >= off) in += u;
  }
  if (lane == 31) warp_sum[warp] = in;
  __syncthreads();
  if (warp == 0) {
    const int v = warp_sum[lane];
    int wv = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, wv, off);
      if (lane >= off) wv += u;
    }
    warp_sum[lane] = wv - v;
  }
  __syncthreads();
  int off = warp_sum[warp] + in - own;
#pragma unroll
  for (int i = 0; i < kBinsPer; ++i) {
    const int bin = first + i;
    if (bin >= p.n_bins) break;
    const int n = hist[bin];
    local[bin] = off;
    if (n) base[bin] = atomicAdd(p.cursor + bin, n);
    hist[bin] = off;                               // from here the bin's next local place
    off += n;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int k = k0 + r * kScatterThreads;
    if (k >= p.samples) continue;
    int pos = -1;
    if (bins[r] >= 0) {
      const int lpos = atomicAdd(&hist[bins[r]], 1);
      pos = base[bins[r]] + lpos - local[bins[r]];
      staged[lpos] = make_int4(k, __float_as_int(x[r]), __float_as_int(y[r]),
                               __float_as_int(a[r]));
      staged_pos[lpos] = pos;
    }
    p.inv[k] = pos;
  }
  __syncthreads();
  const int total = hist[p.n_bins - 1];            // the last bin's end: the block's records
  for (int i = threadIdx.x; i < total; i += kScatterThreads) p.records[staged_pos[i]] = staged[i];
}

struct AccParams {
  CUtensorMap vmap[kMaxLevels];    // the value, a level each: {D, M, W, H, B}
  CUtensorMap gmap[kMaxLevels];    // the f32 value gradient, the same
  const void* gout;
  int4* records;                   // read, then each overwritten with (index, its three gradients)
  const int4* chunks;
  const int* n_chunks;             // the scratch's header: its first int
  Levels lv;
  FastDiv lp_div;
  int m;
};

// Dynamic shared memory of an accumulate block, from a 128-byte aligned base.
// The value tile: [TH+2][TW+2][D] from pixel (y_org - 1, x_org - 1), as the
// value map's box (a ring of one pixel, zeros past the map), so that a
// sample's four corners sit at fixed offsets from its first even at y0 = -1
// or x0 = -1. The f32 gradient tile: tile pixel (r, c), r in -1..TH, c in
// -1..TW, at 1 + (r + 1) (TW + 2) + c, so that rows 0..TH, columns 0..TW + 1
// form the gradient map's box, flushed from (y_org, x_org) (a TMA reduce
// takes no box that starts outside the tensor); column -1 of a row shares its
// word with column TW + 1 of the row before, and row -1 lies before the box.
// Only corners off the map land on row or column -1, and they add 0, so the
// box's extra column adds zeros. Then the chunk's record order by band
// (uint16) and the TMA barrier.
template <typename T>
struct BinSmem {
  static constexpr int kH = kTileH, kW = kTileW;
  static constexpr int kRow = kW + 2;                         // pixels a row, both tiles
  static constexpr int kValuePixels = (kH + 2) * kRow;
  static constexpr int kGradPixels = 1 + (kH + 2) * kRow;
  static constexpr int kFlushPixel = 1 + kRow;                // the gradient box's first: (0, 0)
  static constexpr int kGradBytes = kGradPixels * kBinD * 4;
  static constexpr int kValueBytes = kValuePixels * kBinD * static_cast<int>(sizeof(T));
  static constexpr int kValue = (kGradBytes + 127) / 128 * 128;
  static constexpr int kOrder = kValue + (kValueBytes + 127) / 128 * 128;
  static constexpr int kBar = kOrder + kChunk * 2;
  static constexpr int kBytes = kBar + 8 + 128;
  static_assert(kFlushPixel * kBinD * 4 % 128 == 0, "the flushed box must start 128-byte aligned");
};

template <typename T> struct Octet;              // 8 consecutive channels of a row
template <> struct Octet<__nv_bfloat16> {
  using Raw = uint4;
  static __device__ __forceinline__ Raw ldg(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ Raw lds(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
  static __device__ __forceinline__ void unpack(Raw v, float (&f)[8]) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};
template <> struct Octet<float> {
  struct Raw { float4 lo, hi; };
  static __device__ __forceinline__ Raw ldg(const float* p) {
    return {__ldg(reinterpret_cast<const float4*>(p)), __ldg(reinterpret_cast<const float4*>(p) + 1)};
  }
  static __device__ __forceinline__ Raw lds(const float* p) {
    return {reinterpret_cast<const float4*>(p)[0], reinterpret_cast<const float4*>(p)[1]};
  }
  static __device__ __forceinline__ void unpack(Raw v, float (&f)[8]) {
    f[0] = v.lo.x; f[1] = v.lo.y; f[2] = v.lo.z; f[3] = v.lo.w;
    f[4] = v.hi.x; f[5] = v.hi.y; f[6] = v.hi.z; f[7] = v.hi.w;
  }
};

// word += sc * g for the shared word at addr + kOffset, which the caller owns
// (no atomic): one load, one FMA, one store, the offset in the instructions.
template <int kOffset>
__device__ __forceinline__ void fma_shared_at(uint32_t addr, float sc, float g) {
  float old;
  asm volatile("ld.shared.f32 %0, [%1+%2];\n" : "=f"(old) : "r"(addr), "n"(kOffset));
  asm volatile("st.shared.f32 [%0+%1], %2;\n" :: "r"(addr), "n"(kOffset), "f"(fmaf(sc, g, old)));
}

// One block a chunk: stage the tile, accumulate its samples' value gradient
// in shared memory, write their location and weight gradients into their
// records' slots, flush the tile by one TMA reduce-add. Blocks past the chunk
// count exit at once (the grid is sized for the most chunks the samples can
// make).
//
// Shared f32 atomics are compare-and-swap loops on sm_90 (ATOMS.CAST.SPIN in
// the SASS), so the tile's adds are plain loads and stores under ownership:
// the chunk's records are sorted by band in shared memory (a counting sort of
// their y), and warp w takes band 2w, then, after a barrier, band 2w + 1. A
// band's samples touch its row and the next only (a corner off the map adds
// 0 at its pixel of the ringed tiles, in the same rows; row -1 is band 0's),
// so the bands of one phase never share a word. A warp takes 8 samples at a time, 4 lanes a sample and 8
// channels a lane; at its i-th add a lane adds channel 8j + (i + slot) & 7 (j
// its channel octet, slot its sample), so the 32 lanes of a step touch 32
// distinct words on 32 distinct banks wherever the 8 samples land, and the
// warp's 32 steps of an iteration run in order.
template <typename T>
__global__ void __launch_bounds__(kAccThreads)
ms_deform_attn_bwd_accumulate(const __grid_constant__ AccParams p) {
  using S = BinSmem<T>;
  using V = Octet<T>;
  constexpr int kRow = S::kRow;                   // pixels a tile row
  constexpr int kPerThread = kChunk / kAccThreads;
  if (static_cast<int>(blockIdx.x) >= *p.n_chunks) return;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~static_cast<uintptr_t>(127));
  float* grad_s = reinterpret_cast<float*>(smem);
  const T* val_s = reinterpret_cast<const T*>(smem + S::kValue);
  uint16_t* order = reinterpret_cast<uint16_t*>(smem + S::kOrder);
  __shared__ int band_start[kTileH + 1], fill[kTileH];
  const uint32_t bar = smem_u32(smem + S::kBar);

  const int4 ch = p.chunks[blockIdx.x];           // bin, first record, length, stride
  const int tiles = p.lv.tile_base[p.lv.n];
  const int bm = ch.x / tiles, t = ch.x - bm * tiles;
  int l = 0;
  while (l + 1 < p.lv.n && t >= p.lv.tile_base[l + 1]) ++l;
  const int tl = t - p.lv.tile_base[l];
  const int ty = tl / p.lv.tiles_x[l], tx = tl - ty * p.lv.tiles_x[l];
  const int bi = bm / p.m, mi = bm - bi * p.m;
  const int y_org = ty * S::kH, x_org = tx * S::kW;
  const int h = p.lv.h[l], w = p.lv.w[l];
  const int len = ch.z, stride = ch.w;
  const int4* recs = p.records + ch.y;            // record i of the chunk: recs[i * stride]
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(bar, S::kValueBytes);
    tma_load_5d(smem_u32(smem + S::kValue), &p.vmap[l], bar, 0, mi, x_org - 1, y_org - 1, bi);
  }
  float4* g4 = reinterpret_cast<float4*>(grad_s);
  for (int i = threadIdx.x; i < S::kGradPixels * kBinD / 4; i += kAccThreads)
    g4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (threadIdx.x < S::kH) fill[threadIdx.x] = 0;
  __syncthreads();                                // the tile and counters zeroed, the barrier set up

  // the chunk's records by band (the tile row of the top-left corner, y0 = -1
  // in band 0): count, scan into band_start (band_start[kH] = len), place
  int band[kPerThread];
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const int i = threadIdx.x + r * kAccThreads;
    band[r] = i < len ? max((int)floorf(__int_as_float(__ldg(&recs[i * stride].z))) - y_org, 0)
                      : -1;
  }
#pragma unroll
  for (int r = 0; r < kPerThread; ++r)
    if (band[r] >= 0) atomicAdd(&fill[band[r]], 1);
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int n = lane < S::kH ? fill[lane] : 0;
    int in = n;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, in, off);
      if (lane >= off) in += u;
    }
    if (lane <= S::kH) band_start[lane] = in - n;
    if (lane < S::kH) fill[lane] = in - n;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kPerThread; ++r)
    if (band[r] >= 0) order[atomicAdd(&fill[band[r]], 1)] =
        static_cast<uint16_t>(threadIdx.x + r * kAccThreads);
  __syncthreads();
  mbar_wait(bar, 0);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slot = lane >> 2, j = lane & 3;       // the warp's sample, this lane's channel octet
  const T* gout = static_cast<const T*>(p.gout) + 8 * j;
  const T* val_j = val_s + 8 * j;
  const uint32_t gbase = smem_u32(grad_s) + 32 * j;
  uint32_t rot[8];                                // the i-th add's byte offset: channel (i + slot) & 7
#pragma unroll
  for (int i = 0; i < 8; ++i) rot[i] = 4 * ((i + slot) & 7);
#pragma unroll 1
  for (int phase = 0; phase < 2; ++phase) {
    const int bd = 2 * warp + phase;
    const int first = band_start[bd], n = band_start[bd + 1] - first;
    // a dead lane's sample: weight 0 at the band's first row (owned), column 0
    const int4 dead = make_int4(0, __float_as_int((float)x_org),
                                __float_as_int((float)(y_org + bd)), 0);
    auto record = [&](int i) { return i < n ? __ldg(recs + order[first + i] * stride) : dead; };
    // records run two steps ahead, cotangent rows one
    int4 rec = record(slot);
    int4 rec_next = record(slot + 8);
    typename V::Raw go_raw = V::ldg(gout + static_cast<size_t>(p.lp_div.div(rec.x)) * kBinD);
    for (int base = 0; base < n; base += 8) {
      const int i = base + slot;
      const bool live = i < n;
      const int4 rec_after = record(i + 16);
      const typename V::Raw go_next =
          V::ldg(gout + static_cast<size_t>(p.lp_div.div(rec_next.x)) * kBinD);
      __syncwarp();

      float go[8];
      V::unpack(go_raw, go);
      const float x = __int_as_float(rec.y), y = __int_as_float(rec.z), a = __int_as_float(rec.w);
      const float xf = floorf(x), yf = floorf(y);
      const int x0 = (int)xf, y0 = (int)yf;
      const float lx = x - xf, ly = y - yf;
      const bool vx0 = x0 >= 0, vx1 = x0 + 1 < w, vy0 = y0 >= 0, vy1 = y0 + 1 < h;
      const bool ok[4] = {live && vy0 && vx0, live && vy0 && vx1, live && vy1 && vx0,
                          live && vy1 && vx1};
      // the first corner's pixel in the value and gradient tiles; the others at
      // +1, +kRow, +kRow+1 (a corner off the map adds 0 there)
      const int p00 = (y0 - y_org + 1) * kRow + (x0 - x_org + 1);
      const int g00 = p00;                          // 1 + (y0 - y_org + 1) kRow + (x0 - x_org)
      constexpr int kCorner[4] = {0, 1, kRow, kRow + 1};
      const float cw[4] = {(1.f - ly) * (1.f - lx), (1.f - ly) * lx, ly * (1.f - lx), ly * lx};
      float s[4];
      const T* val_p = val_j + p00 * kBinD;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float v[8];
        V::unpack(V::lds(val_p + kCorner[c] * kBinD), v);
        float dot = 0.f;
#pragma unroll
        for (int k = 0; k < 8; ++k) dot = fmaf(v[k], go[k], dot);
        s[c] = ok[c] ? dot : 0.f;
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
#pragma unroll
        for (int c = 0; c < 4; ++c) s[c] += __shfl_xor_sync(0xffffffffu, s[c], off);
      }
      // the cotangent in this lane's add order: gr[i] = go[(i + slot) & 7]
      float gr[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) gr[k] = go[k];
      if (slot & 1) {
        const float g0 = gr[0];
#pragma unroll
        for (int k = 0; k < 7; ++k) gr[k] = gr[k + 1];
        gr[7] = g0;
      }
      if (slot & 2) {
        const float g0 = gr[0], g1 = gr[1];
#pragma unroll
        for (int k = 0; k < 6; ++k) gr[k] = gr[k + 2];
        gr[6] = g0; gr[7] = g1;
      }
      if (slot & 4) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float g = gr[k]; gr[k] = gr[k + 4]; gr[k + 4] = g;
        }
      }
      float sc[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[c] = ok[c] ? a * cw[c] : 0.f;
      const uint32_t pbase = gbase + static_cast<uint32_t>(g00) * (kBinD * 4);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const uint32_t addr = pbase + rot[k];
        fma_shared_at<0>(addr, sc[0], gr[k]);
        fma_shared_at<kBinD * 4>(addr, sc[1], gr[k]);
        fma_shared_at<kRow * kBinD * 4>(addr, sc[2], gr[k]);
        fma_shared_at<(kRow + 1) * kBinD * 4>(addr, sc[3], gr[k]);
      }
      if (live && j == 0) {                       // into the record's slot, for unpermute
        const float gx = (1.f - ly) * (s[1] - s[0]) + ly * (s[3] - s[2]);
        const float gy = (1.f - lx) * (s[2] - s[0]) + lx * (s[3] - s[1]);
        const float gw = cw[0] * s[0] + cw[1] * s[1] + cw[2] * s[2] + cw[3] * s[3];
        p.records[ch.y + order[first + i] * stride] =
            make_int4(rec.x, __float_as_int(gw), __float_as_int(a * w * gx),
                      __float_as_int(a * h * gy));
      }
      rec = rec_next;
      rec_next = rec_after;
      go_raw = go_next;
    }
    __syncthreads();                              // the phase's bands are done
  }
  fence_proxy_async();
  __syncthreads();
  if (threadIdx.x == 0) {
    tma_reduce_add_5d(&p.gmap[l], smem_u32(grad_s + S::kFlushPixel * kBinD), 0, mi, x_org, y_org,
                      bi);
    bulk_commit();
    bulk_wait_read();
  }
}

// The location and weight gradients in sample order: each sample's from its
// record's slot (zero for a sample in no bin), so that these stores are
// coalesced.
__global__ void __launch_bounds__(256) ms_deform_attn_bwd_unpermute(const __grid_constant__ BinParams p) {
  const int k = blockIdx.x * 256 + threadIdx.x;
  if (k >= p.samples) return;
  const int pos = p.inv[k];
  const int4 r = pos >= 0 ? p.records[pos] : make_int4(0, 0, 0, 0);
  p.grad_attw[k] = __int_as_float(r.y);
  reinterpret_cast<float2*>(p.grad_loc)[k] = make_float2(__int_as_float(r.z), __int_as_float(r.w));
}

// The binned design's tables and scratch layout for a launch; false where it
// cannot take the shape (over kMaxLevels levels or kMaxBins bins: the
// histograms' shared memory). Scratch, 16-byte aligned: a header of 4 int32
// (the chunk count, the bin count and kFlushWords, which bin_scan writes, so
// that a caller reads a launch's chunks and global adds from its first 12
// bytes), counts and cursors (int32, padded to 16 bytes), the chunk table, the
// records, inv.
struct BinPlan {
  Levels lv;
  int n_bins, samples, max_chunks;
  size_t ints_bytes, bytes;
};

bool bin_plan(const int* shapes, int b, int m, int q, int n_levels, int n_points, BinPlan* out) {
  if (shapes == nullptr || n_levels < 1 || n_levels > kMaxLevels || b <= 0 || m <= 0 || q <= 0 ||
      n_points <= 0)
    return false;
  const long long samples = (long long)b * q * m * n_levels * n_points;
  if (samples > (1LL << 31) - 2 * kScatterSamples) return false;
  BinPlan plan;
  memset(&plan, 0, sizeof(plan));
  plan.lv.n = n_levels;
  long long tiles = 0;
  for (int l = 0; l < n_levels; ++l) {
    const int h = shapes[2 * l], w = shapes[2 * l + 1];
    if (h <= 0 || w <= 0) return false;
    plan.lv.h[l] = h;
    plan.lv.w[l] = w;
    plan.lv.tile_base[l] = (int)tiles;
    plan.lv.tiles_x[l] = (w + kTileW - 1) / kTileW;
    tiles += (long long)((h + kTileH - 1) / kTileH) * plan.lv.tiles_x[l];
    if (tiles > kMaxBins) return false;
  }
  plan.lv.tile_base[n_levels] = (int)tiles;
  const long long bins = (long long)b * m * tiles;
  if (bins > kMaxBins) return false;
  plan.n_bins = (int)bins;
  plan.samples = (int)samples;
  plan.max_chunks = (int)(samples / kChunk + bins);
  plan.ints_bytes = 4 * (size_t)((4 + 2 * bins + 3) / 4 * 4);
  plan.bytes = plan.ints_bytes + 16 * ((size_t)plan.max_chunks + (size_t)samples) + 4 * (size_t)samples;
  *out = plan;
  return true;
}

bool binned_aligned(const void* value, const void* gout, const void* loc, const void* grad_value,
                    const void* grad_loc) {
  return (uintptr_t)value % 16 == 0 && (uintptr_t)gout % 16 == 0 && (uintptr_t)loc % 8 == 0 &&
         (uintptr_t)grad_value % 16 == 0 && (uintptr_t)grad_loc % 8 == 0;
}

// The design a launch takes: 1 the binned one where it can take the launch
// and the rule gives it (kMinSamplesPerBin) or force_binned asks for it, plan
// then its layout; 0 the atomics one; -1 where force_binned asks for the
// binned design at a launch it cannot take.
int choose_design(const int* shapes, int b, int m, int d, int q, int n_levels, int n_points,
                  bool aligned, bool force_binned, BinPlan* plan) {
  if (d != kBinD || !aligned || !bin_plan(shapes, b, m, q, n_levels, n_points, plan))
    return force_binned ? -1 : 0;
  return force_binned || (long long)plan->samples >= (long long)kMinSamplesPerBin * plan->n_bins;
}

// bin_scatter's dynamic shared memory: the staged records and their places,
// and three ints a bin.
int scatter_smem_bytes(int n_bins) { return kScatterSamples * (16 + 4) + 12 * n_bins; }
// kMaxBins is what keeps bin_scatter within a block's shared memory (its
// static part: warp_sum, and 128 bytes of slack)
static_assert(kScatterSamples * (16 + 4) + 12 * kMaxBins + 4 * (kScatterThreads / 32) + 128 <=
                  kMaxSharedOptin,
              "bin_scatter's shared memory at kMaxBins bins exceeds a block's");
static_assert(kMaxBins % kScanThreads == 0 && kMaxBins % kScatterThreads == 0,
              "the scan and the scatter take kMaxBins / 1024 bins a thread");

// The accumulate kernel's shared memory: its dynamic size, and the carveout
// at its most, so that the driver gives shared memory for as many blocks as
// the registers allow.
template <typename T>
cudaError_t accumulate_attributes() {
  cudaError_t err = cudaFuncSetAttribute(ms_deform_attn_bwd_accumulate<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         BinSmem<T>::kBytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(ms_deform_attn_bwd_accumulate<T>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <typename T>
cudaError_t launch_binned(const BinPlan& plan, const void* value, const int* shapes,
                          const float* loc, const float* attw, const void* gout, float* grad_value,
                          float* grad_loc, float* grad_attw, int b, int s, int m, int q,
                          int n_points, void* scratch, long long scratch_bytes, cudaStream_t st) {
  using S = BinSmem<T>;
  if (scratch == nullptr || (uintptr_t)scratch % 16 != 0 || scratch_bytes < (long long)plan.bytes)
    return cudaErrorInvalidValue;
  char* base = static_cast<char*>(scratch);
  BinParams bp;
  memset(&bp, 0, sizeof(bp));
  bp.loc = loc;
  bp.attw = attw;
  bp.grad_loc = grad_loc;
  bp.grad_attw = grad_attw;
  bp.header = reinterpret_cast<int*>(base);
  bp.counts = bp.header + 4;
  bp.cursor = bp.counts + plan.n_bins;
  bp.chunks = reinterpret_cast<int4*>(base + plan.ints_bytes);
  bp.records = bp.chunks + plan.max_chunks;
  bp.inv = reinterpret_cast<int*>(bp.records + plan.samples);
  bp.lv = plan.lv;
  const int n_levels = plan.lv.n;
  bp.lp_div = make_div(n_levels * n_points);
  bp.p_div = make_div(n_points);
  bp.m_div = make_div(m);
  bp.qm_div = make_div(q * m);
  bp.m = m;
  bp.samples = plan.samples;
  bp.n_bins = plan.n_bins;

  AccParams ap;
  memset(&ap, 0, sizeof(ap));
  const size_t elem = sizeof(T);
  const CUtensorMapDataType vtype =
      sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const cuuint32_t vbox[5] = {kBinD, 1, S::kRow, S::kH + 2, 1};
  const cuuint32_t gbox[5] = {kBinD, 1, S::kRow, S::kH + 1, 1};
  long long start = 0;
  for (int l = 0; l < n_levels; ++l) {
    const int h = shapes[2 * l], w = shapes[2 * l + 1];
    const cuuint64_t dims[5] = {kBinD, (cuuint64_t)m, (cuuint64_t)w, (cuuint64_t)h, (cuuint64_t)b};
    const cuuint64_t vstr[4] = {kBinD * elem, (cuuint64_t)m * kBinD * elem,
                                (cuuint64_t)w * m * kBinD * elem, (cuuint64_t)s * m * kBinD * elem};
    const cuuint64_t gstr[4] = {kBinD * 4, (cuuint64_t)m * kBinD * 4,
                                (cuuint64_t)w * m * kBinD * 4, (cuuint64_t)s * m * kBinD * 4};
    const char* v0 = static_cast<const char*>(value) + start * m * kBinD * elem;
    char* g0 = reinterpret_cast<char*>(grad_value) + start * m * kBinD * 4;
    if (!encode_map(&ap.vmap[l], vtype, 5, v0, dims, vstr, vbox, CU_TENSOR_MAP_SWIZZLE_NONE) ||
        !encode_map(&ap.gmap[l], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 5, g0, dims, gstr, gbox,
                    CU_TENSOR_MAP_SWIZZLE_NONE))
      return cudaErrorInvalidValue;
    start += (long long)h * w;
  }
  ap.gout = gout;
  ap.records = bp.records;
  ap.chunks = bp.chunks;
  ap.n_chunks = bp.header;
  ap.lv = plan.lv;
  ap.lp_div = bp.lp_div;
  ap.m = m;

  constexpr int TH = kTileH, TW = kTileW;
  cudaError_t err = cudaMemsetAsync(scratch, 0, plan.ints_bytes, st);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)((plan.samples + kBinSamples - 1) / kBinSamples);
  ms_deform_attn_bwd_bin_count<TH, TW><<<blocks, kBinThreads, 0, st>>>(bp);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ms_deform_attn_bwd_bin_scan<<<1, kScanThreads, 0, st>>>(bp);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int scatter_bytes = scatter_smem_bytes(plan.n_bins);
  err = cudaFuncSetAttribute(ms_deform_attn_bwd_bin_scatter<TH, TW>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, scatter_bytes);
  if (err != cudaSuccess) return err;
  ms_deform_attn_bwd_bin_scatter<TH, TW>
      <<<(plan.samples + kScatterSamples - 1) / kScatterSamples, kScatterThreads, scatter_bytes,
         st>>>(bp);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  err = accumulate_attributes<T>();
  if (err != cudaSuccess) return err;
  ms_deform_attn_bwd_accumulate<T><<<plan.max_chunks, kAccThreads, S::kBytes, st>>>(ap);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ms_deform_attn_bwd_unpermute<<<(plan.samples + 255) / 256, 256, 0, st>>>(bp);
  return cudaGetLastError();
}

}  // namespace

// 1 where hipie_ms_deform_attn_bwd takes the binned design at this shape
// (host_shapes: (L, 2) int32 (H, W) on the host; aligned: value and gout
// 16-byte aligned, loc 8-byte), 0 where the atomics design.
extern "C" int hipie_ms_deform_attn_bwd_design(const void* host_shapes, int b, int m, int d, int q,
                                               int n_levels, int n_points, int aligned) {
  BinPlan plan;
  return choose_design(static_cast<const int*>(host_shapes), b, m, d, q, n_levels, n_points,
                       aligned != 0, false, &plan);
}

// The scratch hipie_ms_deform_attn_bwd needs for a launch of this shape, as a
// long long into out: the binned design's (bin_plan) where it takes that
// design, 0 where the atomics one. An error where force_binned asks for the
// binned design at a shape it cannot take.
extern "C" int hipie_ms_deform_attn_bwd_scratch_bytes(const void* host_shapes, int b, int m, int d,
                                                      int q, int n_levels, int n_points,
                                                      int aligned, int force_binned, void* out) {
  BinPlan plan;
  const int design = choose_design(static_cast<const int*>(host_shapes), b, m, d, q, n_levels,
                                   n_points, aligned != 0, force_binned != 0, &plan);
  if (design < 0) return (int)cudaErrorInvalidValue;
  const long long bytes = design == 1 ? (long long)plan.bytes : 0;
  memcpy(out, &bytes, sizeof(bytes));
  return 0;
}

// The binned design's constants, for the wrapper's copies: kBinThreads,
// kBinPerThread, kScanThreads, kScatterThreads, kScatterPerThread, kMaxBins,
// kAccThreads, kChunk, kMaxLevels, kBinD, kTileH, kTileW, kMinSamplesPerBin.
extern "C" int hipie_ms_deform_attn_bwd_constants(void* out) {
  const int c[13] = {kBinThreads, kBinPerThread, kScanThreads, kScatterThreads,
                     kScatterPerThread, kMaxBins, kAccThreads, kChunk, kMaxLevels, kBinD,
                     kTileH, kTileW, kMinSamplesPerBin};
  memcpy(out, c, sizeof(c));
  return 0;
}

// vec_channels: 4 (D % 4 == 0 and value, gout aligned to 4 elements) or 1;
// threads_per_pair: a power of two <= 32 with D / vec_channels <= 4 *
// threads_per_pair (the atomics design's plan). grad_value must be zero on
// entry. host_shapes: the level shapes on the host. The design is the rule's
// (hipie_ms_deform_attn_bwd_design), or the binned one where force_binned (an
// error where it cannot take the launch); design_out (a host int, or null)
// gets the one launched, 1 binned or 0 atomics. scratch: scratch_bytes of
// 16-byte aligned device memory, as hipie_ms_deform_attn_bwd_scratch_bytes
// gives (none for the atomics design).
extern "C" int hipie_ms_deform_attn_bwd(const void* value, const void* shapes,
                                        const void* level_start, const void* loc,
                                        const void* attw, const void* gout, void* grad_value,
                                        void* grad_loc, void* grad_attw, int b, int s, int m,
                                        int d, int q, int n_levels, int n_points,
                                        int value_is_bf16, int vec_channels,
                                        int threads_per_pair, const void* host_shapes,
                                        int force_binned, void* scratch, long long scratch_bytes,
                                        void* design_out, void* stream) {
  const int elem = value_is_bf16 ? 2 : 4;
  const int vb = vec_channels * elem;
  const int tpp = threads_per_pair;
  if (d <= 0 || d > 128 || b <= 0 || q <= 0 || m <= 0 || n_levels <= 0 || n_points <= 0 ||
      (vec_channels != 1 && vec_channels != 4) || d % vec_channels != 0 ||
      (uintptr_t)value % vb != 0 || (uintptr_t)gout % vb != 0 ||
      (uintptr_t)grad_loc % 8 != 0 || tpp <= 0 || tpp > 32 || (tpp & (tpp - 1)) != 0 ||
      d / vec_channels > kMaxVecs * tpp || (long long)s * m * d >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* hs = static_cast<const int*>(host_shapes);
  const bool bf16 = value_is_bf16 != 0;
  const bool aligned = binned_aligned(value, gout, loc, grad_value, grad_loc);
  BinPlan plan;
  const int design =
      choose_design(hs, b, m, d, q, n_levels, n_points, aligned, force_binned != 0, &plan);
  if (design < 0) return (int)cudaErrorInvalidValue;
  if (design_out != nullptr) memcpy(design_out, &design, sizeof(design));
  if (design == 1) {
    const float* lf = static_cast<const float*>(loc);
    const float* af = static_cast<const float*>(attw);
    float* gv = static_cast<float*>(grad_value);
    float* gl = static_cast<float*>(grad_loc);
    float* ga = static_cast<float*>(grad_attw);
    return bf16 ? launch_binned<__nv_bfloat16>(plan, value, hs, lf, af, gout, gv, gl, ga, b, s, m,
                                               q, n_points, scratch, scratch_bytes, st)
                : launch_binned<float>(plan, value, hs, lf, af, gout, gv, gl, ga, b, s, m, q,
                                       n_points, scratch, scratch_bytes, st);
  }
  Params p{value, static_cast<const int*>(shapes), static_cast<const int*>(level_start),
           static_cast<const float*>(loc), static_cast<const float*>(attw), gout,
           static_cast<float*>(grad_value), static_cast<float*>(grad_loc),
           static_cast<float*>(grad_attw), b, s, m, d, q, n_levels, n_points, tpp,
           d / vec_channels};
  const long long blocks = ((long long)b * q * m + kThreads / tpp - 1) / (kThreads / tpp);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (value_is_bf16)
    return vec_channels == 4 ? launch<__nv_bfloat16, 4>(p, blocks, st)
                             : launch<__nv_bfloat16, 1>(p, blocks, st);
  return vec_channels == 4 ? launch<float, 4>(p, blocks, st) : launch<float, 1>(p, blocks, st);
}
