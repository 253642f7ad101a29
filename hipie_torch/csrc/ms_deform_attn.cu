// Multi-scale deformable attention, forward, fused gather + bilinear + reduce.
//
// Replaces: hipie_tpu/ops/ms_deform_attn.py::ms_deform_attn_jnp (methods
// "flat" for f32 values and "flat6_bf16" for bf16 values; an XLA gather in
// JAX). Semantics of the reference CUDA op (ms_deform_im2col_cuda.cuh): for
// every (b, q, m), a "pair",
//
//     out[b, q, m*D + c] = sum_{l, p} A[b, q, m, l, p]
//                          * bilinear(V_l[b, :, m, c], loc[b, q, m, l, p])
//
// with align_corners=False (pixel x = loc_x * W_l - 0.5) and zero padding
// outside the level. value: (B, S, M, D) bf16 or f32; loc: (B, Q, M, L, P, 2)
// f32; A: (B, Q, M, L, P) f32; shapes: (L, 2) int32 (H, W); level_start: (L,)
// int32; out: (B, Q, M*D) in the value's dtype. Sampling and accumulation are
// f32, the output is rounded once. Main path: B=1, S=21760, M=8, D=32, L=P=4,
// bf16, with Q = 21760 (6 encoder layers), 910 (6 decoder layers) and 300 (9
// MaskDINO decoder layers).
//
// What bounds it on the H100: the corner gathers. Each pair reads L*P*4 = 64
// corner rows of D values (64 B each in bf16 at D=32): 713 MB a launch at the
// encoder shape, against 56 MB of inputs and output (the HBM bound, 0.017
// ms). The 11 MB value map stays in the 50 MB L2, so the gathers are L2 (and,
// where neighbouring queries overlap, L1) traffic, and the kernel is bound by
// how fast the SMs' load units and L2 return scattered 64-byte rows: about
// 8.5 TB/s of corner rows at the encoder shape (python -m
// hipie_torch.kernels.msda_bench, NVIDIA H100 80GB HBM3, 700 W). The work is
// ~10 FLOP per value read. What the design does about it:
//  * 16-byte gathers: a thread reads 16 B of a head row (8 bf16 or 4 f32
//    channels) in one vector load, so at D=32 bf16 four threads cover a corner
//    row and a warp instruction fetches 8 corner rows, not one. Rows whose
//    width or address is not a multiple of 16 B take an 8-, 4- or 2-byte
//    instance of the same kernel (VB below).
//  * Loads in flight: the samples of a thread go in batches of kBatch, and
//    the 4 x kBatch corner loads of a batch are issued before any is used;
//    at <= 80 registers three blocks (24 warps) stay resident on an SM.
//    L*P = 16 (the path's) is a template instance with every bound known.
//  * Query tiles: a block owns a run of consecutive pairs, i.e. consecutive
//    queries with all M heads (8 queries x 8 heads on the encoder), and
//    blocks go out in query order, so neighbouring queries share an SM's L1.
//  * Sample tables staged once per tile: the tile's locations and weights are
//    one contiguous stretch of global memory. The block reads it once,
//    coalesced (each thread takes whole samples, consecutive threads
//    consecutive samples), straight into the registers of the thread that
//    turns each sample into its 4 corner offsets and 4 weights (bilinear x
//    attention) in shared memory; the threads of a pair then read them as two
//    16-byte broadcasts. Copying the raw stretch into shared memory with
//    16-byte cp.async first (built with -DHIPIE_MSDA_STAGE_CP_ASYNC=1, for
//    the comparison in msda_bench.py only) measures slower: the grid is not
//    persistent, so there is no next tile to prefetch, and with three blocks
//    on an SM one block's staging already overlaps the others' gathers. An
//    out-of-range corner gets weight 0 and a clamped, valid offset, so the
//    gather has no branch. Table rows are padded by one entry so that
//    neither the writes nor the reads conflict on banks.
//  * Small grids (MaskDINO's Q = 300, 38 blocks of 64 pairs): the samples of
//    a pair split over G = 4 groups of threads, whose partial sums meet
//    through warp shuffles, so the grid still covers the card.
//  * Coalesced output: a pair writes one row of D values, a warp whole rows
//    of consecutive heads.
// The launch plan (vector width, threads per row, G) is chosen by the Python
// wrapper (hipie_torch/ops/ms_deform_attn.py::kernel_plan) and checked here;
// the wrapper's copies of the constants below are held equal to
// hipie_ms_deform_attn_constants by chip_smoke.py and the card tests;
// tests/test_torch_msda_tiles.py replays the decomposition on the CPU.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>
#include <type_traits>

#ifndef HIPIE_MSDA_STAGE_CP_ASYNC
#define HIPIE_MSDA_STAGE_CP_ASYNC 0
#endif

namespace {

constexpr int kThreads = 256;       // a block
constexpr int kChunk = 16;          // samples of each pair staged per table fill
constexpr int kBatch = 4;           // samples whose corners a thread loads at once
constexpr int kMaxPairs = 64;       // pairs per block: at least 4 threads per pair
constexpr int kMinBlocks = 3;       // resident blocks an SM must hold (<= 80 registers)
constexpr int kStagePerThread = kMaxPairs * kChunk / kThreads;
// shared bytes of the raw stretch in the cp.async variant: kMaxPairs * kChunk
// locations (8 B) and weights (4 B)
constexpr int kRawBytes = HIPIE_MSDA_STAGE_CP_ASYNC ? kMaxPairs * kChunk * 12 : 0;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

template <int VB> struct VecType;
template <> struct VecType<16> { using type = uint4; };
template <> struct VecType<8> { using type = uint2; };
template <> struct VecType<4> { using type = unsigned int; };
template <> struct VecType<2> { using type = unsigned short; };

// VB bytes of T -> VB / sizeof(T) floats (bf16 is the high half of an f32).
template <typename T, int VB>
__device__ __forceinline__ void to_f32(const typename VecType<VB>::type& v, float* f) {
  if constexpr (VB == 2) {
    f[0] = __uint_as_float((unsigned)v << 16);
  } else {
    constexpr int kWords = VB / 4;
    unsigned w[kWords];
    memcpy(w, &v, VB);
#pragma unroll
    for (int i = 0; i < kWords; ++i) {
      if constexpr (std::is_same<T, float>::value) {
        f[i] = __uint_as_float(w[i]);
      } else {
        f[2 * i] = __uint_as_float(w[i] << 16);
        f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      }
    }
  }
}

__device__ __forceinline__ unsigned bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

template <typename T, int VB>
__device__ __forceinline__ typename VecType<VB>::type from_f32(const float* f) {
  typename VecType<VB>::type v;
  if constexpr (VB == 2) {
    v = (unsigned short)bf16_bits(f[0]);
  } else {
    constexpr int kWords = VB / 4;
    unsigned w[kWords];
#pragma unroll
    for (int i = 0; i < kWords; ++i) {
      if constexpr (std::is_same<T, float>::value) {
        w[i] = __float_as_uint(f[i]);
      } else {
        w[i] = bf16_bits(f[2 * i]) | (bf16_bits(f[2 * i + 1]) << 16);
      }
    }
    memcpy(&v, w, VB);
  }
  return v;
}

struct Params {
  const void* value;
  const int* shapes;
  const int* level_start;
  const float* loc;
  const float* attw;
  void* out;
  int b, s, m, d, q, n_levels, n_points;
  int chunks;          // vectors of VB bytes in a head row: D * sizeof(T) / VB
  int chunk_threads;   // threads over a row's chunks (a power of two <= 32)
  int chunk_iters;     // ceil(chunks / chunk_threads)
};

// One table fill: samples s0 .. s0 + kChunk - 1 of the block's pairs. Thread t
// takes the samples t, t + kThreads, ... of the tile in (pair, sample) order,
// so a warp reads 32 consecutive samples' locations and weights. Offsets are
// in VB-byte vectors from the pair's (b, position 0, m) row; entries past L*P
// or past the last pair get weight 0 and offset 0.
template <int VB>
__device__ __forceinline__ void stage(const Params& p, int lp, int elem, long long pair0,
                                      long long pairs, int pb, int s0, int4* s_off,
                                      float4* s_w) {
  const int row_vecs = p.m * p.d * elem / VB;        // vectors between positions
  const int n_e = pb * kChunk;
  float2 xy[kStagePerThread];
  float a[kStagePerThread];
#if HIPIE_MSDA_STAGE_CP_ASYNC
  // the block copies the tile's stretch (L*P == kChunk, one fill: sample e of
  // the tile is sample pair0 * kChunk + e) in 16-byte pieces, then reads it
  float2* s_xy = reinterpret_cast<float2*>(s_w + kChunk * (pb + 1));
  float* s_a = reinterpret_cast<float*>(s_xy + kMaxPairs * kChunk);
  const int n_raw = (int)min(pairs - pair0, (long long)pb) * kChunk;
  const char* g_xy = reinterpret_cast<const char*>(p.loc + 2 * pair0 * kChunk);
  const char* g_a = reinterpret_cast<const char*>(p.attw + pair0 * kChunk);
  for (int c = threadIdx.x; c < n_raw / 2; c += kThreads) cp_async16(s_xy + 2 * c, g_xy + 16 * c);
  for (int c = threadIdx.x; c < n_raw / 4; c += kThreads) cp_async16(s_a + 4 * c, g_a + 16 * c);
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
#endif
#pragma unroll
  for (int i = 0; i < kStagePerThread; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const long long pr = pair0 + e / kChunk;
    const int sp = s0 + e % kChunk;
    xy[i] = make_float2(0.f, 0.f);
    a[i] = 0.f;
    if (e < n_e && pr < pairs && sp < lp) {
#if HIPIE_MSDA_STAGE_CP_ASYNC
      xy[i] = s_xy[e];
      a[i] = s_a[e];
#else
      const long long k = pr * lp + sp;
      xy[i] = __ldg(reinterpret_cast<const float2*>(p.loc) + k);
      a[i] = __ldg(p.attw + k);
#endif
    }
  }
#pragma unroll
  for (int i = 0; i < kStagePerThread; ++i) {
    const int e = threadIdx.x + i * kThreads;
    if (e >= n_e) break;
    const int pe = e / kChunk, se = e % kChunk;
    const int sp = min(s0 + se, lp - 1);
    const int l = sp / p.n_points;
    const int h = __ldg(p.shapes + 2 * l), w = __ldg(p.shapes + 2 * l + 1);
    const int start = __ldg(p.level_start + l);
    // clamped so that the int conversion is defined; outside [-2, W+1] every
    // corner is out of range either way
    const float x = fminf(fmaxf(xy[i].x * w - 0.5f, -2.f), (float)w + 1.f);
    const float y = fminf(fmaxf(xy[i].y * h - 0.5f, -2.f), (float)h + 1.f);
    const float xf = floorf(x), yf = floorf(y);
    const int x0 = (int)xf, y0 = (int)yf;
    const float lx = x - xf, ly = y - yf;
    const bool vx0 = x0 >= 0 && x0 < w, vx1 = x0 >= -1 && x0 < w - 1;
    const bool vy0 = y0 >= 0 && y0 < h, vy1 = y0 >= -1 && y0 < h - 1;
    const int cx0 = min(max(x0, 0), w - 1), cx1 = min(max(x0 + 1, 0), w - 1);
    const int r0 = start + min(max(y0, 0), h - 1) * w;
    const int r1 = start + min(max(y0 + 1, 0), h - 1) * w;
    const float ai = a[i];
    const int slot = se * (pb + 1) + pe;
    s_off[slot] = make_int4((r0 + cx0) * row_vecs, (r0 + cx1) * row_vecs,
                            (r1 + cx0) * row_vecs, (r1 + cx1) * row_vecs);
    s_w[slot] = make_float4((vy0 && vx0) ? ai * (1.f - ly) * (1.f - lx) : 0.f,
                            (vy0 && vx1) ? ai * (1.f - ly) * lx : 0.f,
                            (vy1 && vx0) ? ai * ly * (1.f - lx) : 0.f,
                            (vy1 && vx1) ? ai * ly * lx : 0.f);
  }
}

// LP: L*P when known at compile time (16 on the path), else 0. G: sample
// groups a pair's samples split over (1, or 4 with a shuffle reduction).
template <typename T, int VB, int LP, int G>
__global__ void __launch_bounds__(kThreads, kMinBlocks) ms_deform_attn_kernel(const Params p) {
  using V = typename VecType<VB>::type;
  constexpr int kLanes = VB / (int)sizeof(T);
  static_assert(kChunk % (G * kBatch) == 0, "a table fill is whole batches of every group");
  extern __shared__ int4 smem[];

  const int lp = LP > 0 ? LP : p.n_levels * p.n_points;
  const int ctn = p.chunk_threads;
  const int tpp = ctn * G;                             // threads per pair
  const int pb = kThreads / tpp;                       // pairs per block
  int4* s_off = smem;                                  // [kChunk][pb + 1]
  float4* s_w = reinterpret_cast<float4*>(smem + kChunk * (pb + 1));

  const long long pairs = (long long)p.b * p.q * p.m;
  const long long pair0 = (long long)blockIdx.x * pb;
  const int t = threadIdx.x;
  const int pl = t / tpp, g = t % tpp / ctn, ct = t % ctn;
  const long long pair = pair0 + pl;
  const bool live = pair < pairs;
  // pair == (bi * q + qi) * m + mi; the (bi, position 0, mi) row of value
  const long long pc = live ? pair : pairs - 1;
  const long long bi = pc / ((long long)p.q * p.m);
  const int mi = (int)(pc % p.m);
  const V* v_bm = reinterpret_cast<const V*>(static_cast<const T*>(p.value) +
                                             (bi * p.s * p.m + mi) * p.d);
  const int n_fills = (lp + kChunk - 1) / kChunk;

  for (int it = 0; it < p.chunk_iters; ++it) {
    const int c = ct + it * ctn;
    const bool c_ok = c < p.chunks;
    const V* base = v_bm + (c_ok ? c : 0);
    float acc[kLanes];
#pragma unroll
    for (int i = 0; i < kLanes; ++i) acc[i] = 0.f;

    for (int fill = 0; fill < n_fills; ++fill) {
      if (it == 0 || n_fills > 1) {                    // (re)fill the table
        if (it > 0 || fill > 0) __syncthreads();
        stage<VB>(p, lp, (int)sizeof(T), pair0, pairs, pb, fill * kChunk, s_off, s_w);
        __syncthreads();
      }
#pragma unroll 1
      for (int j0 = 0; j0 < kChunk / G; j0 += kBatch) {
        int4 o[kBatch];
        float4 wt[kBatch];
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const int slot = ((j0 + j) * G + g) * (pb + 1) + pl;
          o[j] = s_off[slot];
          wt[j] = s_w[slot];
        }
        V v[kBatch][4];
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          v[j][0] = __ldg(base + o[j].x);
          v[j][1] = __ldg(base + o[j].y);
          v[j][2] = __ldg(base + o[j].z);
          v[j][3] = __ldg(base + o[j].w);
        }
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const float cw[4] = {wt[j].x, wt[j].y, wt[j].z, wt[j].w};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            float f[kLanes];
            to_f32<T, VB>(v[j][k], f);
#pragma unroll
            for (int i = 0; i < kLanes; ++i) acc[i] = fmaf(cw[k], f[i], acc[i]);
          }
        }
      }
    }
    if constexpr (G > 1) {                             // the pair's groups meet
#pragma unroll
      for (int off = 1; off < G; off <<= 1) {
#pragma unroll
        for (int i = 0; i < kLanes; ++i)
          acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off * ctn);
      }
    }
    if (live && c_ok && g == 0) {
      V* dst = reinterpret_cast<V*>(static_cast<T*>(p.out) + pair * p.d);   // (B, Q, M, D)
      dst[c] = from_f32<T, VB>(acc);
    }
  }
}

template <typename T, int VB, int LP, int G>
cudaError_t launch(const Params& p, long long blocks, int pb, cudaStream_t st) {
  const size_t smem = (size_t)kChunk * (pb + 1) * (sizeof(int4) + sizeof(float4)) + kRawBytes;
  ms_deform_attn_kernel<T, VB, LP, G><<<(unsigned)blocks, kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

template <typename T, int VB>
cudaError_t launch_vb(const Params& p, int groups, long long blocks, int pb, cudaStream_t st) {
  if constexpr (VB == 16) {
    if (p.n_levels * p.n_points == 16)
      return groups == 4 ? launch<T, VB, 16, 4>(p, blocks, pb, st)
                         : launch<T, VB, 16, 1>(p, blocks, pb, st);
  }
  return groups == 4 ? launch<T, VB, 0, 4>(p, blocks, pb, st)
                     : launch<T, VB, 0, 1>(p, blocks, pb, st);
}

}  // namespace

// vec_bytes: 16, 8, 4 or 2 (bf16 only), dividing D * sizeof(T) and the
// addresses of value and out; chunk_threads: a power of two <= 32 with
// chunk_threads * groups in [4, 32]; groups: 1 or 4.
extern "C" int hipie_ms_deform_attn(const void* value, const void* shapes,
                                    const void* level_start, const void* loc,
                                    const void* attw, void* out, int b, int s, int m,
                                    int d, int q, int n_levels, int n_points,
                                    int value_is_bf16, int vec_bytes, int chunk_threads,
                                    int groups, void* stream) {
  const int elem = value_is_bf16 ? 2 : 4;
  const long long row = (long long)d * elem;
  const int tpp = chunk_threads * groups;
  const bool vec_ok = (vec_bytes == 16 || vec_bytes == 8 || vec_bytes == 4 ||
                       (vec_bytes == 2 && value_is_bf16)) &&
                      row % vec_bytes == 0 && (uintptr_t)value % vec_bytes == 0 &&
                      (uintptr_t)out % vec_bytes == 0;
  if (d <= 0 || d > 128 || b <= 0 || q <= 0 || m <= 0 || n_levels <= 0 || n_points <= 0 ||
      !vec_ok || (groups != 1 && groups != 4) || chunk_threads <= 0 || chunk_threads > 32 ||
      (chunk_threads & (chunk_threads - 1)) != 0 || tpp < kThreads / kMaxPairs || tpp > 32 ||
      (long long)s * m * d >= (1LL << 31) ||
      (HIPIE_MSDA_STAGE_CP_ASYNC && (n_levels * n_points != kChunk ||
                                     (uintptr_t)loc % 16 != 0 || (uintptr_t)attw % 16 != 0)))
    return (int)cudaErrorInvalidValue;
  Params p{value, static_cast<const int*>(shapes), static_cast<const int*>(level_start),
           static_cast<const float*>(loc), static_cast<const float*>(attw), out,
           b, s, m, d, q, n_levels, n_points, 0, chunk_threads, 0};
  p.chunks = (int)(row / vec_bytes);
  p.chunk_iters = (p.chunks + chunk_threads - 1) / chunk_threads;
  const int pb = kThreads / tpp;
  const long long blocks = ((long long)b * q * m + pb - 1) / pb;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (value_is_bf16) {
    switch (vec_bytes) {
      case 16: return launch_vb<__nv_bfloat16, 16>(p, groups, blocks, pb, st);
      case 8: return launch_vb<__nv_bfloat16, 8>(p, groups, blocks, pb, st);
      case 4: return launch_vb<__nv_bfloat16, 4>(p, groups, blocks, pb, st);
      default: return launch_vb<__nv_bfloat16, 2>(p, groups, blocks, pb, st);
    }
  }
  switch (vec_bytes) {
    case 16: return launch_vb<float, 16>(p, groups, blocks, pb, st);
    case 8: return launch_vb<float, 8>(p, groups, blocks, pb, st);
    default: return launch_vb<float, 4>(p, groups, blocks, pb, st);
  }
}

// The constants a launch plan rests on: block threads, samples per table
// fill, samples per gather batch, most pairs per block.
extern "C" int hipie_ms_deform_attn_constants(int* out) {
  out[0] = kThreads;
  out[1] = kChunk;
  out[2] = kBatch;
  out[3] = kMaxPairs;
  return 0;
}
