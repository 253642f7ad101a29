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
// (R50 training, B = 2, M = 8, D = 32, L = P = 4, bf16): the encoder at
// Q = S = 21760, the decoder at Q = 1110, MaskDINO's decoder at Q = 500; 21
// launches a step.
//
// What bounds it on the H100: the scatter. Each sample adds 4 corner rows of
// D values into the f32 gradient with atomics: at the encoder shape 5.57 M
// samples x 4 corners x 32 channels = 713 M f32 atomic adds, against 223 MB of
// inputs and outputs (0.067 ms at 3.35 TB/s). The atomics resolve in L2 (the
// 22 MB f32 gradient map fits in its 50 MB), so their rate, not HBM, sets the
// time. The design is the simple one: a group of threads per pair, each
// thread owning VC consecutive channels (4 where D and the row addresses
// allow it, else 1), so that the threads of a pair read a corner row and add
// into it as one contiguous stretch, and a warp's atomics go to whole rows.
// With VC = 4 a thread adds its 4 channels with one 16-byte vector atomic
// (atomicAdd on float4, sm_90), a quarter of the atomic instructions of
// scalar adds and a third of their time at the encoder shape.
// The four corner dots s_c are reduced across the pair's threads with warp
// shuffles, and one thread writes the sample's three scalar gradients. Pairs
// go out in query order, as in K-B, so neighbouring queries' corners meet in
// L2. Making the scatter cheaper (warp-aggregated adds of samples that share
// a corner row, or a gather formulation over value positions) is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <type_traits>

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

}  // namespace

// vec_channels: 4 (D % 4 == 0 and value, gout aligned to 4 elements) or 1;
// threads_per_pair: a power of two <= 32 with D / vec_channels <= 4 *
// threads_per_pair. grad_value must be zero on entry.
extern "C" int hipie_ms_deform_attn_bwd(const void* value, const void* shapes,
                                        const void* level_start, const void* loc,
                                        const void* attw, const void* gout, void* grad_value,
                                        void* grad_loc, void* grad_attw, int b, int s, int m,
                                        int d, int q, int n_levels, int n_points,
                                        int value_is_bf16, int vec_channels,
                                        int threads_per_pair, void* stream) {
  const int elem = value_is_bf16 ? 2 : 4;
  const int vb = vec_channels * elem;
  const int tpp = threads_per_pair;
  if (d <= 0 || d > 128 || b <= 0 || q <= 0 || m <= 0 || n_levels <= 0 || n_points <= 0 ||
      (vec_channels != 1 && vec_channels != 4) || d % vec_channels != 0 ||
      (uintptr_t)value % vb != 0 || (uintptr_t)gout % vb != 0 ||
      (uintptr_t)grad_loc % 8 != 0 || tpp <= 0 || tpp > 32 || (tpp & (tpp - 1)) != 0 ||
      d / vec_channels > kMaxVecs * tpp || (long long)s * m * d >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  Params p{value, static_cast<const int*>(shapes), static_cast<const int*>(level_start),
           static_cast<const float*>(loc), static_cast<const float*>(attw), gout,
           static_cast<float*>(grad_value), static_cast<float*>(grad_loc),
           static_cast<float*>(grad_attw), b, s, m, d, q, n_levels, n_points, tpp,
           d / vec_channels};
  const long long blocks = ((long long)b * q * m + kThreads / tpp - 1) / (kThreads / tpp);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (value_is_bf16)
    return vec_channels == 4 ? launch<__nv_bfloat16, 4>(p, blocks, st)
                             : launch<__nv_bfloat16, 1>(p, blocks, st);
  return vec_channels == 4 ? launch<float, 4>(p, blocks, st) : launch<float, 1>(p, blocks, st);
}
