// Weighted segment sum of gathered corner rows, the reduce half of MSDA "flat4".
//
// Replaces: hipie_tpu/ops/pallas/msda_reduce_kernel.py::msda_weighted_segment_sum
// (Pallas `_kernel`). For g (N, 4d) corner-packed rows gathered from the quad
// tables and cw (N, 4) per-corner weights (bilinear x attention, zero out of
// range), with N = S * K:
//
//     out[s, c] = sum_{r < K} float(g[s*K + r, c]) * float(cw[s*K + r, c / d])
//
// in f32; out is (S, 4d) f32 and the caller folds the 4 corners. g and cw are
// both bf16 ("flat4_bf16") or both f32 ("flat4"). Main path (R50, 800x1216
// canvas): K = L*P = 16, d = 32, so 4d = 128 and N = Q*M*K with Q = 20197
// (6 encoder layers: N = 2,585,216), 910 (6 decoder layers) and 300 (9
// MaskDINO decoder layers).
//
// What bounds it on the H100: one read of g, ~10 bytes of traffic per FLOP
// pair. At the encoder shape g is 662 MB in bf16 (1.3 GB in f32), ~0.2 ms at
// 3.35 TB/s; cw adds 1/32 of that and the output 1/16. There is no matmul.
//
// Design: one warp per segment. Each lane owns 4 consecutive columns of the
// 4d-wide row, so a warp reads a row as one coalesced 256 B (bf16) or 512 B
// (f32) sweep with 8- or 16-byte vector loads; rows wider than 128 columns
// loop over column groups. A column's corner is col / d; the lane reads that
// corner's weight from the row's 4 weights (a broadcast within the warp). The
// K rows of the segment are summed in f32 registers and written once. The TPU
// kernel's block padding and its one-hot (4 -> 4d) corner expansion on the
// MXU are layout devices for the TPU and are not carried over. K and d are
// runtime arguments; the wrapper checks N % K == 0, the dtypes and 16-byte
// alignment.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ inline float to_f32(float x) { return x; }
__device__ inline float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ inline void load4(const float* p, float v[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}

__device__ inline void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.y));
  v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
}

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
msda_reduce_kernel(const T* __restrict__ g, const T* __restrict__ cw, float* __restrict__ out,
                   long long n_seg, int k, int d) {
  const long long seg = (long long)blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (seg >= n_seg) return;
  const int fd = 4 * d;
  const T* g_s = g + seg * k * fd;
  const T* cw_s = cw + seg * k * 4;
  float* o = out + seg * fd;
  for (int c0 = 4 * lane; c0 < fd; c0 += 128) {
    int corner[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) corner[j] = (c0 + j) / d;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int r = 0; r < k; ++r) {
      float v[4];
      load4(g_s + (long long)r * fd + c0, v);
      const T* w = cw_s + 4 * r;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] += v[j] * to_f32(w[corner[j]]);
    }
    *reinterpret_cast<float4*>(o + c0) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  }
}

template <typename T>
cudaError_t launch(const void* g, const void* cw, void* out, long long n_seg, int k, int d,
                   cudaStream_t stream) {
  const unsigned int blocks = (unsigned int)((n_seg + kWarpsPerBlock - 1) / kWarpsPerBlock);
  msda_reduce_kernel<T><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(cw), static_cast<float*>(out), n_seg, k,
      d);
  return cudaGetLastError();
}

}  // namespace

extern "C" int hipie_msda_reduce(const void* g, const void* cw, void* out, long long n_seg,
                                 int k, int d, int is_bf16, void* stream) {
  if (n_seg <= 0 || k <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch<__nv_bfloat16>(g, cw, out, n_seg, k, d, st);
  return launch<float>(g, cw, out, n_seg, k, d, st);
}
