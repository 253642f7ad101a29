// ViTDet global attention with the decomposed relative-position bias, backward
// (kernel K-E).
//
// Replaces: hipie_tpu/ops/pallas/vit_attention_kernel.py::_bwd_rule, the custom
// VJP of vit_global_attention (jax.vjp of _attention_xla, which materialises the
// (BH, N, N) f32 logits). With S = q.k * scale + rel_h[q, k / Kw] + rel_w[q, k % Kw]
// and P = softmax_k(S), given out = P.v (P rounded to bf16 before the product,
// as the forward), the per-row logsumexp lse of S (kernel K-A's second output)
// and the cotangent dout, it computes
//
//     D[q]        = sum_d dout[q, d] out[q, d]
//     P[q, k]     = exp(S[q, k] - lse[q])
//     dS[q, k]    = P[q, k] (dout[q] . v[k] - D[q])
//     dv          = P^T . dout                  dq = dS . k * scale
//     dk          = dS^T . q * scale
//     d rel_h[q, i] = sum_j dS[q, i Kw + j]       d rel_w[q, j] = sum_i dS[q, i Kw + j]
//
// q, k, v, out, dout: (BH, N, HD) bf16; rel_h (BH, N, Kh), rel_w (BH, N, Kw) bf16;
// lse (BH, N) f32; the five gradients in bf16, accumulated in f32. ViT-H
// training: BH = 16 per image, N = 4096, HD = 80, Kh = Kw = 64.
//
// What bounds it on the H100: the tensor cores. The least work is five
// products of 2 BH N^2 HD each (S, dP, dv, dk, dq): 429.5 GFLOP at BH = 32,
// 0.434 ms at 989 TFLOP/s bf16; the bytes (eight inputs read, five gradients
// written: 235 MB) take 0.070 ms at 3.35 TB/s. This kernel does seven
// products (S and dP are formed in both passes) with mma.sync, not wgmma.
//
// Design (simple and right first; no TMA, no wgmma):
//  * Two passes, no global atomics, both launched by the C entry point on the
//    caller's stream. Blocks of 4 warps own 64 rows; each warp 16 rows, the M
//    side of mma.sync.m16n8k16 (bf16 in, f32 accumulate). The other side
//    streams through shared memory in tiles of 64 rows (cp.async, double
//    buffered, rows past N zero-filled) and is consumed 16 rows at a time.
//  * Query-major pass (dq_kernel): per (bh, 64 queries), loop over key tiles.
//    q and dout stay in registers as A fragments; S = q.k^T and dP = dout.v^T
//    per 16-key chunk; P from lse, dS = P (dP - D); dq += dS.k with dS's
//    accumulator registers reused as the A fragment (bf16). It also forms D
//    for its rows (written for the second pass) and the bias gradients: with
//    Kw = 64 a key tile is one key row i, so d rel_h[q, i] is the tile's row
//    sum (quad shuffles, one store a row and tile) and d rel_w[q, j] stays in
//    registers across tiles (each thread owns 16 of a row's 64 columns).
//    Other Kw, and partial tiles, add each dS into shared rows of d rel_h and
//    d rel_w with shared-memory atomics.
//  * Key-major pass (dkv_kernel): per (bh, 64 keys), loop over query tiles
//    with their rel rows, lse and D. k and v stay in registers as A
//    fragments; S^T = k.q^T and dP^T = v.dout^T per 16-query chunk; dv += P^T.dout
//    (P^T rounded to bf16) and dk += dS^T.q, both from the accumulators.
//  * Operands come from shared memory by ldmatrix (.trans where the product
//    runs along the rows of the stored tile); rows of HD + 8 bf16 keep the
//    8-row ldmatrix reads free of bank conflicts. exp2 of the logits in
//    log2(e) units, as the forward.
// HD in {16, 64, 80} is built.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;          // rows a block owns, and rows of a streamed tile
constexpr int kFastKw = 64;                 // the key-grid width of the fast bias path
constexpr int kMaxSmem = 227 * 1024;
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct Dims {
  static_assert(HD % 16 == 0, "head dim: a multiple of 16");
  static constexpr int kStride = HD + 8;            // bf16 a shared row (16-byte aligned)
  static constexpr int kTileBytes = kRows * kStride * 2;
  static constexpr int kK16 = HD / 16;              // k16 steps over the head dim
  static constexpr int kN8 = HD / 8;                // n8 tiles over the head dim
};

// Shared rows of a rel table: even, so 4-byte copies stay aligned.
__host__ __device__ __forceinline__ int rel_stride(int width) { return (width + 2) & ~1; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared, asynchronously; zeros where !valid.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

// d (16 x 8, f32) += a (16 x 16, bf16, row-major) . b (16 x 8, bf16, col-major).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Fragment layouts of mma.m16n8k16 (lane l, g = l / 4, t = l % 4):
//  accumulator d[e]: row g + 8 (e / 2), column 2 t + (e % 2);
//  A a[r]: row g + 8 (r % 2), columns 2 t + 8 (r / 2) + {0, 1};
//  B b[r]: rows (k) 2 t + 8 r + {0, 1}, column (n) g.
// So the accumulators of two neighbouring n8 tiles are one k16 A fragment:
// a = {d0[0..1], d0[2..3], d1[0..1], d1[2..3]} packed to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&d)[2][4]) {
  a[0] = pack_bf16(d[0][0], d[0][1]);
  a[1] = pack_bf16(d[0][2], d[0][3]);
  a[2] = pack_bf16(d[1][0], d[1][1]);
  a[3] = pack_bf16(d[1][2], d[1][3]);
}

// ldmatrix addresses within a tile of rows (HD + 8 bf16 apart), lane l:
//  A fragment of rows r0..r0+15, columns c0..c0+15:  row r0 + l % 16, column c0 + 8 (l / 16).
//  B of S-like products (B[k = column][n = row]), two n8 tiles of rows
//    r0..r0+15, k16 columns c0..: row r0 + 8 (l / 16) + l % 8, column c0 + 8 (l / 8 % 2).
//  B of P.V-like products (B[k = row][n = column], .trans), k16 rows r0..,
//    two n8 tiles of columns c0..c0+15: row r0 + 8 (l / 8 % 2) + l % 8, column c0 + 8 (l / 16).
template <int HD>
__device__ __forceinline__ uint32_t addr_a(uint32_t tile, int r0, int c0, int lane) {
  return tile + ((r0 + lane % 16) * Dims<HD>::kStride + c0 + 8 * (lane / 16)) * 2;
}

template <int HD>
__device__ __forceinline__ uint32_t addr_b(uint32_t tile, int r0, int c0, int lane) {
  return tile + ((r0 + 8 * (lane / 16) + lane % 8) * Dims<HD>::kStride + c0 + 8 * (lane / 8 % 2)) * 2;
}

template <int HD>
__device__ __forceinline__ uint32_t addr_bt(uint32_t tile, int r0, int c0, int lane) {
  return tile + ((r0 + 8 * (lane / 8 % 2) + lane % 8) * Dims<HD>::kStride + c0 + 8 * (lane / 16)) * 2;
}

// Rows r0 .. r0 + 63 of a (N, HD) bf16 matrix into a shared tile; rows past N read as zeros.
template <int HD>
__device__ __forceinline__ void load_rows(uint32_t dst, const __nv_bfloat16* src, int r0, int n) {
  constexpr int kVec = HD / 8;                           // 16-byte pieces a row
  for (int i = threadIdx.x; i < kRows * kVec; i += kThreads) {
    const int r = i / kVec, c = i % kVec;
    const bool ok = r0 + r < n;
    cp_async16(dst + (r * Dims<HD>::kStride + 8 * c) * 2,
               src + static_cast<size_t>(ok ? r0 + r : 0) * HD + 8 * c, ok);
  }
}

// Rows r0 .. r0 + 63 of a (N, width) bf16 rel table into shared rows
// rel_stride(width) apart; rows past N read as zeros. Even widths copy 4 bytes
// at a time, asynchronously; odd ones element by element.
__device__ __forceinline__ void load_rel(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                         int width, int r0, int n) {
  const int stride = rel_stride(width);
  if (width % 2 == 0) {
    const int pairs = width / 2;
    for (int i = threadIdx.x; i < kRows * pairs; i += kThreads) {
      const int r = i / pairs, c = i % pairs;
      const bool ok = r0 + r < n;
      cp_async4(smem_u32(dst + r * stride + 2 * c),
                src + static_cast<size_t>(ok ? r0 + r : 0) * width + 2 * c, ok);
    }
  } else {
    for (int i = threadIdx.x; i < kRows * width; i += kThreads) {
      const int r = i / width, c = i % width;
      dst[r * stride + c] = r0 + r < n ? src[static_cast<size_t>(r0 + r) * width + c]
                                       : __float2bfloat16(0.f);
    }
  }
}

// 64 f32 of a (N,) row vector from r0 into shared; past N zeros.
__device__ __forceinline__ void load_vec(float* dst, const float* src, int r0, int n) {
  for (int i = threadIdx.x; i < kRows; i += kThreads) {
    const bool ok = r0 + i < n;
    cp_async4(smem_u32(dst + i), src + (ok ? r0 + i : 0), ok);
  }
}

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// ---------------------------------------------------------------------------
// Query-major pass: dq, d rel_h, d rel_w and D for 64 queries of one bh.
// Shared: [K, V] x 2 stages | lse | D | rel_h rows | rel_w rows | dh (f32) | dw (f32)
template <int HD, bool kFast>
__global__ void __launch_bounds__(kThreads, 2)
dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
          const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ rel_h,
          const __nv_bfloat16* __restrict__ rel_w, const __nv_bfloat16* __restrict__ out,
          const float* __restrict__ lse, const __nv_bfloat16* __restrict__ dout,
          __nv_bfloat16* __restrict__ dq, __nv_bfloat16* __restrict__ drel_h,
          __nv_bfloat16* __restrict__ drel_w, float* __restrict__ dvec,
          int n, int kh, int kw, float scale) {
  using D = Dims<HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int sh = rel_stride(kh), sw = rel_stride(kw);
  const uint32_t base = smem_u32(smem);
  auto tile_k = [&](int s) { return base + (2 * s) * D::kTileBytes; };
  auto tile_v = [&](int s) { return base + (2 * s + 1) * D::kTileBytes; };
  float* lse_s = reinterpret_cast<float*>(smem + 4 * D::kTileBytes);
  float* d_s = lse_s + kRows;
  __nv_bfloat16* rh_s = reinterpret_cast<__nv_bfloat16*>(d_s + kRows);
  __nv_bfloat16* rw_s = rh_s + kRows * sh;
  float* dh_s = reinterpret_cast<float*>(rw_s + kRows * sw);
  float* dw_s = dh_s + kRows * kh;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const size_t off = static_cast<size_t>(bh) * n;
  const int n_tiles = (n + kRows - 1) / kRows;

  // q and dout into stage 1's slots (read once into registers), the block's
  // rel rows and lse; then the first K and V tile.
  load_rows<HD>(tile_k(1), q + off * HD, q0, n);
  load_rows<HD>(tile_v(1), dout + off * HD, q0, n);
  load_rel(rh_s, rel_h + off * kh, kh, q0, n);
  load_rel(rw_s, rel_w + off * kw, kw, q0, n);
  load_vec(lse_s, lse + off, q0, n);
  cp_async_commit();
  load_rows<HD>(tile_k(0), k + off * HD, 0, n);
  load_rows<HD>(tile_v(0), v + off * HD, 0, n);
  cp_async_commit();
  for (int i = threadIdx.x; i < kRows * (kh + kw); i += kThreads) dh_s[i] = 0.f;
  {
    // D = rowsum(dout * out): two threads a row, half the head dim each.
    const int r = threadIdx.x / 2, half = threadIdx.x % 2;
    float acc = 0.f;
    if (q0 + r < n) {
      const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(out + (off + q0 + r) * HD);
      const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(dout + (off + q0 + r) * HD);
#pragma unroll
      for (int c = half * HD / 4; c < (half + 1) * HD / 4; ++c) {
        const float2 a = __bfloat1622float2(o2[c]), b = __bfloat1622float2(g2[c]);
        acc = fmaf(a.x, b.x, fmaf(a.y, b.y, acc));
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      d_s[r] = acc;
      if (q0 + r < n) dvec[off + q0 + r] = acc;
    }
  }
  cp_async_wait<1>();
  __syncthreads();

  uint32_t qa[D::kK16][4], da[D::kK16][4];
#pragma unroll
  for (int ks = 0; ks < D::kK16; ++ks) {
    ldsm_x4(qa[ks], addr_a<HD>(tile_k(1), 16 * warp, 16 * ks, lane));
    ldsm_x4(da[ks], addr_a<HD>(tile_v(1), 16 * warp, 16 * ks, lane));
  }
  const int row[2] = {16 * warp + g, 16 * warp + g + 8};     // the thread's rows in the block
  float nl2[2], dr[2];                                        // -lse log2(e), D
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    nl2[i] = -lse_s[row[i]] * kLog2e;
    dr[i] = d_s[row[i]];
  }
  float acc_dq[D::kN8][4];
#pragma unroll
  for (int j = 0; j < D::kN8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dq[j][e] = 0.f;
  float acc_dw[4][2][4];                                     // fast path: d rel_w in registers
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_dw[c][j][e] = 0.f;
  __syncthreads();                                           // stage 1 is free again

  for (int kt = 0; kt < n_tiles; ++kt) {
    if (kt + 1 < n_tiles) {
      const int s = (kt + 1) % 2;
      load_rows<HD>(tile_k(s), k + off * HD, (kt + 1) * kRows, n);
      load_rows<HD>(tile_v(s), v + off * HD, (kt + 1) * kRows, n);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t ks_tile = tile_k(kt % 2), vs_tile = tile_v(kt % 2);
    const int k0 = kt * kRows;
    float rh[2] = {0.f, 0.f}, dh_part[2] = {0.f, 0.f};
    if constexpr (kFast) {
#pragma unroll
      for (int i = 0; i < 2; ++i) rh[i] = __bfloat162float(rh_s[row[i] * sh + kt]);
    }
#pragma unroll
    for (int c = 0; c < kRows / 16; ++c) {
      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      float dp[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int ks = 0; ks < D::kK16; ++ks) {
        uint32_t b[4];
        ldsm_x4(b, addr_b<HD>(ks_tile, 16 * c, 16 * ks, lane));
        mma(s[0], qa[ks], b[0], b[1]);
        mma(s[1], qa[ks], b[2], b[3]);
        ldsm_x4(b, addr_b<HD>(vs_tile, 16 * c, 16 * ks, lane));
        mma(dp[0], da[ks], b[0], b[1]);
        mma(dp[1], da[ks], b[2], b[3]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e / 2;
          const int col = 16 * c + 8 * j + 2 * t + e % 2;    // key within the tile
          float x, ds;
          if constexpr (kFast) {
            const uint32_t w = *reinterpret_cast<const uint32_t*>(rw_s + row[i] * sw + col - e % 2);
            x = fmaf(s[j][e], scale, rh[i] + (e % 2 ? bf16_hi(w) : bf16_lo(w)));
            const float p = fast_exp2(fmaf(x, kLog2e, nl2[i]));
            ds = p * (dp[j][e] - dr[i]);
            dh_part[i] += ds;
            acc_dw[c][j][e] += ds;
          } else {
            const int key = k0 + col;
            const int kc = min(key, n - 1);
            const int ih = kc / kw, iw = kc - ih * kw;
            x = fmaf(s[j][e], scale, __bfloat162float(rh_s[row[i] * sh + ih])
                                     + __bfloat162float(rw_s[row[i] * sw + iw]));
            const float p = key < n ? fast_exp2(fmaf(x, kLog2e, nl2[i])) : 0.f;
            ds = p * (dp[j][e] - dr[i]);
            if (key < n) {
              atomicAdd(dh_s + row[i] * kh + ih, ds);
              atomicAdd(dw_s + row[i] * kw + iw, ds);
            }
          }
          s[j][e] = ds;
        }
      uint32_t a[4];
      acc_to_a(a, s);
#pragma unroll
      for (int dn = 0; dn < D::kK16; ++dn) {
        uint32_t b[4];
        ldsm_x4_t(b, addr_bt<HD>(ks_tile, 16 * c, 16 * dn, lane));
        mma(acc_dq[2 * dn], a, b[0], b[1]);
        mma(acc_dq[2 * dn + 1], a, b[2], b[3]);
      }
    }
    if constexpr (kFast) {
      // the tile is key row kt: d rel_h[q, kt] is the row's sum over the quad
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float v_ = dh_part[i];
        v_ += __shfl_xor_sync(0xffffffffu, v_, 1);
        v_ += __shfl_xor_sync(0xffffffffu, v_, 2);
        if (t == 0) dh_s[row[i] * kh + kt] = v_;
      }
    }
    __syncthreads();                                         // the stage may be refilled
  }

  if constexpr (kFast) {
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dw_s[row[e / 2] * kw + 16 * c + 8 * j + 2 * t + e % 2] = acc_dw[c][j][e];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (q0 + row[i] >= n) continue;
    __nv_bfloat16* dst = dq + (off + q0 + row[i]) * HD + 2 * t;
#pragma unroll
    for (int j = 0; j < D::kN8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
          __floats2bfloat162_rn(acc_dq[j][2 * i] * scale, acc_dq[j][2 * i + 1] * scale);
  }
  __syncthreads();
  const int rows = min(kRows, n - q0);
  for (int i = threadIdx.x; i < rows * kh; i += kThreads)
    drel_h[(off + q0) * kh + i] = __float2bfloat16(dh_s[i]);
  for (int i = threadIdx.x; i < rows * kw; i += kThreads)
    drel_w[(off + q0) * kw + i] = __float2bfloat16(dw_s[i]);
}

// ---------------------------------------------------------------------------
// Key-major pass: dk and dv for 64 keys of one bh.
// Shared, per stage: q | dout | lse | D | rel_h rows | rel_w rows (of 64 queries)
template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
dkv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
           const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ rel_h,
           const __nv_bfloat16* __restrict__ rel_w, const float* __restrict__ lse,
           const __nv_bfloat16* __restrict__ dout, const float* __restrict__ dvec,
           __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
           int n, int kh, int kw, float scale) {
  using D = Dims<HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int sh = rel_stride(kh), sw = rel_stride(kw);
  const int stage_bytes = 2 * D::kTileBytes + 2 * kRows * 4 + 2 * kRows * (sh + sw);
  auto stage = [&](int s) { return smem + s * stage_bytes; };
  auto tile_q = [&](int s) { return smem_u32(stage(s)); };
  auto tile_do = [&](int s) { return smem_u32(stage(s)) + D::kTileBytes; };
  auto lse_of = [&](int s) { return reinterpret_cast<float*>(stage(s) + 2 * D::kTileBytes); };
  auto d_of = [&](int s) { return lse_of(s) + kRows; };
  auto rh_of = [&](int s) { return reinterpret_cast<__nv_bfloat16*>(d_of(s) + kRows); };
  auto rw_of = [&](int s) { return rh_of(s) + kRows * sh; };
  auto load_stage = [&](int s, int r0, size_t off) {
    load_rows<HD>(tile_q(s), q + off * HD, r0, n);
    load_rows<HD>(tile_do(s), dout + off * HD, r0, n);
    load_vec(lse_of(s), lse + off, r0, n);
    load_vec(d_of(s), dvec + off, r0, n);
    load_rel(rh_of(s), rel_h + off * kh, kh, r0, n);
    load_rel(rw_of(s), rel_w + off * kw, kw, r0, n);
  };

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const size_t off = static_cast<size_t>(bh) * n;
  const int n_tiles = (n + kRows - 1) / kRows;

  // k and v into stage 1's q and dout slots (read once into registers), then
  // the first query tile.
  load_rows<HD>(tile_q(1), k + off * HD, k0, n);
  load_rows<HD>(tile_do(1), v + off * HD, k0, n);
  cp_async_commit();
  load_stage(0, 0, off);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  uint32_t ka[D::kK16][4], va[D::kK16][4];
#pragma unroll
  for (int ks = 0; ks < D::kK16; ++ks) {
    ldsm_x4(ka[ks], addr_a<HD>(tile_q(1), 16 * warp, 16 * ks, lane));
    ldsm_x4(va[ks], addr_a<HD>(tile_do(1), 16 * warp, 16 * ks, lane));
  }
  // the thread's two keys and their (row, column) on the key grid
  int ih[2], iw[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = min(k0 + 16 * warp + g + 8 * i, n - 1);
    ih[i] = key / kw;
    iw[i] = key - ih[i] * kw;
  }
  float acc_dk[D::kN8][4], acc_dv[D::kN8][4];
#pragma unroll
  for (int j = 0; j < D::kN8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[j][e] = acc_dv[j][e] = 0.f;
  __syncthreads();                                           // stage 1 is free again

  for (int qt = 0; qt < n_tiles; ++qt) {
    if (qt + 1 < n_tiles) {
      load_stage((qt + 1) % 2, (qt + 1) * kRows, off);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int s_ = qt % 2;
    const uint32_t qs_tile = tile_q(s_), dos_tile = tile_do(s_);
    const float* lse_s = lse_of(s_);
    const float* d_s = d_of(s_);
    const __nv_bfloat16* rh_s = rh_of(s_);
    const __nv_bfloat16* rw_s = rw_of(s_);
    const int q0 = qt * kRows;
#pragma unroll
    for (int c = 0; c < kRows / 16; ++c) {
      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      float dp[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int ks = 0; ks < D::kK16; ++ks) {
        uint32_t b[4];
        ldsm_x4(b, addr_b<HD>(qs_tile, 16 * c, 16 * ks, lane));
        mma(s[0], ka[ks], b[0], b[1]);
        mma(s[1], ka[ks], b[2], b[3]);
        ldsm_x4(b, addr_b<HD>(dos_tile, 16 * c, 16 * ks, lane));
        mma(dp[0], va[ks], b[0], b[1]);
        mma(dp[1], va[ks], b[2], b[3]);
      }
      float p[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e / 2;                               // which of the thread's keys
          const int ql = 16 * c + 8 * j + 2 * t + e % 2;     // query within the tile
          const float x = fmaf(s[j][e], scale, __bfloat162float(rh_s[ql * sh + ih[i]])
                                               + __bfloat162float(rw_s[ql * sw + iw[i]]));
          const float pe = q0 + ql < n ? fast_exp2(fmaf(x, kLog2e, -lse_s[ql] * kLog2e)) : 0.f;
          p[j][e] = pe;
          s[j][e] = pe * (dp[j][e] - d_s[ql]);
        }
      uint32_t ap[4], ads[4];
      acc_to_a(ap, p);
      acc_to_a(ads, s);
#pragma unroll
      for (int dn = 0; dn < D::kK16; ++dn) {
        uint32_t b[4];
        ldsm_x4_t(b, addr_bt<HD>(dos_tile, 16 * c, 16 * dn, lane));
        mma(acc_dv[2 * dn], ap, b[0], b[1]);
        mma(acc_dv[2 * dn + 1], ap, b[2], b[3]);
        ldsm_x4_t(b, addr_bt<HD>(qs_tile, 16 * c, 16 * dn, lane));
        mma(acc_dk[2 * dn], ads, b[0], b[1]);
        mma(acc_dk[2 * dn + 1], ads, b[2], b[3]);
      }
    }
    __syncthreads();                                         // the stage may be refilled
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + 16 * warp + g + 8 * i;
    if (key >= n) continue;
    const size_t at = (off + key) * HD + 2 * t;
#pragma unroll
    for (int j = 0; j < D::kN8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dk + at + 8 * j) =
          __floats2bfloat162_rn(acc_dk[j][2 * i] * scale, acc_dk[j][2 * i + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + at + 8 * j) =
          __floats2bfloat162_rn(acc_dv[j][2 * i], acc_dv[j][2 * i + 1]);
    }
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* rel_h,
                   const void* rel_w, const void* out, const void* lse, const void* dout,
                   void* dq, void* dk, void* dv, void* drel_h, void* drel_w, void* dvec,
                   int bh, int n, int kh, int kw, float scale, cudaStream_t stream) {
  using D = Dims<HD>;
  const size_t rel = 2ull * kRows * (rel_stride(kh) + rel_stride(kw));
  const size_t q_bytes = 4ull * D::kTileBytes + 2 * kRows * 4 + rel + 4ull * kRows * (kh + kw);
  const size_t kv_bytes = 2 * (2ull * D::kTileBytes + 2 * kRows * 4 + rel);
  if (q_bytes > kMaxSmem || kv_bytes > kMaxSmem) return cudaErrorInvalidValue;
  auto kq = kw == kFastKw ? dq_kernel<HD, true> : dq_kernel<HD, false>;
  cudaError_t err = cudaFuncSetAttribute(kq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(q_bytes));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dkv_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kv_bytes));
  if (err != cudaSuccess) return err;
  const auto* bq = static_cast<const __nv_bfloat16*>(q);
  const auto* bk = static_cast<const __nv_bfloat16*>(k);
  const auto* bv = static_cast<const __nv_bfloat16*>(v);
  const auto* brh = static_cast<const __nv_bfloat16*>(rel_h);
  const auto* brw = static_cast<const __nv_bfloat16*>(rel_w);
  const auto* bdo = static_cast<const __nv_bfloat16*>(dout);
  const auto* flse = static_cast<const float*>(lse);
  dim3 grid((n + kRows - 1) / kRows, bh);
  kq<<<grid, kThreads, q_bytes, stream>>>(
      bq, bk, bv, brh, brw, static_cast<const __nv_bfloat16*>(out), flse, bdo,
      static_cast<__nv_bfloat16*>(dq), static_cast<__nv_bfloat16*>(drel_h),
      static_cast<__nv_bfloat16*>(drel_w), static_cast<float*>(dvec), n, kh, kw, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkv_kernel<HD><<<grid, kThreads, kv_bytes, stream>>>(
      bq, bk, bv, brh, brw, flse, bdo, static_cast<const float*>(dvec),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), n, kh, kw, scale);
  return cudaGetLastError();
}

}  // namespace

// dvec: (BH, N) f32 scratch for D, written by the first pass, read by the second.
extern "C" int hipie_vit_attention_bwd(const void* q, const void* k, const void* v,
                                       const void* rel_h, const void* rel_w, const void* out,
                                       const void* lse, const void* dout, void* dq, void* dk,
                                       void* dv, void* drel_h, void* drel_w, void* dvec,
                                       int bh, int n, int hd, int kh, int kw, float scale,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bh <= 0 || n <= 0 || kh * kw != n) return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 16: return launch<16>(q, k, v, rel_h, rel_w, out, lse, dout, dq, dk, dv, drel_h, drel_w,
                               dvec, bh, n, kh, kw, scale, s);
    case 64: return launch<64>(q, k, v, rel_h, rel_w, out, lse, dout, dq, dk, dv, drel_h, drel_w,
                               dvec, bh, n, kh, kw, scale, s);
    case 80: return launch<80>(q, k, v, rel_h, rel_w, out, lse, dout, dq, dk, dv, drel_h, drel_w,
                               dvec, bh, n, kh, kw, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
