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
// training: BH = 16 per image (32 at batch 2), N = 4096, HD = 80, Kh = Kw = 64.
//
// What bounds it on the H100: the tensor cores. The least work is five
// products of 2 BH N^2 HD each (S, dP, dv, dk, dq): 429.5 GFLOP at BH = 32,
// 0.4343 ms at 989 TFLOP/s bf16; the bytes (eight inputs read, five gradients
// written: 235 MB) take 0.070 ms at 3.35 TB/s. Both designs below do seven
// products (S and dP are formed in both passes): their floor is 0.608 ms.
//
// Two designs, chosen by shape in the C entry point (takes_wgmma), not as a
// fallback: a launch that fails returns its error.
//
// The wgmma design (the shape class of every ViT-H and ViT-L training call:
// Kw = 64, HD 64 or 80, N a multiple of 128). Against what holds the
// mma.sync design back:
//  * wgmma, not mma.sync, in both passes: a block of two warpgroups covers 128
//    own rows of one bh (64 rows each, the M side of wgmma), one block an SM;
//    while one warpgroup runs its exponentials the other's products hold the
//    tensor cores. There is no producer warpgroup: ptxas fits every thread of
//    a block into 65536 / threads registers, whatever setmaxnreg asks for at
//    run time, and at 384 threads (168 registers) these consumers spilled and
//    ptxas serialised their wgmmas. At 256 threads they take 192-212
//    registers without spills, and thread 0 issues the TMA loads.
//  * TMA loads into a ring of 4 stages of 64 streamed rows guarded by
//    full/empty mbarriers, in place of cp.async double buffering with two
//    __syncthreads a tile: thread 0 refills a stage as soon as all eight warps
//    have released it, up to 4 tiles ahead. HD = 80 is a 64-column box with
//    the 128-byte swizzle and a 16-column box with the 32-byte swizzle, as K-A.
//  * 128 own rows a block, not 64: each block streams the other side of its bh
//    once, so the streamed bytes (from L2) halve.
//  * Streamed tiles of 64 rows: one key row of the 64-wide key grid. In the
//    query-major pass (bwd_q_wgmma: dq, D, d rel_h, d rel_w) S = Q.K^T and
//    dP = dO.V^T are wgmma m64n64 with both operands in shared memory;
//    P = exp2(S scale log2(e) + rel_w log2(e) + (rel_h - lse) log2(e)) and
//    dS = P (dP - D) in registers; dq += dS.K with dS as the register A
//    operand (bf16) and the same K tile as the MN-major B operand. A thread's
//    32 rel_w values are the same in every tile (a tile is a key row) and stay
//    in registers; rel_h[q, kt] - lse is one value a row and tile; d rel_h[q, kt]
//    is a quad-shuffle row sum, d rel_w accumulates in registers across tiles.
//  * The key-major pass (bwd_kv_wgmma: dk, dv) forms S^T = K.Q^T and
//    dP^T = V.dO^T (wgmma, K and V own, Q and dO streamed), then dv += P^T.dO
//    and dk += dS^T.Q with P^T and dS^T from the accumulators as register A
//    operands and dO and Q as MN-major B operands: no transpose goes through
//    shared memory. Its bias is read in the accumulator's layout, where the
//    mma.sync design makes four scalar shared loads an element:
//    ldmatrix.x4.trans of the staged rel_w tile (TMA, 128-byte swizzle) hands
//    thread (g, t) exactly rel_w[q = 2t, 2t+1][j = g] of each 8 x 8 block,
//    the bias of its S^T elements; rel_h[q, i] - lse[q] is folded, once per
//    (key row, query), by the query-major pass into a table (below), and
//    arrives with D by TMA: one float2 of each per n8 block.
//  * Why two passes and not one with atomics: a one-pass key-major kernel adds
//    dq and d rel_w across blocks, about 335 M and up to 537 M f32 atomic adds
//    at BH = 32, where K-D's 713 M take about 1 ms on this card.
//  * D = rowsum(dout * out) is formed by the query-major pass, written to the
//    scratch dvec, and so is the fold table: the scratch is (BH, 1 + Kh, N)
//    f32, D first (BH, N), then fold (BH, Kh, N) = (rel_h[q, i] - lse[q]) log2(e).
//  * Tried and not kept (each a variant source timed in turns with this one):
//    ping-pong turns between the warpgroups (named barriers, as K-A) was much
//    slower here; ring depths of 3 to 6 stages changed nothing; the own rows'
//    operand read once into registers (wgmma with A from registers for S and
//    dP) gained little, with more registers; 2-CTA clusters whose blocks
//    share each streamed stage by TMA multicast (half the L2 reads) gained
//    under 1%, so the streamed bytes do not bound it.
//
// The mma.sync design (every other shape: Kw != 64, N not a multiple of
// 128, HD 16), simple and right first:
//  * Two passes, no global atomics. Blocks of 4 warps own 64 rows; each warp
//    16 rows, the M side of mma.sync.m16n8k16 (bf16 in, f32 accumulate). The
//    other side streams through shared memory in tiles of 64 rows (cp.async,
//    double buffered, rows past N zero-filled) and is consumed 16 rows at a time.
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
//    8-row ldmatrix reads free of bank conflicts.
// Both: exp2 of the logits in log2(e) units, as the forward; P rounded to bf16
// for dv and dS for dq and dk, each gradient once. HD in {16, 64, 80} is built.

#include <math.h>

#include "hopper.cuh"

namespace {

// ===========================================================================
// The mma.sync design.

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
cudaError_t launch_mma(const void* q, const void* k, const void* v, const void* rel_h,
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

// ===========================================================================
// The wgmma design: Kw = 64, HD in {64, 80}, N a multiple of 128.
//
// Both passes: 256 threads (two warpgroups of 64 own rows, the block's 128),
// one block an SM. The own tiles are loaded once; the other side streams
// through a ring of kWgStages stages of 64 rows. Thread 0 issues every TMA load.

constexpr int kOwnRows = 128;                 // own rows a block covers
constexpr int kStreamRows = 64;               // streamed rows a stage: one key row of the grid
constexpr int kWgStages = 4;
constexpr int kWgThreads = 256;               // no producer warpgroup: see the header note
constexpr int kBarConsumers = 1;              // named barrier of the block's 256 threads

// A tile of ROWS rows of a (BH, N, HD) tensor in shared memory: the 64-column
// box (128-byte rows, 128-byte swizzle) of all ROWS rows, then each 16-column
// slab (32-byte rows, 32-byte swizzle) of all ROWS rows. Loaded as 64-row
// boxes; a 128-row tile is two boxes a part, so one descriptor formula covers
// both sizes.
template <int HD, int ROWS>
struct WTile {
  static constexpr int kSlabs = (HD - 64) / 16;
  static_assert(HD == 64 || HD == 80, "the wgmma design takes HD 64 or 80");
  static constexpr int kWideBytes = ROWS * 128;
  static constexpr int kSlabBytes = ROWS * 32;
  static constexpr int kBytes = kWideBytes + kSlabs * kSlabBytes;
  static_assert(kBytes % 1024 == 0, "tiles stay 1024-byte aligned");
};

template <int HD, int ROWS>
__device__ __forceinline__ void load_wtile(uint32_t dst, const CUtensorMap* wide,
                                           const CUtensorMap* slab, uint32_t bar, int row, int bh) {
  using T = WTile<HD, ROWS>;
#pragma unroll
  for (int r = 0; r < ROWS; r += kStreamRows) {
    tma_load_3d(dst + r * 128, wide, bar, 0, row + r, bh);
#pragma unroll
    for (int c = 0; c < T::kSlabs; ++c)
      tma_load_3d(dst + T::kWideBytes + c * T::kSlabBytes + r * 32, slab, bar, 64 + 16 * c,
                  row + r, bh);
  }
}

// acc (64 x 64) = own[wg's 64 rows] . stream^T over the head dim: both operands
// K-major in shared memory (S = Q.K^T, dP = dO.V^T, and their transposes).
template <int HD>
__device__ __forceinline__ void issue_ss(float (&acc)[32], uint32_t own, int wg, uint32_t stream) {
  using A = WTile<HD, kOwnRows>;
  using B = WTile<HD, kStreamRows>;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss_n64(acc, desc(own + wg * 64 * 128 + kk * 32, 16, 1024, kLayoutB128),
                 desc(stream + kk * 32, 16, 1024, kLayoutB128), kk > 0);
#pragma unroll
  for (int c = 0; c < A::kSlabs; ++c)
    wgmma_ss_n64(acc, desc(own + A::kWideBytes + c * A::kSlabBytes + wg * 64 * 32, 16, 256,
                           kLayoutB32),
                 desc(stream + B::kWideBytes + c * B::kSlabBytes, 16, 256, kLayoutB32), 1);
}

// o (64 x HD) += a (64 x 64, bf16 registers, 4 k16 steps) . stream (64 x HD):
// the stream tile is the MN-major B operand (dq += dS.K, dv += P^T.dO,
// dk += dS^T.Q). The n64 accumulators and each n16 one are consecutive
// registers of the m64nHD fragment.
template <int HD>
__device__ __forceinline__ void issue_rs(float (&o)[HD / 2], const uint32_t (&a)[16],
                                         uint32_t stream) {
  using B = WTile<HD, kStreamRows>;
#pragma unroll
  for (int ks = 0; ks < kStreamRows / 16; ++ks) {
    wgmma_rs_n64(o, &a[4 * ks], desc(stream + ks * 16 * 128, 16, 1024, kLayoutB128));
#pragma unroll
    for (int c = 0; c < B::kSlabs; ++c)
      wgmma_rs_n16(o + 32 + 8 * c, &a[4 * ks],
                   desc(stream + B::kWideBytes + c * B::kSlabBytes + ks * 16 * 32, B::kSlabBytes,
                        256, kLayoutB32));
  }
}

// Accumulator fragment of wgmma m64nN (f32), thread l of the warpgroup's warp
// w, g = l / 4, t = l % 4: register 4 j + 2 i + c holds row 16 w + g + 8 i and
// column 8 j + 2 t + c. The register A operand of k16 step s is registers
// 8 s .. 8 s + 7 packed in pairs (to_a), so P and dS go from the accumulators
// of one product to the A operand of the next unmoved.
__device__ __forceinline__ void to_a(const float (&acc)[32], uint32_t (&a)[16]) {
#pragma unroll
  for (int r = 0; r < 16; ++r) a[r] = pack_bf16(acc[2 * r], acc[2 * r + 1]);
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

template <int HD>
struct QSmem {   // query-major pass
  static constexpr int kOwn = WTile<HD, kOwnRows>::kBytes;
  static constexpr int kStream = WTile<HD, kStreamRows>::kBytes;
  static constexpr int kQ = 0, kDo = kOwn;                   // own q, dout
  static constexpr int kStages = 2 * kOwn;                   // per stage: k, then v
  static constexpr int kStageBytes = 2 * kStream;
  static constexpr int kBars = kStages + kWgStages * kStageBytes;   // 1 + 2 kWgStages mbarriers
  static constexpr int kD = kBars + 128;                     // D of the block's rows (f32)
  static constexpr int kRh = kD + 4 * kOwnRows;              // rel_h rows, then d rel_h rows (bf16)
  static size_t bytes(int kh) { return 1024 + kRh + 2 * 2 * kOwnRows * (kh + 2); }
};

template <int HD>
struct KvSmem {  // key-major pass
  static constexpr int kOwn = WTile<HD, kOwnRows>::kBytes;
  static constexpr int kStream = WTile<HD, kStreamRows>::kBytes;
  static constexpr int kK = 0, kV = kOwn;                    // own k, v
  static constexpr int kStages = 2 * kOwn;
  // per stage: q, dout, the rel_w tile (64 x 64 bf16, 128-byte swizzle), the
  // two key rows' folded rel_h - lse (2 x 64 f32), D (64 f32)
  static constexpr int kSq = 0, kSdo = kStream, kSrw = 2 * kStream;
  static constexpr int kSfold = kSrw + kStreamRows * 128;
  static constexpr int kSd = kSfold + 2 * kStreamRows * 4;
  static constexpr int kStageBytes = (kSd + kStreamRows * 4 + 1023) / 1024 * 1024;
  static constexpr int kBars = kStages + kWgStages * kStageBytes;
  static constexpr size_t kBytes = 1024 + kBars + 128;
};

__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// ---------------------------------------------------------------------------
// Query-major pass: dq, d rel_h, d rel_w, D and the folded bias table for 128
// queries of one bh. The key tiles are the key grid's rows: tile kt is key row
// kt, its 64 columns j = k % 64.
template <int HD>
__global__ void __launch_bounds__(kWgThreads, 1)
bwd_q_wgmma(const __grid_constant__ CUtensorMap q_wide, const __grid_constant__ CUtensorMap q_slab,
            const __grid_constant__ CUtensorMap do_wide,
            const __grid_constant__ CUtensorMap do_slab,
            const __grid_constant__ CUtensorMap k_wide, const __grid_constant__ CUtensorMap k_slab,
            const __grid_constant__ CUtensorMap v_wide, const __grid_constant__ CUtensorMap v_slab,
            const __nv_bfloat16* __restrict__ rel_h, const __nv_bfloat16* __restrict__ rel_w,
            const __nv_bfloat16* __restrict__ out, const __nv_bfloat16* __restrict__ dout,
            const float* __restrict__ lse, __nv_bfloat16* __restrict__ dq,
            __nv_bfloat16* __restrict__ drel_h, __nv_bfloat16* __restrict__ drel_w,
            float* __restrict__ dvec, float* __restrict__ fold, int n, float scale) {
  using L = QSmem<HD>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const uint32_t base = smem_u32(smem);
  const uint32_t bar_own = base + L::kBars;
  auto bar_full = [&](int s) { return base + L::kBars + 8 * (1 + s); };
  auto bar_empty = [&](int s) { return base + L::kBars + 8 * (1 + kWgStages + s); };

  const int kh = n / kFastKw;
  const int rs = kh + 2;                                 // rel_h row stride in shared memory
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kOwnRows;
  const size_t row0 = static_cast<size_t>(bh) * n + q0;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n_tiles = kh;

  if (threadIdx.x == 0) {
    mbar_init(bar_own, 1);
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(bar_full(s), 1);
      mbar_init(bar_empty(s), kWgThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Thread 0 issues every TMA load: the own tiles and the first stages here,
  // each later stage once both warpgroups have released the one before it.
  auto load_stage = [&](int t) {
    const int s = t % kWgStages;
    const uint32_t st = base + L::kStages + s * L::kStageBytes;
    mbar_expect_tx(bar_full(s), L::kStageBytes);
    load_wtile<HD, kStreamRows>(st, &k_wide, &k_slab, bar_full(s), t * kStreamRows, bh);
    load_wtile<HD, kStreamRows>(st + L::kStream, &v_wide, &v_slab, bar_full(s),
                                t * kStreamRows, bh);
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar_own, 2 * L::kOwn);
    load_wtile<HD, kOwnRows>(base + L::kQ, &q_wide, &q_slab, bar_own, q0, bh);
    load_wtile<HD, kOwnRows>(base + L::kDo, &do_wide, &do_slab, bar_own, q0, bh);
    for (int t = 0; t < min(kWgStages, n_tiles); ++t) load_stage(t);
  }
  // The warp is done with the stage of tile t (every wgmma that read it has
  // completed): lane 0 arrives on its empty barrier; thread 0 then waits for
  // all eight warps and refills the stage with tile t + kWgStages.
  auto release = [&](int t) {
    const int s = t % kWgStages;
    if (lane == 0) mbar_arrive(bar_empty(s));
    if (threadIdx.x == 0 && t + kWgStages < n_tiles) {
      mbar_wait(bar_empty(s), (t / kWgStages) & 1);
      load_stage(t + kWgStages);
    }
  };

  const int tid = threadIdx.x;
  const int wg = warp / 4;
  const int g = lane / 4, t4 = lane % 4;
  float* d_s = reinterpret_cast<float*>(smem + L::kD);
  __nv_bfloat16* rh_s = reinterpret_cast<__nv_bfloat16*>(smem + L::kRh);
  __nv_bfloat16* dh_s = rh_s + kOwnRows * rs;

  // The block's rel_h rows (bf16 pairs), and D = rowsum(dout * out): two threads a row.
  for (int i = tid; i < kOwnRows * (kh / 2); i += kWgThreads) {
    const int r = i / (kh / 2), c = i % (kh / 2);
    reinterpret_cast<uint32_t*>(rh_s + r * rs)[c] =
        reinterpret_cast<const uint32_t*>(rel_h + (row0 + r) * kh)[c];
  }
  {
    const int r = tid / 2, half = tid % 2;
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(out + (row0 + r) * HD);
    const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(dout + (row0 + r) * HD);
    float acc = 0.f;
#pragma unroll
    for (int c = half * HD / 4; c < (half + 1) * HD / 4; ++c) {
      const float2 a = __bfloat1622float2(o2[c]), b = __bfloat1622float2(g2[c]);
      acc = fmaf(a.x, b.x, fmaf(a.y, b.y, acc));
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      d_s[r] = acc;
      dvec[row0 + r] = acc;
    }
  }
  bar_sync(kBarConsumers, kWgThreads);
  // The folded bias table of the key-major pass: fold[bh][i][q] = (rel_h[q, i]
  // - lse[q]) log2(e), one f32 per (key row, query), stored along the queries.
  for (int i = tid; i < kh * kOwnRows; i += kWgThreads) {
    const int ki = i / kOwnRows, r = i % kOwnRows;
    fold[(static_cast<size_t>(bh) * kh + ki) * n + q0 + r] =
        (__bfloat162float(rh_s[r * rs + ki]) - lse[row0 + r]) * kLog2e;
  }

  // This thread's rows (i = 0, 1): -lse log2(e), D, and rel_w log2(e) at its 32
  // columns, which every key tile shares (a tile is one key row).
  int row[2];
  float nl2[2], dd[2];
  float rwl[32];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = wg * 64 + (warp % 4) * 16 + g + 8 * i;
    nl2[i] = -lse[row0 + row[i]] * kLog2e;
    dd[i] = d_s[row[i]];
    const uint32_t* w2 = reinterpret_cast<const uint32_t*>(rel_w + (row0 + row[i]) * kFastKw);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t w = w2[4 * j + t4];                  // columns 8 j + 2 t, + 1
      rwl[4 * j + 2 * i] = bf16_lo(w) * kLog2e;
      rwl[4 * j + 2 * i + 1] = bf16_hi(w) * kLog2e;
    }
  }
  float dqa[HD / 2], dwa[32];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dqa[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) dwa[i] = 0.f;
  float sacc[32], pacc[32];
  uint32_t ds16[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) ds16[i] = 0u;
  const float scale_l2 = scale * kLog2e;
  const uint32_t own_q = base + L::kQ, own_do = base + L::kDo;

  mbar_wait(bar_own, 0);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int s = kt % kWgStages;
    const uint32_t st = base + L::kStages + s * L::kStageBytes;
    mbar_wait(bar_full(s), (kt / kWgStages) & 1);
    wgmma_fence();
    issue_ss<HD>(sacc, own_q, wg, st);                   // S = Q.K^T
    wgmma_commit();
    issue_ss<HD>(pacc, own_do, wg, st + L::kStream);     // dP = dO.V^T
    wgmma_commit();
    float off[2];                                        // (rel_h[q, kt] - lse) log2(e)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      off[i] = fmaf(__bfloat162float(rh_s[row[i] * rs + kt]), kLog2e, nl2[i]);
    wgmma_wait<1>();                                     // dq of tile kt - 1 and S are in
    fence_regs(sacc);
    fence_regs(dqa);
    fence_regs(ds16);
    if (kt > 0) release(kt - 1);
#pragma unroll
    for (int e = 0; e < 32; ++e)
      sacc[e] = fast_exp2(fmaf(sacc[e], scale_l2, rwl[e] + off[(e / 2) % 2]));   // P
    wgmma_wait<0>();                                     // dP is in
    fence_regs(pacc);
    float dh[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int i = (e / 2) % 2;
      const float ds = sacc[e] * (pacc[e] - dd[i]);
      dh[i] += ds;
      dwa[e] += ds;
      sacc[e] = ds;
    }
    to_a(sacc, ds16);
    wgmma_fence();
    issue_rs<HD>(dqa, ds16, st);                          // dq += dS.K
    wgmma_commit();
    // the tile is key row kt: d rel_h[q, kt] is the row's sum over the quad
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float v_ = dh[i];
      v_ += __shfl_xor_sync(0xffffffffu, v_, 1);
      v_ += __shfl_xor_sync(0xffffffffu, v_, 2);
      if (t4 == 0) dh_s[row[i] * rs + kt] = __float2bfloat16(v_);
    }
  }
  wgmma_wait<0>();
  fence_regs(dqa);
  fence_regs(ds16);

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    __nv_bfloat16* dst = dq + (row0 + row[i]) * HD + 2 * t4;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
          __floats2bfloat162_rn(dqa[4 * j + 2 * i] * scale, dqa[4 * j + 2 * i + 1] * scale);
    __nv_bfloat16* dw = drel_w + (row0 + row[i]) * kFastKw + 2 * t4;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dw + 8 * j) =
          __floats2bfloat162_rn(dwa[4 * j + 2 * i], dwa[4 * j + 2 * i + 1]);
  }
  bar_sync(kBarConsumers, kWgThreads);
  for (int i = tid; i < kOwnRows * (kh / 2); i += kWgThreads) {
    const int r = i / (kh / 2), c = i % (kh / 2);
    reinterpret_cast<uint32_t*>(drel_h + (row0 + r) * kh)[c] =
        reinterpret_cast<const uint32_t*>(dh_s + r * rs)[c];
  }
}

// ---------------------------------------------------------------------------
// Key-major pass: dk and dv for 128 keys of one bh, which are two rows of the
// key grid (warpgroup wg: key row i = 2 blockIdx.x + wg, its 64 columns j the
// accumulator rows). Each stage brings 64 queries: q, dout, their rel_w rows,
// the two key rows' folded rel_h - lse and D.
template <int HD>
__global__ void __launch_bounds__(kWgThreads, 1)
bwd_kv_wgmma(const __grid_constant__ CUtensorMap k_wide, const __grid_constant__ CUtensorMap k_slab,
             const __grid_constant__ CUtensorMap v_wide, const __grid_constant__ CUtensorMap v_slab,
             const __grid_constant__ CUtensorMap q_wide, const __grid_constant__ CUtensorMap q_slab,
             const __grid_constant__ CUtensorMap do_wide,
             const __grid_constant__ CUtensorMap do_slab,
             const __grid_constant__ CUtensorMap rw_map,
             const __grid_constant__ CUtensorMap fold_map,
             const __grid_constant__ CUtensorMap d_map, __nv_bfloat16* __restrict__ dk,
             __nv_bfloat16* __restrict__ dv, int n, float scale) {
  using L = KvSmem<HD>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const uint32_t base = smem_u32(smem);
  const uint32_t bar_own = base + L::kBars;
  auto bar_full = [&](int s) { return base + L::kBars + 8 * (1 + s); };
  auto bar_empty = [&](int s) { return base + L::kBars + 8 * (1 + kWgStages + s); };

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kOwnRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n_tiles = n / kStreamRows;

  if (threadIdx.x == 0) {
    mbar_init(bar_own, 1);
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(bar_full(s), 1);
      mbar_init(bar_empty(s), kWgThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto load_stage = [&](int t) {
    const int s = t % kWgStages;
    const uint32_t st = base + L::kStages + s * L::kStageBytes;
    const int r = t * kStreamRows;
    mbar_expect_tx(bar_full(s), 2 * L::kStream + kStreamRows * (128 + 3 * 4));
    load_wtile<HD, kStreamRows>(st + L::kSq, &q_wide, &q_slab, bar_full(s), r, bh);
    load_wtile<HD, kStreamRows>(st + L::kSdo, &do_wide, &do_slab, bar_full(s), r, bh);
    tma_load_3d(st + L::kSrw, &rw_map, bar_full(s), 0, r, bh);
    tma_load_3d(st + L::kSfold, &fold_map, bar_full(s), r, k0 / kFastKw, bh);
    tma_load_2d(st + L::kSd, &d_map, bar_full(s), r, bh);
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar_own, 2 * L::kOwn);
    load_wtile<HD, kOwnRows>(base + L::kK, &k_wide, &k_slab, bar_own, k0, bh);
    load_wtile<HD, kOwnRows>(base + L::kV, &v_wide, &v_slab, bar_own, k0, bh);
    for (int t = 0; t < min(kWgStages, n_tiles); ++t) load_stage(t);
  }
  // The warp is done with the stage of tile t (every wgmma that read it has
  // completed): lane 0 arrives on its empty barrier; thread 0 then waits for
  // all eight warps and refills the stage with tile t + kWgStages.
  auto release = [&](int t) {
    const int s = t % kWgStages;
    if (lane == 0) mbar_arrive(bar_empty(s));
    if (threadIdx.x == 0 && t + kWgStages < n_tiles) {
      mbar_wait(bar_empty(s), (t / kWgStages) & 1);
      load_stage(t + kWgStages);
    }
  };

  const int wg = warp / 4, w4 = warp % 4;
  const int t4 = lane % 4;
  float dka[HD / 2], dva[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dka[i] = dva[i] = 0.f;
  float sacc[32], pacc[32];
  uint32_t p16[16], ds16[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) p16[i] = ds16[i] = 0u;
  const float scale_l2 = scale * kLog2e;
  const uint32_t own_k = base + L::kK, own_v = base + L::kV;
  // ldmatrix.trans of the rel_w tile (rows: queries, 128-byte rows, 128-byte
  // swizzle: 16-byte chunk c of row r sits at chunk c ^ (r % 8)). Call x,
  // matrix m = lane / 8 covers queries 8 (2 x + m / 2) .. + 7 at key columns
  // 16 w4 + 8 (m % 2) .. + 7; lane gives row r = lane % 8. The thread receives
  // rel_w[q = 8 jn + 2 t, + 1][j = 16 w4 + 8 i + g] for jn = 2 x + m / 2,
  // i = m % 2: register 2 jn + i, the bias of accumulator registers 4 jn + 2 i
  // and 4 jn + 2 i + 1.
  const int lm = lane / 8, lr = lane % 8;
  const uint32_t rw_off = (8 * (lm / 2) + lr) * 128 + (((2 * w4 + lm % 2) ^ lr) << 4);

  mbar_wait(bar_own, 0);
  for (int qt = 0; qt < n_tiles; ++qt) {
    const int s = qt % kWgStages;
    const uint32_t st = base + L::kStages + s * L::kStageBytes;
    mbar_wait(bar_full(s), (qt / kWgStages) & 1);
    wgmma_fence();
    issue_ss<HD>(sacc, own_k, wg, st + L::kSq);          // S^T = K.Q^T
    wgmma_commit();
    issue_ss<HD>(pacc, own_v, wg, st + L::kSdo);         // dP^T = V.dO^T
    wgmma_commit();
    uint32_t rw[16];
#pragma unroll
    for (int x = 0; x < 4; ++x) ldsm_x4_trans(&rw[4 * x], st + L::kSrw + rw_off + x * 16 * 128);
    const float2* fold2 = reinterpret_cast<const float2*>(smem + (st - base) + L::kSfold) + wg * 32;
    const float2* d2 = reinterpret_cast<const float2*>(smem + (st - base) + L::kSd);
    wgmma_wait<1>();                                     // dv, dk of tile qt - 1 and S^T are in
    fence_regs(sacc);
    fence_regs(dka);
    fence_regs(dva);
    fence_regs(p16);
    fence_regs(ds16);
    if (qt > 0) release(qt - 1);
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) {
      const float2 c = fold2[4 * jn + t4];                // queries 8 jn + 2 t, + 1
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const uint32_t w = rw[2 * jn + i];
        const int e = 4 * jn + 2 * i;
        sacc[e] = fast_exp2(fmaf(sacc[e], scale_l2, fmaf(bf16_lo(w), kLog2e, c.x)));
        sacc[e + 1] = fast_exp2(fmaf(sacc[e + 1], scale_l2, fmaf(bf16_hi(w), kLog2e, c.y)));
      }
    }
    to_a(sacc, p16);                                     // P^T, bf16
    wgmma_fence();
    issue_rs<HD>(dva, p16, st + L::kSdo);                // dv += P^T.dO
    wgmma_commit();
    wgmma_wait<1>();                                     // dP^T is in
    fence_regs(pacc);
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) {
      const float2 d = d2[4 * jn + t4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int e = 4 * jn + 2 * i;
        sacc[e] *= pacc[e] - d.x;
        sacc[e + 1] *= pacc[e + 1] - d.y;
      }
    }
    to_a(sacc, ds16);                                    // dS^T, bf16
    wgmma_fence();
    issue_rs<HD>(dka, ds16, st + L::kSq);                // dk += dS^T.Q
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_regs(dka);
  fence_regs(dva);
  fence_regs(p16);
  fence_regs(ds16);

  const int g = lane / 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const size_t key = static_cast<size_t>(bh) * n + k0 + wg * 64 + w4 * 16 + g + 8 * i;
    const size_t at = key * HD + 2 * t4;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dk + at + 8 * j) =
          __floats2bfloat162_rn(dka[4 * j + 2 * i] * scale, dka[4 * j + 2 * i + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + at + 8 * j) =
          __floats2bfloat162_rn(dva[4 * j + 2 * i], dva[4 * j + 2 * i + 1]);
    }
  }
}

// The wgmma design takes the call: the shape class of the ViT-H and ViT-L
// training steps (Kw = 64, so every 64-row tile is one key row; HD 64 or 80;
// N a multiple of 128, so no tile is partial) where the block's rel_h rows fit.
bool takes_wgmma(int n, int hd, int kh, int kw) {
  return kw == kFastKw && (hd == 64 || hd == 80) && n % kOwnRows == 0
         && (hd == 64 ? QSmem<64>::bytes(kh) : QSmem<80>::bytes(kh))
                <= static_cast<size_t>(kMaxSmem);
}

template <int HD>
bool make_wmaps(CUtensorMap* wide, CUtensorMap* slab, const void* ptr, int bh, int n) {
  memset(wide, 0, sizeof(CUtensorMap));
  memset(slab, 0, sizeof(CUtensorMap));
  return make_rows_map(wide, ptr, bh, n, HD, 64, kStreamRows, CU_TENSOR_MAP_SWIZZLE_128B)
         && (WTile<HD, kStreamRows>::kSlabs == 0
             || make_rows_map(slab, ptr, bh, n, HD, 16, kStreamRows, CU_TENSOR_MAP_SWIZZLE_32B));
}

template <int HD>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, const void* rel_h,
                         const void* rel_w, const void* out, const void* lse, const void* dout,
                         void* dq, void* dk, void* dv, void* drel_h, void* drel_w, void* dvec,
                         int bh, int n, int kh, float scale, cudaStream_t stream) {
  CUtensorMap qw, qs, dow, dos, kw_, ks, vw, vs, rw_map, fold_map, d_map;
  float* fold = static_cast<float*>(dvec) + static_cast<size_t>(bh) * n;
  const cuuint64_t rw_dims[3] = {static_cast<cuuint64_t>(kFastKw), static_cast<cuuint64_t>(n),
                                 static_cast<cuuint64_t>(bh)};
  const cuuint64_t rw_strides[2] = {kFastKw * 2ull, static_cast<cuuint64_t>(n) * kFastKw * 2};
  const cuuint32_t rw_box[3] = {kFastKw, kStreamRows, 1};
  const cuuint64_t fold_dims[3] = {static_cast<cuuint64_t>(n), static_cast<cuuint64_t>(kh),
                                   static_cast<cuuint64_t>(bh)};
  const cuuint64_t fold_strides[2] = {static_cast<cuuint64_t>(n) * 4,
                                      static_cast<cuuint64_t>(kh) * n * 4};
  const cuuint32_t fold_box[3] = {kStreamRows, 2, 1};
  const cuuint64_t d_dims[2] = {static_cast<cuuint64_t>(n), static_cast<cuuint64_t>(bh)};
  const cuuint64_t d_strides[1] = {static_cast<cuuint64_t>(n) * 4};
  const cuuint32_t d_box[2] = {kStreamRows, 1};
  if (!make_wmaps<HD>(&qw, &qs, q, bh, n) || !make_wmaps<HD>(&dow, &dos, dout, bh, n)
      || !make_wmaps<HD>(&kw_, &ks, k, bh, n) || !make_wmaps<HD>(&vw, &vs, v, bh, n)
      || !encode_map(&rw_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, rel_w, rw_dims, rw_strides,
                     rw_box, CU_TENSOR_MAP_SWIZZLE_128B)
      || !encode_map(&fold_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, fold, fold_dims, fold_strides,
                     fold_box, CU_TENSOR_MAP_SWIZZLE_NONE)
      || !encode_map(&d_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, dvec, d_dims, d_strides, d_box,
                     CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  const size_t q_bytes = QSmem<HD>::bytes(kh), kv_bytes = KvSmem<HD>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(bwd_q_wgmma<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(q_bytes));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(bwd_kv_wgmma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kv_bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(n / kOwnRows, bh);
  bwd_q_wgmma<HD><<<grid, kWgThreads, q_bytes, stream>>>(
      qw, qs, dow, dos, kw_, ks, vw, vs, static_cast<const __nv_bfloat16*>(rel_h),
      static_cast<const __nv_bfloat16*>(rel_w), static_cast<const __nv_bfloat16*>(out),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse),
      static_cast<__nv_bfloat16*>(dq), static_cast<__nv_bfloat16*>(drel_h),
      static_cast<__nv_bfloat16*>(drel_w), static_cast<float*>(dvec), fold, n, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_kv_wgmma<HD><<<grid, kWgThreads, kv_bytes, stream>>>(
      kw_, ks, vw, vs, qw, qs, dow, dos, rw_map, fold_map, d_map,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), n, scale);
  return cudaGetLastError();
}

}  // namespace

// 1 where hipie_vit_attention_bwd takes the wgmma design at this shape, 0
// where the mma.sync one.
extern "C" int hipie_vit_attention_bwd_design(int n, int hd, int kh, int kw) {
  return takes_wgmma(n, hd, kh, kw) ? 1 : 0;
}

// dvec: (BH, 1 + Kh, N) f32 scratch: D (BH, N), written by the first pass and
// read by the second, then (wgmma design) the folded bias table (BH, Kh, N).
extern "C" int hipie_vit_attention_bwd(const void* q, const void* k, const void* v,
                                       const void* rel_h, const void* rel_w, const void* out,
                                       const void* lse, const void* dout, void* dq, void* dk,
                                       void* dv, void* drel_h, void* drel_w, void* dvec,
                                       int bh, int n, int hd, int kh, int kw, float scale,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bh <= 0 || n <= 0 || kh * kw != n) return (int)cudaErrorInvalidValue;
  if (takes_wgmma(n, hd, kh, kw)) {
    if (hd == 64)
      return launch_wgmma<64>(q, k, v, rel_h, rel_w, out, lse, dout, dq, dk, dv, drel_h, drel_w,
                              dvec, bh, n, kh, scale, s);
    return launch_wgmma<80>(q, k, v, rel_h, rel_w, out, lse, dout, dq, dk, dv, drel_h, drel_w,
                            dvec, bh, n, kh, scale, s);
  }
  switch (hd) {
    case 16: return launch_mma<16>(q, k, v, rel_h, rel_w, out, lse, dout, dq, dk, dv, drel_h,
                                   drel_w, dvec, bh, n, kh, kw, scale, s);
    case 64: return launch_mma<64>(q, k, v, rel_h, rel_w, out, lse, dout, dq, dk, dv, drel_h,
                                   drel_w, dvec, bh, n, kh, kw, scale, s);
    case 80: return launch_mma<80>(q, k, v, rel_h, rel_w, out, lse, dout, dq, dk, dv, drel_h,
                                   drel_w, dvec, bh, n, kh, kw, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
