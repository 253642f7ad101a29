// ViTDet global attention with the decomposed relative-position bias, forward.
//
// Replaces: hipie_tpu/ops/pallas/vit_attention_kernel.py::vit_global_attention
// (_fwd_pallas_v1 / _fwd_pallas_v2). Computes, per (batch*head) row b,
//
//     out[q] = softmax_k(q.k * scale + rel_h[q, k / Kw] + rel_w[q, k % Kw]) . v
//
// with q, k, v: (BH, N, HD) bf16, rel_h: (BH, N, Kh) bf16, rel_w: (BH, N, Kw)
// bf16, N == Kh * Kw, f32 logits and softmax, P rounded to bf16 before P.V (as
// the TPU kernel), bf16 output. ViT-H at 1024^2: BH = 16 per image, N = 4096,
// HD = 80, Kh = Kw = 64, 24 global blocks per image. Training also asks for
// the per-row logsumexp of the logits, lse (BH, N) f32 in natural-log units,
// which the backward (kernel K-E, vit_attention_bwd.cu) recomputes P from;
// serving passes a null pointer and writes nothing more.
//
// What bounds it on the H100: the tensor cores. The work is 2 * 2 * BH * N^2 * HD
// = 85.9 GFLOP at the ViT-H shape, 0.087 ms at 989 TFLOP/s bf16, while the bytes
// (q, k, v, out, rel_h, rel_w: 58.7 MB) take 0.018 ms at 3.35 TB/s. Next come the
// BH * N^2 = 268 M exponentials (the SFUs do 16 per SM per clock: ~0.07 ms) and
// the K and V tiles every 128-query block reads again from L2 (671 MB at the
// ViT-H shape).
//
// Design (Hopper, sm_90a):
//  * A block covers 128 queries of one bh: two consumer warpgroups of 64 query
//    rows each, and a producer warpgroup (one thread issues the TMA loads) that
//    hands its registers to the consumers with setmaxnreg. One block per SM.
//  * Q is loaded once; K and V tiles of 128 keys flow through a ring of 4
//    stages (3 where the rel rows take more room) guarded by full/empty
//    mbarriers. Keys past N read as zeros (TMA). The depth of the ring matters:
//    the loads' latency is hidden only from 3 stages on.
//  * HD = 80 makes a 160-byte row, wider than the 128-byte swizzle span. Each
//    tile is loaded as a 64-column box, 128-byte swizzled, and a 16-column box,
//    32-byte swizzled: two TMA requests a row (five 16-column boxes, 32-byte
//    requests, made the loads alone take most of the kernel's time). Every
//    128-query block reads all of K and V of its bh again, so the L2 bandwidth
//    sets a floor under this tiling. Nothing is padded, in HBM or in shared
//    memory.
//  * S = Q.K^T: wgmma m64n128k16 per warpgroup, four k16 steps through the
//    128-byte-swizzled part (the descriptor advances 32 B a step) and one
//    through the 32-byte one; f32 accumulators in registers, never in shared
//    memory.
//  * The bias: logits q.k * scale + rel_w[k % Kw] keep their natural units and
//    rel_h[k / Kw] joins the row max and the exponent, exp2((x + rel_h - m) *
//    log2(e)), one FFMA. With Kw = 64 (the main path) the 32 key columns a
//    thread holds in its accumulator fragment have 16 fixed k % 64, read per
//    tile from the block's rel_w rows in shared memory (rows padded to 72 so
//    the reads are free of bank conflicts), and rel_h is one value per (row,
//    64-key half tile). Other shapes take a per-element path over the block's
//    rel rows, staged in shared memory when they fit (read from global memory
//    otherwise). Keys past N get -inf, in a copy of the softmax compiled for
//    the partial last tile only.
//  * Online softmax in registers: row maxima and sums in four independent
//    chains per row (serial chains of 32 left the softmax latency-bound),
//    reduced over the quad of threads that share a row with two shuffles; O
//    rescaled by exp2(m_old - m_new); l kept per thread and reduced at the end.
//  * O = P.V: P is converted to bf16 in registers, where the accumulator
//    layout of S is already the A-operand layout of wgmma, and fed as the
//    register A operand against V, read from shared memory as the MN-major B
//    operand: m64n64k16 through the 128-byte-swizzled part and m64n16k16 through
//    the 32-byte one, whose accumulators are together the m64n80 fragment. O
//    stays in registers (HD / 2 f32 a thread) and is divided by l at the end.
//  * Overlap: S of tile t and P.V of tile t - 1 are issued together, and the
//    softmax of tile t runs while P.V still holds the tensor cores; two named
//    barriers hand the tensor cores from one consumer warpgroup to the other
//    (ping-pong), so one issues while the other runs its exponentials.
// Queries past N are computed on zero rows and not written, so N need not
// divide 128. HD in {16, 64, 80} is built.

#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int kTileQ = 128;                 // queries per block
constexpr int kTileK = 128;                 // keys per pipeline stage
constexpr int kWide = 64;                   // columns of the 128-byte-swizzled box
constexpr int kSlab = 16;                   // columns of a 32-byte-swizzled box: one k16 step
constexpr int kWideBytes = kTileK * kWide * 2;   // 128 rows x 128 B
constexpr int kSlabBytes = kTileK * kSlab * 2;   // 128 rows x 32 B
constexpr int kConsumerThreads = 256;       // two warpgroups
constexpr int kThreads = kConsumerThreads + 128;  // + the producer warpgroup
// setmaxnreg: the producer warpgroup keeps 40 registers a thread, the consumers
// take 232 (40 * 128 + 232 * 256 = 64512 of the SM's 65536).
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kFastKw = 64;                 // the key-grid width of the fast bias path
// Fast path: the block's rel_w rows (bf16) 72 elements apart, so that a warp's
// 32-bit loads (8 rows x 4 threads) fall in distinct banks.
constexpr int kRwStride = 72;
constexpr int kMaxSmem = 227 * 1024;        // shared memory a block may use
constexpr float kLog2e = 1.4426950408889634f;
// Named barriers: 0 is __syncthreads; 1 and 2 are the turns of warpgroups 0 and
// 1 on the tensor cores; 3 syncs the consumers after staging the rel rows.
constexpr int kBarTable = 3;

template <int HD>
struct Tile {
  static constexpr int kWides = HD / kWide;                 // 0 or 1 wide box
  static constexpr int kSlabs = (HD % kWide) / kSlab;       // 16-column slabs after it
  static_assert(HD % kSlab == 0 && kWides <= 1, "head dim: a multiple of 16, at most 112");
  static constexpr int kBytes = kWides * kWideBytes + kSlabs * kSlabBytes;  // one Q, K or V tile
  static constexpr int kSlab0 = kWides * kWideBytes;        // offset of the first slab
};

// kStages K and V stages: 4 on the main path, 3 where the rel rows take more room.
template <int HD, int kStages>
struct Smem {
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + Tile<HD>::kBytes;           // kStages K tiles
  static constexpr int kV = kK + kStages * Tile<HD>::kBytes; // kStages V tiles
  static constexpr int kBars = kV + kStages * Tile<HD>::kBytes;  // 1 + 2 kStages mbarriers
  static constexpr int kTable = kBars + 128;                // rel_h, rel_w rows (bf16)
  static constexpr int kAlign = 1024;                       // slack to align the base
};

// One tile (128 rows from `row`) of a (BH, N, HD) tensor: the wide box, then the slabs.
template <int HD>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* wide,
                                          const CUtensorMap* slab, uint32_t bar, int row, int bh) {
  if constexpr (Tile<HD>::kWides > 0) tma_load_3d(dst, wide, bar, 0, row, bh);
#pragma unroll
  for (int c = 0; c < Tile<HD>::kSlabs; ++c)
    tma_load_3d(dst + Tile<HD>::kSlab0 + c * kSlabBytes, slab, bar,
                Tile<HD>::kWides * kWide + c * kSlab, row, bh);
}

// acc = Q . K^T: the warpgroup's 64 query rows (tile at q_tile) against the 128
// keys of the tile at k_tile.
template <int HD>
__device__ __forceinline__ void issue_s(float (&acc)[64], uint32_t q_tile, int wg, uint32_t k_tile) {
  using T = Tile<HD>;
#pragma unroll
  for (int kk = 0; kk < T::kWides * (kWide / 16); ++kk)
    wgmma_ss_n128(acc, desc(q_tile + wg * 64 * 128 + kk * 32, 16, 1024, kLayoutB128),
                  desc(k_tile + kk * 32, 16, 1024, kLayoutB128), kk > 0);
#pragma unroll
  for (int c = 0; c < T::kSlabs; ++c)
    wgmma_ss_n128(acc, desc(q_tile + T::kSlab0 + c * kSlabBytes + wg * 64 * 32, 16, 256, kLayoutB32),
                  desc(k_tile + T::kSlab0 + c * kSlabBytes, 16, 256, kLayoutB32),
                  T::kWides > 0 || c > 0);
  wgmma_commit();
}

// o += P . V: P from registers, V (the tile at v_tile) as the MN-major operand.
// The n64 accumulators (columns 0..63) and each n16 one (16 more columns) are
// consecutive registers of the m64nHD fragment.
template <int HD>
__device__ __forceinline__ void issue_pv(float (&o)[HD / 2], const uint32_t (&p)[32],
                                         uint32_t v_tile) {
  using T = Tile<HD>;
#pragma unroll
  for (int ks = 0; ks < kTileK / 16; ++ks) {
    if constexpr (T::kWides > 0)
      wgmma_rs_n64(o, &p[4 * ks], desc(v_tile + ks * 16 * 128, 16, 1024, kLayoutB128));
#pragma unroll
    for (int c = 0; c < T::kSlabs; ++c)
      wgmma_rs_n16(o + T::kWides * 32 + 8 * c, &p[4 * ks],
                   desc(v_tile + T::kSlab0 + c * kSlabBytes + ks * 16 * 32, kSlabBytes, 256,
                        kLayoutB32));
  }
  wgmma_commit();
}

// Accumulator fragment of wgmma m64nN (f32), thread t of the warpgroup, warp
// w = t / 32, lane l: register 4 j + 2 i + c holds row 16 w + l / 4 + 8 i and
// column 8 j + 2 (l % 4) + c. The A-operand fragment of one k16 step takes the
// same rows and columns 16 s .. 16 s + 15 from registers 8 s .. 8 s + 7, packed
// in pairs, so P goes from S's registers to P.V's A operand unmoved.

// One tile of logits, in place: bias added in the exp2 domain, keys past N
// masked (kMask: the last, partial tile), then acc = exp2(logit - m_new).
// Updates the running max and this thread's partial row sums; alpha =
// exp2(m_old - m_new) rescales O. Maxima and sums run in four independent
// chains per row (by column parity and half-tile), so their latency hides. In
// the fast path acc holds q.k + rel_w until the exponent, and rel_h (one value
// per half-tile of 64 keys) joins the max and the exponent's offset.
template <bool kFast, bool kMask>
__device__ __forceinline__ void softmax_tile(float (&acc)[64], float (&m_run)[2],
                                             float (&l_run)[2], float (&alpha)[2],
                                             const __nv_bfloat16* const (&th_r)[2],
                                             const __nv_bfloat16* const (&tw_r)[2],
                                             int k0, int n, int kh, int kw, float scale,
                                             int lane) {
  float hv[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  if constexpr (kFast) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        hv[i][h] = __bfloat162float(th_r[i][min(k0 / kFastKw + h, kh - 1)]);
  }
  float pmax[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) pmax[i][r] = -INFINITY;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      uint32_t w = 0;                     // columns 8 jj + .. and 8 (jj + 8) + .. share k % 64
      if constexpr (kFast)
        w = *reinterpret_cast<const uint32_t*>(tw_r[i] + 8 * jj + 2 * (lane % 4));
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int j = jj + 8 * h;
          const int idx = 4 * j + 2 * i + c;
          const int key = k0 + 8 * j + 2 * (lane % 4) + c;
          float b;
          if constexpr (kFast) {
            b = __uint_as_float(c == 0 ? w << 16 : w & 0xffff0000u);   // bf16 -> f32
          } else {
            const int kc = min(key, n - 1);
            b = __bfloat162float(th_r[i][kc / kw]) + __bfloat162float(tw_r[i][kc % kw]);
          }
          float x = fmaf(acc[idx], scale, b);
          if constexpr (kMask) {
            if (key >= n) x = -INFINITY;
          }
          acc[idx] = x;
          pmax[i][2 * h + c] = fmaxf(pmax[i][2 * h + c], x);
        }
    }
  float off[2][2];                                       // exponent offset per (row, half)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float tmax = fmaxf(fmaxf(pmax[i][0], pmax[i][1]) + hv[i][0],
                       fmaxf(pmax[i][2], pmax[i][3]) + hv[i][1]);
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m_run[i], tmax);           // finite: key k0 < N is valid
    alpha[i] = fast_exp2((m_run[i] - m_new) * kLog2e);   // 0 on the first tile
    m_run[i] = m_new;
    off[i][0] = (hv[i][0] - m_new) * kLog2e;
    off[i][1] = (hv[i][1] - m_new) * kLog2e;
  }
  float psum[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float e = fast_exp2(fmaf(acc[4 * j + 2 * i + c], kLog2e, off[i][j / 8]));
        psum[i][2 * (j / 8) + c] += e;
        acc[4 * j + 2 * i + c] = e;
      }
#pragma unroll
  for (int i = 0; i < 2; ++i)
    l_run[i] = l_run[i] * alpha[i] + ((psum[i][0] + psum[i][1]) + (psum[i][2] + psum[i][3]));
}

// The tile's softmax, with the key mask compiled in only for a partial tile.
template <bool kFast>
__device__ __forceinline__ void softmax_any(float (&acc)[64], float (&m_run)[2],
                                            float (&l_run)[2], float (&alpha)[2],
                                            const __nv_bfloat16* const (&th_r)[2],
                                            const __nv_bfloat16* const (&tw_r)[2],
                                            int k0, int n, int kh, int kw, float scale, int lane) {
  if (k0 + kTileK > n)
    softmax_tile<kFast, true>(acc, m_run, l_run, alpha, th_r, tw_r, k0, n, kh, kw, scale, lane);
  else
    softmax_tile<kFast, false>(acc, m_run, l_run, alpha, th_r, tw_r, k0, n, kh, kw, scale, lane);
}

// P (f32 accumulator registers) -> bf16 pairs, the A operand of P.V.
__device__ __forceinline__ void to_bf16(const float (&acc)[64], uint32_t (&p)[32]) {
#pragma unroll
  for (int r = 0; r < 32; ++r) p[r] = pack_bf16(acc[2 * r], acc[2 * r + 1]);
}

template <int HD, bool kFast>
__global__ void __launch_bounds__(kThreads, 1)
vit_attention_kernel(const __grid_constant__ CUtensorMap q_wide,
                     const __grid_constant__ CUtensorMap q_slab,
                     const __grid_constant__ CUtensorMap k_wide,
                     const __grid_constant__ CUtensorMap k_slab,
                     const __grid_constant__ CUtensorMap v_wide,
                     const __grid_constant__ CUtensorMap v_slab,
                     const __nv_bfloat16* __restrict__ rel_h,
                     const __nv_bfloat16* __restrict__ rel_w,
                     __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                     int n, int kh, int kw, float scale, int table_in_smem) {
  constexpr int kStages = kFast ? 4 : 3;
  using L = Smem<HD, kStages>;
  constexpr int kTileBytes = Tile<HD>::kBytes;
  constexpr int kOut = HD / 2;                          // O registers per thread
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((L::kAlign - (smem_u32(smem_raw) & (L::kAlign - 1)))
                                    & (L::kAlign - 1));
  const uint32_t base = smem_u32(smem);
  const uint32_t bar_q = base + L::kBars;
  auto bar_full = [&](int s) { return base + L::kBars + 8 * (1 + s); };
  auto bar_empty = [&](int s) { return base + L::kBars + 8 * (1 + kStages + s); };

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kTileQ;
  // The role test must be provably warp-uniform for ptxas to honour setmaxnreg.
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;
  const int n_tiles = (n + kTileK - 1) / kTileK;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full(s), 1);
      mbar_init(bar_empty(s), kConsumerThreads / 32);   // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumerThreads / 32) {
    // ---- producer warpgroup: gives its registers away; one thread keeps the
    // ring of K and V tiles full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kProducerRegs));
    if (threadIdx.x == kConsumerThreads) {
      mbar_expect_tx(bar_q, kTileBytes);
      load_tile<HD>(base + L::kQ, &q_wide, &q_slab, bar_q, q0, bh);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(bar_empty(s), ((t / kStages) - 1) & 1);
        mbar_expect_tx(bar_full(s), 2 * kTileBytes);
        load_tile<HD>(base + L::kK + s * kTileBytes, &k_wide, &k_slab, bar_full(s), t * kTileK, bh);
        load_tile<HD>(base + L::kV + s * kTileBytes, &v_wide, &v_slab, bar_full(s), t * kTileK, bh);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows 64 wg .. 64 wg + 63 ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kConsumerRegs));
    const int wg = warp / 4;
    const int q_valid = min(kTileQ, n - q0);
    const size_t row0 = static_cast<size_t>(bh) * n + q0;
    const __nv_bfloat16* th = rel_h + row0 * kh;         // the block's rel rows
    const __nv_bfloat16* tw = rel_w + row0 * kw;
    if (table_in_smem) {
      constexpr int kPad = kFast ? kRwStride - kFastKw : 0;   // fast path: padded rel_w rows
      __nv_bfloat16* sh = reinterpret_cast<__nv_bfloat16*>(smem + L::kTable);
      __nv_bfloat16* sw = sh + kTileQ * kh;
      for (int i = threadIdx.x; i < kTileQ * kh; i += kConsumerThreads)
        sh[i] = i / kh < q_valid ? th[i] : __float2bfloat16(0.f);
      for (int i = threadIdx.x; i < kTileQ * kw; i += kConsumerThreads)
        sw[i + (i / kw) * kPad] = i / kw < q_valid ? tw[i] : __float2bfloat16(0.f);
      bar_sync(kBarTable, kConsumerThreads);
      th = sh;
      tw = sw;
    }
    const int tw_stride = kFast ? kRwStride : kw;
    // This thread's two rows (i = 0, 1) of the tile; rows past N read row N - 1.
    const int row_a = wg * 64 + (warp % 4) * 16 + lane / 4;
    const __nv_bfloat16* th_r[2];
    const __nv_bfloat16* tw_r[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = min(row_a + 8 * i, q_valid - 1);
      th_r[i] = th + static_cast<size_t>(r) * kh;
      tw_r[i] = tw + static_cast<size_t>(r) * tw_stride;
    }
    float m_run[2] = {-INFINITY, -INFINITY};
    float l_run[2] = {0.f, 0.f};
    float alpha[2];
    float o[kOut];
#pragma unroll
    for (int i = 0; i < kOut; ++i) o[i] = 0.f;
    float acc[64];
    uint32_t p[32];
    const uint32_t sq = base + L::kQ;

    if (wg == 1) bar_arrive(1, kConsumerThreads);      // warpgroup 0 goes first
    mbar_wait(bar_q, 0);
    mbar_wait(bar_full(0), 0);
    bar_sync(1 + wg, kConsumerThreads);    // this warpgroup's turn
    wgmma_fence();
    issue_s<HD>(acc, sq, wg, base + L::kK);
    bar_arrive(2 - wg, kConsumerThreads);
    wgmma_wait<0>();
    fence_regs(acc);
    softmax_any<kFast>(acc, m_run, l_run, alpha, th_r, tw_r, 0, n, kh, kw, scale, lane);
    to_bf16(acc, p);

    // Steady state: S of tile t and P.V of tile t - 1 are issued together; the
    // softmax of tile t runs while P.V still holds the tensor cores.
    for (int t = 1; t < n_tiles; ++t) {
      const int s = t % kStages;
      const int sp = (t - 1) % kStages;
      mbar_wait(bar_full(s), (t / kStages) & 1);
      bar_sync(1 + wg, kConsumerThreads);    // this warpgroup's turn
      wgmma_fence();
      issue_s<HD>(acc, sq, wg, base + L::kK + s * kTileBytes);
      issue_pv<HD>(o, p, base + L::kV + sp * kTileBytes);
      bar_arrive(2 - wg, kConsumerThreads);  // the other's turn
      wgmma_wait<1>();                                   // S of tile t is in
      fence_regs(acc);
      softmax_any<kFast>(acc, m_run, l_run, alpha, th_r, tw_r, t * kTileK, n, kh, kw, scale, lane);
      wgmma_wait<0>();                                   // P.V of tile t - 1 is in
      fence_regs(o);
      fence_regs(p);
      if (lane == 0) mbar_arrive(bar_empty(sp));         // this warp is done with stage sp
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          o[4 * j + 2 * i] *= alpha[i];
          o[4 * j + 2 * i + 1] *= alpha[i];
        }
      to_bf16(acc, p);
    }
    wgmma_fence();
    issue_pv<HD>(o, p, base + L::kV + ((n_tiles - 1) % kStages) * kTileBytes);
    wgmma_wait<0>();
    fence_regs(o);
    if (wg == 0) bar_sync(1, kConsumerThreads);        // warpgroup 1's last hand-over

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float l = l_run[i];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float inv = 1.f / l;
      const int r = row_a + 8 * i;
      if (r < q_valid) {
        // m_run is the row max of q.k * scale + rel_h + rel_w in natural units
        // and l the sum of exp(logit - m_run), so lse = m_run + ln(l)
        if (lse != nullptr && lane % 4 == 0) lse[row0 + r] = m_run[i] + logf(l);
        __nv_bfloat16* dst = out + (row0 + r) * HD + 2 * (lane % 4);
#pragma unroll
        for (int j = 0; j < HD / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
              __floats2bfloat162_rn(o[4 * j + 2 * i] * inv, o[4 * j + 2 * i + 1] * inv);
      }
    }
  }
}

// The wide (64 columns, 128-byte swizzle) and slab (16 columns, 32-byte
// swizzle) maps of one tensor, boxes of 128 rows; a map the head dim does not
// use stays zero.
template <int HD>
bool make_maps(CUtensorMap* wide, CUtensorMap* slab, const void* ptr, int bh, int n) {
  memset(wide, 0, sizeof(CUtensorMap));
  memset(slab, 0, sizeof(CUtensorMap));
  return (!Tile<HD>::kWides
          || make_rows_map(wide, ptr, bh, n, HD, kWide, kTileK, CU_TENSOR_MAP_SWIZZLE_128B))
         && (!Tile<HD>::kSlabs
             || make_rows_map(slab, ptr, bh, n, HD, kSlab, kTileK, CU_TENSOR_MAP_SWIZZLE_32B));
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* rel_h,
                   const void* rel_w, void* out, void* lse, int bh, int n, int kh, int kw,
                   float scale, cudaStream_t stream) {
  CUtensorMap qw, qs, kw_, ks, vw, vs;
  if (!make_maps<HD>(&qw, &qs, q, bh, n) || !make_maps<HD>(&kw_, &ks, k, bh, n)
      || !make_maps<HD>(&vw, &vs, v, bh, n))
    return cudaErrorInvalidValue;
  // Shared memory: tiles and barriers, then the rel rows where they fit (the
  // fast path's rel_w rows padded); otherwise the kernel reads them from HBM.
  constexpr size_t kFixedFast = Smem<HD, 4>::kAlign + Smem<HD, 4>::kTable;
  constexpr size_t kFixed = Smem<HD, 3>::kAlign + Smem<HD, 3>::kTable;
  const size_t table_fast = static_cast<size_t>(kTileQ) * (kh + kRwStride) * 2;
  const size_t table = static_cast<size_t>(kTileQ) * (kh + kw) * 2;
  const bool fast = kw == kFastKw && kFixedFast + table_fast <= kMaxSmem;
  const bool in_smem = fast || kFixed + table <= kMaxSmem;
  const size_t bytes = fast ? kFixedFast + table_fast : kFixed + (in_smem ? table : 0);
  auto kernel = fast ? vit_attention_kernel<HD, true> : vit_attention_kernel<HD, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  dim3 grid((n + kTileQ - 1) / kTileQ, bh);
  kernel<<<grid, kThreads, bytes, stream>>>(
      qw, qs, kw_, ks, vw, vs, static_cast<const __nv_bfloat16*>(rel_h),
      static_cast<const __nv_bfloat16*>(rel_w), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), n, kh, kw, scale, in_smem ? 1 : 0);
  return cudaGetLastError();
}

}  // namespace

// lse: (BH, N) f32, or null where only the output is wanted (serving).
extern "C" int hipie_vit_attention(const void* q, const void* k, const void* v,
                                   const void* rel_h, const void* rel_w, void* out, void* lse,
                                   int bh, int n, int hd, int kh, int kw, float scale,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch<16>(q, k, v, rel_h, rel_w, out, lse, bh, n, kh, kw, scale, s);
    case 64: return launch<64>(q, k, v, rel_h, rel_w, out, lse, bh, n, kh, kw, scale, s);
    case 80: return launch<80>(q, k, v, rel_h, rel_w, out, lse, bh, n, kh, kw, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
