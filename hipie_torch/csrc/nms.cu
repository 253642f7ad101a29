// Greedy NMS as a keep mask, kernel K-F: the suppression mask and the scan.
//
// Replaces: the `lax.scan` of hipie_tpu/ops/nms.py::nms_keep_mask (plain JAX,
// not Pallas), and with it the port's host loop, which copied the IoU matrix
// to the host and the keep mask back (two blocking copies an image). For N
// boxes (N, 4) xyxy f32 and `order`, the stable descending-score permutation
// the wrapper sorts on the card (hipie_torch/ops/nms.py), the result is
//
//     keep[order[i]] = not any(keep[order[k]] and over(k, i) for k < i)
//     over(k, i)     = iou(box[order[k]], box[order[i]]) > thr
//                      and (no class ids or cls[order[k]] == cls[order[i]])
//
// bit for bit the plain version's (`nms_keep_mask_plain`): the IoU repeats
// hipie_torch/ops/box_ops.py::_iou_union operation for operation in f32,
// rounded at every step (__fsub_rn, __fmul_rn, __fadd_rn, __fdiv_rn: nvcc
// would otherwise contract a product and a sum into one FMA), with torch's
// NaN-propagating maximum, minimum and clamp, and the threshold rounded to
// f32 as torch's comparison with a Python float rounds it. Main path:
// `fg_instance_inference` on every served image, N = 900 fg queries of
// ViT-H or R50 with their argmax classes (133 COCO panoptic classes).
//
// What bounds it on the H100: neither bytes nor operations. At N = 900 it
// reads 14.4 KB of boxes and 7.2 KB each of order and class ids (the wrapper's
// sort reads the 3.6 KB of scores), writes 0.9 KB of keep mask, and computes
// N(N-1)/2 = 404,550 IoUs (~4.9 MFLOP f32: 0.07 us at 67 TFLOP/s). What takes
// the time is two launches' latency and the scan's chain of N dependent
// decisions: box i's fate depends on every earlier kept box's row.
//
// Design:
//  * Mask kernel: one 64-thread block per 64 x 64 tile of the upper triangle
//    of the score-sorted IoU matrix (blocks below the diagonal return at
//    once). The block gathers its 64 column boxes through `order` into shared
//    memory; each thread takes one row box and writes one 64-bit word: bit j
//    set where column j > row, the classes agree and IoU > thr. The mask is
//    stored word-major, mask[w * N + i] = word w of row i, so that a tile's
//    64 words are one coalesced 512-byte store, and the scan reads the words
//    of 32 consecutive rows as one 256-byte load.
//  * Scan kernel: one warp. `removed`, a bitset of ceil(N / 64) words, lives
//    in shared memory. Rows go in blocks of 64. Inside a block only the
//    diagonal word of each row matters to the block's own decisions: every
//    lane holds two rows' diagonal words, every lane runs the same 64-step
//    chain over them (a warp shuffle brings row t's word; row t is kept iff
//    its bit is clear, and then its word is ORed in), and the block's kept
//    rows are the clear bits at the end (a row's own word sets only later
//    bits). The lanes then write keep[order[i]] for the block's 64 rows and
//    fold the kept rows into every later word: each lane masks its two rows'
//    words by their kept bits and the warp ORs them with two 32-bit
//    `redux.sync`s. The later words' loads do not depend on the decisions, so
//    up to kPrefetch words a row are loaded before the chain runs, and the
//    next block's diagonal words and order entries before this block's fold;
//    only the ORs wait for the chain.
//  * N = 0 launches nothing (the wrapper returns an empty mask). N is at most
//    kMaxWords * 64 = 393,216, where `removed` fills 48 KB of shared memory;
//    the mask's scratch (N^2 / 8 bytes, 19 GB there) is the wrapper's.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;
constexpr int kMaxWords = 6144;     // 48 KB of shared memory for `removed`
constexpr int kPrefetch = 16;       // later words loaded before the chain: N <= 1088 entirely
constexpr unsigned kFull = 0xffffffffu;

// torch.maximum / torch.minimum: NaN if either side is NaN.
__device__ __forceinline__ float nan_max(float a, float b) { return (a > b || a != a) ? a : b; }
__device__ __forceinline__ float nan_min(float a, float b) { return (a < b || a != a) ? a : b; }
// Tensor.clamp(min=lo): NaN stays NaN.
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }

struct Box {
  float x1, y1, x2, y2, area;
};

__device__ __forceinline__ Box load_box(const float* boxes, long long i) {
  const float* p = boxes + 4 * i;
  Box b{p[0], p[1], p[2], p[3], 0.f};
  b.area = __fmul_rn(__fsub_rn(b.x2, b.x1), __fsub_rn(b.y2, b.y1));   // box_area
  return b;
}

// _iou_union(boxes1, boxes2)[0] for one row box a and one column box b.
__device__ __forceinline__ float iou(const Box& a, const Box& b) {
  const float w = clamp_min(__fsub_rn(nan_min(a.x2, b.x2), nan_max(a.x1, b.x1)), 0.f);
  const float h = clamp_min(__fsub_rn(nan_min(a.y2, b.y2), nan_max(a.y1, b.y1)), 0.f);
  const float inter = __fmul_rn(w, h);
  const float uni = __fsub_rn(__fadd_rn(a.area, b.area), inter);
  return __fdiv_rn(inter, clamp_min(uni, 1e-6f));
}

__global__ void __launch_bounds__(kTile)
nms_mask_kernel(const float* __restrict__ boxes, const long long* __restrict__ order,
                const long long* __restrict__ cls, int n, float thr,
                unsigned long long* __restrict__ mask) {
  const int rb = blockIdx.y, cb = blockIdx.x;
  if (cb < rb) return;                   // below the diagonal: never read
  __shared__ Box col_box[kTile];
  __shared__ long long col_cls[kTile];
  const int t = threadIdx.x;
  const int c0 = cb * kTile;
  const int ncol = min(kTile, n - c0);
  if (t < ncol) {
    const long long src = order[c0 + t];
    col_box[t] = load_box(boxes, src);
    col_cls[t] = cls ? cls[src] : 0;
  }
  __syncthreads();
  const int i = rb * kTile + t;
  if (i >= n) return;
  const long long src = order[i];
  const Box row = load_box(boxes, src);
  const long long row_cls = cls ? cls[src] : 0;
  unsigned long long bits = 0;
  for (int j = cb == rb ? t + 1 : 0; j < ncol; ++j) {
    if (col_cls[j] == row_cls && iou(row, col_box[j]) > thr) bits |= 1ull << j;
  }
  mask[(long long)cb * n + i] = bits;
}

// OR over the warp of one 64-bit word per lane.
__device__ __forceinline__ unsigned long long warp_or(unsigned long long v) {
  const unsigned lo = __reduce_or_sync(kFull, (unsigned)v);
  const unsigned hi = __reduce_or_sync(kFull, (unsigned)(v >> 32));
  return ((unsigned long long)hi << 32) | lo;
}

__global__ void __launch_bounds__(32)
nms_scan_kernel(const unsigned long long* __restrict__ mask,
                const long long* __restrict__ order, int n, int nb,
                bool* __restrict__ keep) {
  extern __shared__ unsigned long long removed[];
  const int lane = threadIdx.x;
  for (int w = lane; w < nb; w += 32) removed[w] = 0;
  __syncwarp();
  // block 0's diagonal words and order entries; later blocks' come one block ahead
  unsigned long long d0 = lane < n ? mask[lane] : 0;
  unsigned long long d1 = lane + 32 < n ? mask[lane + 32] : 0;
  long long o0 = lane < n ? order[lane] : 0;
  long long o1 = lane + 32 < n ? order[lane + 32] : 0;
  for (int b = 0; b < nb; ++b) {
    const int r0 = b * kTile;
    const int rows = min(kTile, n - r0);
    const bool in0 = lane < rows, in1 = lane + 32 < rows;
    // later words of this block's rows, loaded before the chain needs none of them
    unsigned long long p0[kPrefetch], p1[kPrefetch];
#pragma unroll
    for (int u = 0; u < kPrefetch; ++u) {
      const int w = b + 1 + u;
      const unsigned long long* col = mask + (long long)w * n + r0;
      p0[u] = w < nb && in0 ? col[lane] : 0;
      p1[u] = w < nb && in1 ? col[lane + 32] : 0;
    }
    // the block's own decisions: 64 dependent steps over the diagonal words
    unsigned long long rem = removed[b];
#pragma unroll
    for (int t = 0; t < 32; ++t) {
      const unsigned long long d = __shfl_sync(kFull, d0, t);
      if (!((rem >> t) & 1)) rem |= d;
    }
#pragma unroll
    for (int t = 0; t < 32; ++t) {
      const unsigned long long d = __shfl_sync(kFull, d1, t);
      if (!((rem >> (t + 32)) & 1)) rem |= d;
    }
    const unsigned long long valid = rows == kTile ? ~0ull : (1ull << rows) - 1;
    const unsigned long long kept = ~rem & valid;
    const bool k0 = (kept >> lane) & 1, k1 = (kept >> (lane + 32)) & 1;
    if (in0) keep[o0] = k0;
    if (in1) keep[o1] = k1;
    if (b + 1 < nb) {                    // the next block's diagonal words and order
      const int r1 = r0 + kTile;
      const unsigned long long* col = mask + (long long)(b + 1) * n + r1;
      d0 = r1 + lane < n ? col[lane] : 0;
      d1 = r1 + lane + 32 < n ? col[lane + 32] : 0;
      o0 = r1 + lane < n ? order[r1 + lane] : 0;
      o1 = r1 + lane + 32 < n ? order[r1 + lane + 32] : 0;
    }
    // fold the kept rows into every later word
#pragma unroll
    for (int u = 0; u < kPrefetch; ++u) {
      const int w = b + 1 + u;
      if (w < nb) {
        const unsigned long long v = warp_or((k0 ? p0[u] : 0) | (k1 ? p1[u] : 0));
        if (lane == 0) removed[w] |= v;
      }
    }
    for (int w = b + 1 + kPrefetch; w < nb; ++w) {
      const unsigned long long* col = mask + (long long)w * n + r0;
      const unsigned long long v = warp_or((k0 ? col[lane] : 0) | (k1 ? col[lane + 32] : 0));
      if (lane == 0) removed[w] |= v;
    }
    __syncwarp();
  }
}

}  // namespace

// boxes (n, 4) f32, order (n,) int64, class_ids (n,) int64 or null, mask
// (ceil(n / 64), n) 64-bit scratch, keep (n,) bool; every row of keep is
// written. Returns cudaGetLastError() after the two launches.
extern "C" int hipie_nms(const void* boxes, const void* order, const void* class_ids, int n,
                         float iou_threshold, void* mask, void* keep, void* stream) {
  const int nb = (n + kTile - 1) / kTile;
  if (n <= 0 || nb > kMaxWords) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  nms_mask_kernel<<<dim3(nb, nb), kTile, 0, st>>>(
      static_cast<const float*>(boxes), static_cast<const long long*>(order),
      static_cast<const long long*>(class_ids), n, iou_threshold,
      static_cast<unsigned long long*>(mask));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nms_scan_kernel<<<1, 32, nb * sizeof(unsigned long long), st>>>(
      static_cast<const unsigned long long*>(mask), static_cast<const long long*>(order), n, nb,
      static_cast<bool*>(keep));
  return (int)cudaGetLastError();
}

extern "C" int hipie_nms_max_boxes() { return kMaxWords * kTile; }
