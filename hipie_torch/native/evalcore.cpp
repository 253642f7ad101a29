// Native evaluation kernels: mask IoU and COCO greedy matching.
//
// TPU-native equivalent of the reference's C++ COCOeval acceleration
// (detectron2/layers/csrc/cocoeval/, used via fast_eval_api.py:61-109) — the
// two host-side hot loops of COCO evaluation:
//   * pairwise mask IoU over uint8 masks (pycocotools' C rleIou equivalent),
//   * per-(image, category) greedy detection<->GT matching across the 10 IoU
//     thresholds (COCOeval::evaluateImg inner loop).
//
// Exposed with a plain C ABI for ctypes (no pybind11 in this environment).
// Build: hipie_tpu/native/build.sh -> _evalcore.so. Python fallback:
// hipie_tpu/evaluation/{rle,coco_eval}.py (bit-identical results; tested).

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// dets: nd x hw uint8, gts: ng x hw uint8, iscrowd: ng uint8.
// out: nd x ng double IoU (crowd: intersection / det area).
void mask_iou(const uint8_t* dets, int64_t nd, const uint8_t* gts, int64_t ng,
              int64_t hw, const uint8_t* iscrowd, double* out) {
  std::vector<double> det_area(nd), gt_area(ng);
  for (int64_t i = 0; i < nd; ++i) {
    int64_t a = 0;
    const uint8_t* d = dets + i * hw;
    for (int64_t p = 0; p < hw; ++p) a += d[p] != 0;
    det_area[i] = static_cast<double>(a);
  }
  for (int64_t j = 0; j < ng; ++j) {
    int64_t a = 0;
    const uint8_t* g = gts + j * hw;
    for (int64_t p = 0; p < hw; ++p) a += g[p] != 0;
    gt_area[j] = static_cast<double>(a);
  }
  for (int64_t i = 0; i < nd; ++i) {
    const uint8_t* d = dets + i * hw;
    for (int64_t j = 0; j < ng; ++j) {
      const uint8_t* g = gts + j * hw;
      int64_t inter = 0;
      for (int64_t p = 0; p < hw; ++p) inter += (d[p] & g[p]) != 0;
      double denom = iscrowd[j] ? det_area[i]
                                : det_area[i] + gt_area[j] - inter;
      out[i * ng + j] = denom > 0 ? inter / denom : 0.0;
    }
  }
}

// Greedy COCO matching for one (image, category).
// ious: D x G (dets sorted by score desc, gts sorted ignored-last).
// gt_ignore: G uint8; gt_iscrowd: G uint8; thrs: T doubles.
// outputs: dt_matched (T x D uint8), dt_ignore (T x D uint8),
//          gt_matched (T x G int64, -1 = unmatched).
void coco_match(const double* ious, int64_t D, int64_t G,
                const uint8_t* gt_ignore, const uint8_t* gt_iscrowd,
                const double* thrs, int64_t T,
                uint8_t* dt_matched, uint8_t* dt_ignore, int64_t* gt_matched) {
  for (int64_t t = 0; t < T; ++t) {
    int64_t* gm = gt_matched + t * G;
    for (int64_t j = 0; j < G; ++j) gm[j] = -1;
    for (int64_t di = 0; di < D; ++di) {
      double best = thrs[t] > 1e-10 ? thrs[t] : 1e-10;
      int64_t best_j = -1;
      for (int64_t gj = 0; gj < G; ++gj) {
        if (gm[gj] >= 0 && !gt_iscrowd[gj]) continue;
        if (best_j >= 0 && !gt_ignore[best_j] && gt_ignore[gj]) break;
        double v = ious[di * G + gj];
        if (v < best) continue;
        best = v;
        best_j = gj;
      }
      if (best_j < 0) continue;
      dt_matched[t * D + di] = 1;
      dt_ignore[t * D + di] = gt_ignore[best_j];
      gm[best_j] = di;
    }
  }
}

// Column-major RLE decode (pycocotools layout) for benchmarking parity.
void rle_decode_counts(const int64_t* counts, int64_t n_counts, int64_t h,
                       int64_t w, uint8_t* out /* h*w, column-major */) {
  int64_t pos = 0;
  uint8_t val = 0;
  for (int64_t i = 0; i < n_counts; ++i) {
    int64_t c = counts[i];
    if (val) memset(out + pos, 1, c);
    pos += c;
    val ^= 1;
  }
}

}  // extern "C"
