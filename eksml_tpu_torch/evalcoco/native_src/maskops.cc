// Native mask ops for COCO evaluation: a copy of the reference's
// eksml_tpu/evalcoco/native_src/maskops.cc (the C/C++ hot spot of the
// eval stack, pycocotools' C extension in the original containers).
//
// Exposed via a plain C ABI and loaded with ctypes
// (eksml_tpu_torch/evalcoco/native.py).  Entry points:
//   mask_iou_dense  — IoU matrix over dense uint8 masks, crowd-as-IoF
//   rle_encode_dense — dense mask → run-length counts (column-major,
//                      pycocotools order)
//   rle_iou         — IoU matrix over run-length encoded masks
//   greedy_match    — per-threshold greedy det→gt matching (the
//                     evaluateImg hot loop of pycocotools, a pure-
//                     python triple loop in cocoeval.py otherwise)
//
// Built by eksml_tpu_torch/_native.py with g++ into
// eksml_tpu_torch/_build/ at first use (no dependencies).

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// dets: [n_det, h*w] uint8, gts: [n_gt, h*w] uint8, crowd: [n_gt] uint8
// out:  [n_det, n_gt] double
void mask_iou_dense(const uint8_t* dets, int64_t n_det,
                    const uint8_t* gts, int64_t n_gt,
                    const uint8_t* crowd, int64_t hw, double* out) {
  std::vector<int64_t> det_area(n_det), gt_area(n_gt);
  for (int64_t i = 0; i < n_det; ++i) {
    int64_t a = 0;
    const uint8_t* p = dets + i * hw;
    for (int64_t k = 0; k < hw; ++k) a += p[k] != 0;
    det_area[i] = a;
  }
  for (int64_t j = 0; j < n_gt; ++j) {
    int64_t a = 0;
    const uint8_t* p = gts + j * hw;
    for (int64_t k = 0; k < hw; ++k) a += p[k] != 0;
    gt_area[j] = a;
  }
  for (int64_t i = 0; i < n_det; ++i) {
    const uint8_t* d = dets + i * hw;
    for (int64_t j = 0; j < n_gt; ++j) {
      const uint8_t* g = gts + j * hw;
      int64_t inter = 0;
      for (int64_t k = 0; k < hw; ++k) inter += (d[k] && g[k]);
      double uni = crowd[j] ? (double)det_area[i]
                            : (double)(det_area[i] + gt_area[j] - inter);
      out[i * n_gt + j] = uni > 0 ? (double)inter / uni : 0.0;
    }
  }
}

// mask: [h, w] uint8 row-major.  counts_out must hold h*w+1 entries.
// Returns the number of counts written.  Column-major traversal with
// alternating 0-run/1-run lengths — pycocotools' RLE convention.
int64_t rle_encode_dense(const uint8_t* mask, int64_t h, int64_t w,
                         uint32_t* counts_out) {
  int64_t n = 0;
  uint8_t cur = 0;
  uint32_t run = 0;
  for (int64_t x = 0; x < w; ++x) {
    for (int64_t y = 0; y < h; ++y) {
      uint8_t v = mask[y * w + x] != 0;
      if (v == cur) {
        ++run;
      } else {
        counts_out[n++] = run;
        cur = v;
        run = 1;
      }
    }
  }
  counts_out[n++] = run;
  return n;
}

// RLE-vs-RLE intersection area (counts alternate 0-run, 1-run).
static int64_t rle_inter(const uint32_t* a, int64_t na, const uint32_t* b,
                         int64_t nb) {
  int64_t ia = 0, ib = 0, inter = 0;
  int64_t ca = ia < na ? a[0] : 0, cb = ib < nb ? b[0] : 0;
  uint8_t va = 0, vb = 0;
  while (ia < na && ib < nb) {
    int64_t step = ca < cb ? ca : cb;
    if (va && vb) inter += step;
    ca -= step;
    cb -= step;
    if (ca == 0) {
      ++ia;
      va ^= 1;
      if (ia < na) ca = a[ia];
    }
    if (cb == 0) {
      ++ib;
      vb ^= 1;
      if (ib < nb) cb = b[ib];
    }
  }
  return inter;
}

static int64_t rle_area(const uint32_t* c, int64_t n) {
  int64_t a = 0;
  for (int64_t i = 1; i < n; i += 2) a += c[i];
  return a;
}

// Flattened RLE lists: counts concatenated; offsets[i]..offsets[i+1]
// delimit mask i.  out: [n_det, n_gt] double.
void rle_iou(const uint32_t* det_counts, const int64_t* det_off,
             int64_t n_det, const uint32_t* gt_counts,
             const int64_t* gt_off, int64_t n_gt, const uint8_t* crowd,
             double* out) {
  std::vector<int64_t> det_area(n_det), gt_area(n_gt);
  for (int64_t i = 0; i < n_det; ++i)
    det_area[i] = rle_area(det_counts + det_off[i],
                           det_off[i + 1] - det_off[i]);
  for (int64_t j = 0; j < n_gt; ++j)
    gt_area[j] = rle_area(gt_counts + gt_off[j], gt_off[j + 1] - gt_off[j]);
  for (int64_t i = 0; i < n_det; ++i) {
    const uint32_t* dc = det_counts + det_off[i];
    int64_t dn = det_off[i + 1] - det_off[i];
    for (int64_t j = 0; j < n_gt; ++j) {
      int64_t inter = rle_inter(dc, dn, gt_counts + gt_off[j],
                                gt_off[j + 1] - gt_off[j]);
      double uni = crowd[j] ? (double)det_area[i]
                            : (double)(det_area[i] + gt_area[j] - inter);
      out[i * n_gt + j] = uni > 0 ? (double)inter / uni : 0.0;
    }
  }
}

// Greedy score-ordered matching at T IoU thresholds — semantics of
// cocoeval.py _evaluate_pair (pycocotools evaluateImg): detections in
// score order each take the best still-available gt above threshold;
// crowd gt never saturates and never displaces a non-crowd candidate.
//   ious:     [D, G] double (crowd columns already IoF)
//   g_order:  [G] int64 gt visit order (non-crowd first)
//   threshs:  [T] double
// Outputs: dt_match [T, D] int64 (matched gt index or -1),
//          dt_crowd [T, D] uint8, gt_match [T, G] uint8.
void greedy_match(const double* ious, int64_t D, int64_t G,
                  const uint8_t* crowd, const uint8_t* ignore,
                  const int64_t* g_order,
                  const double* threshs, int64_t T,
                  int64_t* dt_match, uint8_t* dt_ignore,
                  uint8_t* gt_match) {
  // Official evaluateImg semantics: `ignore` = crowd OR out of the
  // current area range; matched NON-CROWD gt are skipped (crowd can
  // absorb multiple dets), and once an UNIGNORED match is held the
  // scan breaks at the first ignored gt (g_order is ignored-last).
  // An equal IoU later in g_order displaces the held match (official
  // uses `< iou` to reject, so ties take the later gt).
  for (int64_t t = 0; t < T; ++t) {
    int64_t* dm = dt_match + t * D;
    uint8_t* dc = dt_ignore + t * D;
    uint8_t* gm = gt_match + t * G;
    for (int64_t i = 0; i < D; ++i) dm[i] = -1;
    std::memset(dc, 0, D);
    std::memset(gm, 0, G);
    const double thr =
        threshs[t] < 1.0 - 1e-10 ? threshs[t] : 1.0 - 1e-10;
    for (int64_t di = 0; di < D; ++di) {
      double best = thr;
      int64_t best_g = -1;
      for (int64_t k = 0; k < G; ++k) {
        const int64_t gj = g_order[k];
        if (gm[gj] && !crowd[gj]) continue;
        if (best_g > -1 && !ignore[best_g] && ignore[gj]) break;
        const double v = ious[di * G + gj];
        if (v < best) continue;
        best = v;
        best_g = gj;
      }
      if (best_g >= 0) {
        dm[di] = best_g;
        dc[di] = ignore[best_g] ? 1 : 0;
        if (!crowd[best_g]) gm[best_g] = 1;
      }
    }
  }
}

}  // extern "C"
