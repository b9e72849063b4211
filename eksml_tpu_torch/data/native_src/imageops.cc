// Native image ops for the input pipeline: a copy of the reference's
// eksml_tpu/data/native_src/imageops.cc, loaded via ctypes
// (eksml_tpu_torch/data/native.py) and built by
// eksml_tpu_torch/_native.py with g++ into eksml_tpu_torch/_build/.
//
// The hot op — bilinear resize of every image to its padded canvas —
// is a C ABI entry the loader's worker threads call with the GIL
// released (ctypes drops it for the call's duration), so decode
// workers scale with cores.
//
// Semantics: separable half-pixel bilinear, identical to
// loader._bilinear_resize (same (i+0.5)*scale-0.5 sample coords, edge
// clamp) — the numpy version remains the fallback.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

struct Taps {
  std::vector<int64_t> lo, hi;
  std::vector<float> frac;  // weight of hi tap
};

Taps make_taps(int64_t in, int64_t out) {
  Taps t;
  t.lo.resize(out);
  t.hi.resize(out);
  t.frac.resize(out);
  const double scale = static_cast<double>(in) / out;
  for (int64_t i = 0; i < out; ++i) {
    double pos = (i + 0.5) * scale - 0.5;
    double f = std::floor(pos);
    int64_t lo = static_cast<int64_t>(f);
    double frac = pos - f;
    if (lo < 0) { lo = 0; frac = 0.0; }
    int64_t hi = std::min(lo + 1, in - 1);
    if (lo > in - 1) lo = in - 1;
    t.lo[i] = lo;
    t.hi[i] = hi;
    t.frac[i] = static_cast<float>(std::min(std::max(frac, 0.0), 1.0));
  }
  return t;
}

}  // namespace

extern "C" {

// src: [h, w, c] f32 (contiguous) → dst: [nh, nw, c] f32.
// n_threads <= 0 selects hardware concurrency.
void resize_bilinear_f32(const float* src, int64_t h, int64_t w,
                         int64_t c, float* dst, int64_t nh, int64_t nw,
                         int n_threads) {
  const Taps ty = make_taps(h, nh);
  const Taps tx = make_taps(w, nw);

  if (n_threads <= 0) {
    n_threads = static_cast<int>(std::thread::hardware_concurrency());
    if (n_threads < 1) n_threads = 1;
  }
  n_threads = static_cast<int>(
      std::min<int64_t>(n_threads, std::max<int64_t>(nh, 1)));

  auto rows = [&](int64_t r0, int64_t r1) {
    std::vector<float> row(w * c);  // y-blended source row
    for (int64_t i = r0; i < r1; ++i) {
      const float fy = ty.frac[i];
      const float* a = src + ty.lo[i] * w * c;
      const float* b = src + ty.hi[i] * w * c;
      for (int64_t k = 0; k < w * c; ++k)
        row[k] = a[k] + (b[k] - a[k]) * fy;
      float* out = dst + i * nw * c;
      for (int64_t j = 0; j < nw; ++j) {
        const float fx = tx.frac[j];
        const float* p = row.data() + tx.lo[j] * c;
        const float* q = row.data() + tx.hi[j] * c;
        for (int64_t ch = 0; ch < c; ++ch)
          out[j * c + ch] = p[ch] + (q[ch] - p[ch]) * fx;
      }
    }
  };

  if (n_threads == 1) {
    rows(0, nh);
    return;
  }
  std::vector<std::thread> pool;
  const int64_t chunk = (nh + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    const int64_t r0 = t * chunk;
    const int64_t r1 = std::min(nh, r0 + chunk);
    if (r0 >= r1) break;
    pool.emplace_back(rows, r0, r1);
  }
  for (auto& th : pool) th.join();
}

}  // extern "C"
