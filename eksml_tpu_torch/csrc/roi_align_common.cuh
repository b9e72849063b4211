// Device code shared by the ROIAlign forward (roi_align_fwd.cu) and
// backward (roi_align_bwd.cu): the level table, float conversions, the
// FPN level rule with a ROI's sample geometry, a sample's coordinate
// along one axis, and its taps (per axis, and in 2-D).
// Both kernels compute these exactly alike, so the backward deposits
// gradient on the very pixels, with the very weights, that the forward
// read.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define EKSML_MAX_LEVELS 4

// Per-level NHWC [B, H_l, W_l, C] maps (features in the forward, float32
// gradient accumulators in the backward) with 1/stride_l.
struct LevelTable {
  void* ptr[EKSML_MAX_LEVELS];
  int h[EKSML_MAX_LEVELS];
  int w[EKSML_MAX_LEVELS];
  float scale[EKSML_MAX_LEVELS];
};

// Fill a LevelTable from host arrays (device pointers, (H, W) pairs,
// scales); levels past num_levels repeat the last one.
static inline LevelTable make_level_table(const void* ptrs, const void* hw,
                                          const void* scales,
                                          int num_levels) {
  LevelTable lv;
  const void* const* fp = static_cast<const void* const*>(ptrs);
  const int* hwp = static_cast<const int*>(hw);
  const float* sp = static_cast<const float*>(scales);
  for (int i = 0; i < EKSML_MAX_LEVELS; ++i) {
    const int j = i < num_levels ? i : num_levels - 1;
    lv.ptr[i] = const_cast<void*>(fp[j]);
    lv.h[i] = hwp[2 * j];
    lv.w[i] = hwp[2 * j + 1];
    lv.scale[i] = sp[j];
  }
  return lv;
}

__device__ __forceinline__ float load_as_float(const float* p) {
  return __ldg(p);
}

__device__ __forceinline__ float load_as_float(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void store_from_float(float* p, float v) {
  *p = v;
}

__device__ __forceinline__ void store_from_float(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// ROI r's level index and sample geometry: geom = (y start, x start,
// bin_h, bin_w) in level coordinates.  The FPN heuristic
// floor(4 + log2(sqrt(area)/224)), clipped to the levels, in the plain
// PyTorch version's order of operations.
__device__ __forceinline__ int roi_level_and_geometry(
    const LevelTable& lv, int num_levels, const float* __restrict__ rois,
    int r, int out_size, int min_level, float* geom) {
  const float x1 = rois[4 * (size_t)r + 0];
  const float y1 = rois[4 * (size_t)r + 1];
  const float x2 = rois[4 * (size_t)r + 2];
  const float y2 = rois[4 * (size_t)r + 3];
  const float w = fmaxf(x2 - x1, 0.0f);
  const float h = fmaxf(y2 - y1, 0.0f);
  const float sz = sqrtf(fmaxf(w * h, 1e-8f));
  float lvl = floorf(__fadd_rn(4.0f, log2f(__fadd_rn(sz / 224.0f, 1e-8f))));
  lvl = fminf(fmaxf(lvl, (float)min_level),
              (float)(min_level + num_levels - 1));
  const int li = (int)lvl - min_level;
  const float s = lv.scale[li];
  const float rx1 = x1 * s, ry1 = y1 * s, rx2 = x2 * s, ry2 = y2 * s;
  geom[0] = ry1 - 0.5f;
  geom[1] = rx1 - 0.5f;
  geom[2] = fmaxf(ry2 - ry1, 1e-4f) / (float)out_size;
  geom[3] = fmaxf(rx2 - rx1, 1e-4f) / (float)out_size;
  return li;
}

// One sample coordinate along one axis: start + (bin + (j + 0.5)/s) *
// bin_size, rounded step by step as the plain version rounds it.
__device__ __forceinline__ float sample_coord(float start, float bin_size,
                                              int bin, int j, int sampling) {
  const float f = __fadd_rn((float)bin,
                            __fdiv_rn((float)j + 0.5f, (float)sampling));
  return __fadd_rn(start, __fmul_rn(f, bin_size));
}

// One axis of a bilinear sample at coordinate v on a map of n pixels:
// the two pixel indices, their weights (1 - frac, frac) and whether each
// lies inside [0, n-1].  An index outside the map is 0.  make_taps's
// four taps are the products of a row half and a column half, with these
// very expressions; the backward reduces along each half apart
// (roi_align_bwd.cu).
struct AxisTaps {
  int i0, i1;
  float w0, w1;
  bool in0, in1;
};

__device__ __forceinline__ AxisTaps axis_taps(float v, int n) {
  const float v0 = floorf(v);
  AxisTaps t;
  t.w1 = v - v0;
  t.w0 = 1.0f - t.w1;
  // bounds in float, before any conversion: a NaN or huge coordinate
  // fails every test and never becomes an index
  t.in0 = v0 >= 0.0f && v0 <= (float)(n - 1);
  t.in1 = v0 + 1.0f >= 0.0f && v0 + 1.0f <= (float)(n - 1);
  t.i0 = t.in0 ? (int)v0 : 0;
  t.i1 = t.in1 ? (int)v0 + 1 : 0;
  return t;
}

// One bilinear sample's four taps: pixel offsets (y * W + x) and
// weights; a tap outside the map has weight 0 (and points at pixel 0).
// Each axis is axis_taps's arithmetic written out: built from two
// axis_taps calls, the bfloat16 forward took 36 registers instead of 32
// (6 resident blocks per SM instead of 8) and ran 15 % slower on the
// H100.
struct Taps {
  int off[4];
  float w[4];
};

__device__ __forceinline__ Taps make_taps(float y, float x, int H, int W) {
  const float y0 = floorf(y);
  const float x0 = floorf(x);
  const float ly = y - y0;
  const float lx = x - x0;
  const float hy = 1.0f - ly;
  const float hx = 1.0f - lx;
  // bounds in float, before any conversion: a NaN or huge coordinate
  // fails every test and never becomes an index
  const bool row0 = y0 >= 0.0f && y0 <= (float)(H - 1);
  const bool row1 = y0 + 1.0f >= 0.0f && y0 + 1.0f <= (float)(H - 1);
  const bool col0 = x0 >= 0.0f && x0 <= (float)(W - 1);
  const bool col1 = x0 + 1.0f >= 0.0f && x0 + 1.0f <= (float)(W - 1);
  const int iy = row0 ? (int)y0 : 0;
  const int ix = col0 ? (int)x0 : 0;
  const int iy1 = row1 ? (int)y0 + 1 : 0;
  const int ix1 = col1 ? (int)x0 + 1 : 0;
  Taps t;
  t.off[0] = iy * W + ix;
  t.w[0] = (row0 && col0) ? hy * hx : 0.0f;
  t.off[1] = iy * W + ix1;
  t.w[1] = (row0 && col1) ? hy * lx : 0.0f;
  t.off[2] = iy1 * W + ix;
  t.w[2] = (row1 && col0) ? ly * hx : 0.0f;
  t.off[3] = iy1 * W + ix1;
  t.w[3] = (row1 && col1) ? ly * lx : 0.0f;
  return t;
}

// The taps of output row py's out_size * sampling^2 samples into
// s_taps, strided over the block's threads.
__device__ __forceinline__ void row_taps(Taps* s_taps, const float* geom,
                                         int py, int out_size, int sampling,
                                         int H, int W) {
  const int per_bin = sampling * sampling;
  const int n_samples = out_size * per_bin;
  for (int k = threadIdx.x; k < n_samples; k += blockDim.x) {
    const int px = k / per_bin;
    const int iy = (k % per_bin) / sampling;
    const int ix = k % sampling;
    const float y = sample_coord(geom[0], geom[2], py, iy, sampling);
    const float x = sample_coord(geom[1], geom[3], px, ix, sampling);
    s_taps[k] = make_taps(y, x, H, W);
  }
}
