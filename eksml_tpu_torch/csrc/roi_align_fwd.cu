// Multilevel ROIAlign forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel eksml_tpu/ops/pallas/roi_align_kernel.py
// ::_kernel (driven by _pallas_forward).  It computes what that kernel
// computes — aligned=True ROIAlign, `sampling` x `sampling` bilinear
// samples per bin at y1 - 0.5 + (bin + (j + 0.5)/s) * bin_h in level
// coordinates, taps outside [0, H-1] x [0, W-1] count zero, mean per bin,
// float32 coordinates and sums, output in the feature dtype — but not
// block by block: the TPU kernel DMAs a 64x64 tile per ROI and contracts
// it with two MXU matmuls, and its tile-fit level bump and sublane
// rounding are TPU rules.  Here the level is the plain FPN heuristic
// (floor(4 + log2(sqrt(area)/224)), clipped), the same as the plain
// PyTorch version in eksml_tpu_torch/ops/roi_align.py.  The level rule,
// the sample geometry and the taps come from roi_align_common.cuh, which
// the backward (roi_align_bwd.cu) shares.
//
// Bound on the H100 (3.35 TB/s, 67 TFLOP/s float32 without tensor
// cores): bytes.  The least traffic is every feature pixel the ROIs'
// taps touch, read once (C channels each), plus the output
// [R, out, out, C] written once; the arithmetic is ~8 flops per tap per
// channel, two orders of magnitude below the card's ratio of flops to
// bytes.
//
// What held the first design back (one block per (ROI, output row),
// threads over channels, one 4-byte load per tap per channel): the
// re-reads.  Neighbouring samples of a ROI share pixels, so at
// training's box call (4 x 512 ROIs, out 7, C = 256, f32) its 1.61 M taps
// per channel request 1.64 GB for 0.56 M distinct footprint pixels; it
// ran at 0.331 ms on an H100 SXM at 700 W, 25 % of the 0.084 ms bound,
// at about the same request rate at every call.  With C = 1 (the mask
// targets) 31 of its 32 lanes idled: 0.144 ms against a 0.002 ms bound.
//
// This design (roi_align_fwd_footprint_kernel): one block per (ROI,
// channel chunk) reads the ROI's footprint once.  ROIAlign is separable:
// a tap's weight is wy * wx.  The block lists the distinct map rows and
// columns its taps of nonzero weight reach (at most 2 * out * s each;
// one warp per axis, one pass) and folds each bin's taps into banded
// weights Wy [out x rows] and Wx [out x cols].  Whole footprint rows
// then stream through two stages of shared memory, copied with cp.async
// in 16-byte vectors (4 float32 or 8 bfloat16 channels); the first
// stage's copies run while the weights are banded.  A thread owns one
// output column px, four channels and seven output rows, with their
// float32 sums in registers: each staged footprint row i that reaches
// its rows is contracted along x over the band of columns of bin px
// (at most 2 * s, its weights in registers), X = sum_j Wx[px][j]
// F[i][j], then added to the rows py it reaches, out[py][px] +=
// Wy[py][i] X, and divided by s^2 at the end.  This is the TPU kernel's
// two contractions (ry . tile, then cx) in the other order, as banded
// FFMA instead of dense MXU products.  Threads map to (output pixel,
// channel group) jointly, so with one channel they run over pixels.
// Chunks hold at most 224 threads and are sized from the device's
// shared memory for three blocks per SM.  C % 4 (f32) or 8 (bf16) != 0
// or an unaligned buffer take one channel per copy and thread.
//
// Measured on the same card, in turns with the first design (f32; event
// times of back-to-back launches): training's box call 0.228 ms (first
// design 0.331), mask 0.190 (0.260), mask targets 0.022 device-only
// (0.144; its event time, 0.03-0.05 ms, is the wrapper's launch path);
// predict's box 0.422 (0.602), mask 0.153 (0.208); bf16 0.62-0.64 of
// the first design's at every call.  The footprint reads go at about 2.5
// TB/s from L2 and HBM; what holds the kernel now is latency: at most
// three blocks per SM (shared memory and 80 registers), each a chain of
// listing, first copies and a barrier pair per stage, with a float32
// kernel that spills ~140 B.
//
// Where out * ceil(out / 7) exceeds 224 threads (out >= 38), the entry
// point takes the first design (roi_align_fwd_rowwise_kernel); no option
// chooses between them.

#include <atomic>
#include <mutex>

#include "roi_align_common.cuh"

// ---------------------------------------------------------------------
// VEC (4 or 1) consecutive channels as float, and the staging copies
// ---------------------------------------------------------------------

template <int VEC>
__device__ __forceinline__ void load_floats(const float* p, float* v) {
  if constexpr (VEC == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    v[0] = *p;
  }
}

template <int VEC>
__device__ __forceinline__ void store_floats(float* p, const float* v) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *p = v[0];
  }
}

template <int VEC>
__device__ __forceinline__ void load_floats(const __nv_bfloat16* p,
                                            float* v) {
  if constexpr (VEC == 4) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    const float2 lo = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&q.x));
    const float2 hi = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&q.y));
    v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
  } else {
    v[0] = __bfloat162float(*p);
  }
}

template <int VEC>
__device__ __forceinline__ void store_floats(__nv_bfloat16* p,
                                             const float* v) {
  if constexpr (VEC == 4) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    *reinterpret_cast<uint2*>(p) =
        make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                   *reinterpret_cast<const unsigned*>(&hi));
  } else {
    *p = __float2bfloat16_rn(v[0]);
  }
}

// Copy VEC elements from global `src` to shared `dst`: cp.async for 16
// bytes (4 float32 or 8 bfloat16) and for one float32, a plain load and
// store for one bfloat16 (cp.async copies 4, 8 or 16 bytes).
template <typename T, int VEC>
__device__ __forceinline__ void stage_copy(T* dst, const T* src) {
  constexpr int BYTES = VEC * (int)sizeof(T);
  if constexpr (BYTES == 16 || BYTES == 4) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    if constexpr (BYTES == 16)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                   "l"(src)
                   : "memory");
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                   "l"(src)
                   : "memory");
  } else {
    *dst = *src;
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------
// footprint design: grid = (B * N ROIs, channel chunks)
// ---------------------------------------------------------------------

// At most 224 threads per block (7 x 32 at out 7, 28 x 8 at out 14, 112
// x 1 at out 28 with one channel), three blocks per SM: ptxas then caps
// a thread at 80 registers.  96 (__maxnreg__) removed the float32
// kernel's spills but ran 15-25 % slower.
constexpr int FWD_THREADS = 224;
constexpr int FWD_BLOCKS_PER_SM = 3;
// output rows per thread: 7 divides the model's out sizes 7, 14 and 28
constexpr int NY = 7;

// Dynamic shared memory of one footprint block, in 4-byte words: the
// ring's two stages of `pixels` footprint pixels x `chunk` elements of
// `esize` bytes (whole 16-byte units), the banded weights [2][out][m],
// the listing's four [2][m] arrays, each output row's and column's band
// [2][out][2] and each footprint row's band [m][2].
__host__ __device__ __forceinline__ size_t fwd_footprint_words(
    int out_size, int m, int chunk, int pixels, int esize) {
  const size_t stage =
      (2 * (size_t)pixels * chunk * esize + 15) / 16 * 4;
  return stage + 2 * (size_t)out_size * m + 10 * (size_t)m +
         4 * (size_t)out_size;
}

// The footprint of one ROI on its level and its banded weights, listed
// in shared memory by the whole block.  Per axis a (0: rows, 1:
// columns) there are m = 2 * out_size * sampling taps, tap t = 2 * (bin
// * sampling + i) + (0 or 1), whose weight is wy (a = 0) or wx (a = 1):
//   s_tp[a*m + t]    the tap's pixel, or -1 outside the map or at weight 0
//   s_tw[a*m + t]    its weight
//   s_count[a]       the number of distinct pixels (footprint entries)
//   s_pix[a*m + f]   footprint entry f's pixel, ascending
//   s_idx[a*m + t]   the tap's footprint index (-1 for none)
//   s_w[(a*out_size + bin)*m + f]  the bin's tap weights on entry f, added
//                    in tap order: the banded matrices Wy and Wx
//   s_band[2*(a*out_size + bin)]  output row (a = 0) or column (a = 1)
//                    bin's first and last footprint row or column
//   s_band_r[2*f]    footprint row f's first and last output row
// These are the lists of the backward's listing (roi_align_bwd.cu), which
// finds each tap's entry by scanning the axis's taps, O(m) per tap; here
// one warp per axis walks the taps once.  list_footprint lists the
// footprint (steps 1-2: s_tp, s_tw, s_count, s_pix, s_idx) and returns
// after a __syncthreads, so that the first rows can be copied while
// banded_weights (step 3: s_w, s_band, s_band_r) runs.  Call it after a
// __syncthreads that follows setting geom, zeroing s_w [2][out_size][m]
// and setting s_band_r [m] to (out_size, -1).
__device__ __forceinline__ void list_footprint(
    const float* geom, int H, int W, int out_size, int sampling, float* s_tw,
    int* s_tp, int* s_idx, int* s_pix, int* s_count) {
  const int m = 2 * out_size * sampling;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  // 1. each sample's two taps per axis: the pixel and the weight
  for (int k = tid; k < 2 * m; k += nt) {
    const int a = k / m;
    const int t = k % m;
    const int j = t >> 1;  // sample index along the axis: bin * s + i
    const AxisTaps at =
        axis_taps(sample_coord(geom[a], geom[2 + a], j / sampling,
                               j % sampling, sampling),
                  a == 0 ? H : W);
    const bool second = t & 1;
    const float w = second ? at.w1 : at.w0;
    const bool in = second ? at.in1 : at.in0;
    s_tp[k] = (in && w != 0.0f) ? (second ? at.i1 : at.i0) : -1;
    s_tw[k] = w;
  }
  __syncthreads();
  // 2. one warp per axis lists the distinct pixels in one pass over the
  //    taps, 32 at a time.  The samples' floors i0 never decrease along
  //    the axis, so a tap's pixel (i0 or i0 + 1) is new exactly when it
  //    exceeds every earlier tap's (a prefix maximum over the lanes), and
  //    otherwise it is the last pixel listed or the one before it (then
  //    i0, listed with an earlier sample of the same i0 before its
  //    i0 + 1); new pixels are counted with a ballot
  const int lane = tid & 31;
  const int warps = (nt + 31) >> 5;
  const int width = min(32, nt - (tid & ~31));  // lanes in this warp
  const unsigned members = width == 32 ? 0xffffffffu : (1u << width) - 1;
  for (int a = tid >> 5; a < 2; a += warps) {
    int last = -1, count = 0;  // over the taps before this round
    for (int t0 = 0; t0 < m; t0 += width) {
      const int t = t0 + lane;
      const int p = t < m ? s_tp[a * m + t] : -1;
      int pm = p;  // prefix maximum over taps t0..t
      for (int d = 1; d < width; d <<= 1) {
        const int q = __shfl_up_sync(members, pm, d);
        if (lane >= d) pm = max(pm, q);
      }
      pm = max(pm, last);
      int prev = __shfl_up_sync(members, pm, 1);  // over taps before t
      if (lane == 0) prev = last;
      const bool is_new = p > prev;
      const unsigned ballot = __ballot_sync(members, is_new);
      // pixels listed up to and including tap t
      const int listed = count + __popc(ballot & (0xffffffffu >> (31 - lane)));
      if (t < m) {
        const int f = p < 0 ? -1 : listed - 1 - (is_new ? 0 : prev - p);
        if (is_new) s_pix[a * m + f] = p;
        s_idx[a * m + t] = f;
      }
      last = __shfl_sync(members, pm, width - 1);
      count += __popc(ballot);
    }
    if (lane == 0) s_count[a] = count;
  }
  __syncthreads();
}

// Step 3 of the listing: call after list_footprint; returns after a
// __syncthreads.
__device__ __forceinline__ void banded_weights(int out_size, int sampling,
                                               float* s_w, const float* s_tw,
                                               const int* s_idx, int* s_band,
                                               int* s_band_r) {
  const int m = 2 * out_size * sampling;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  // 3. banded weights: W[a][bin][f] = the bin's tap weights on footprint
  //    entry f (one thread per (axis, bin): no two threads share a
  //    word), each output row's or column's band of footprint rows or
  //    columns, and each footprint row's band of output rows (s_band_r
  //    preset to empty)
  for (int k = tid; k < 2 * out_size; k += nt) {
    const int a = k / out_size;
    const int bin = k % out_size;
    float* wrow = s_w + (size_t)k * m;
    int lo = m, hi = -1;
    for (int t = bin * 2 * sampling; t < (bin + 1) * 2 * sampling; ++t) {
      const int f = s_idx[a * m + t];
      if (f >= 0) {
        wrow[f] += s_tw[a * m + t];
        lo = min(lo, f);
        hi = max(hi, f);
        if (a == 0) {
          atomicMin(&s_band_r[2 * f], bin);
          atomicMax(&s_band_r[2 * f + 1], bin);
        }
      }
    }
    s_band[2 * k] = lo;
    s_band[2 * k + 1] = hi;
  }
  __syncthreads();
}

// Block threads: (row part, output column px, channel group of CV),
// channel group fastest, out * ceil(out / NY) * chunk / CV of them.
// Each thread holds the float32 sums of its column px at NY output
// rows for CV channels.  Footprint rows stream through two stages of
// shared memory, whole rows at a time (as many as `pixels` holds), in
// 16-byte cp.async copies of SV elements; every staged footprint row
// that reaches one of a thread's output rows is contracted along x over
// the band of columns of its bin px (Wx), then added to those rows with
// their Wy weights.
template <typename T, int SV, int CV>
__global__ void __launch_bounds__(FWD_THREADS, FWD_BLOCKS_PER_SM)
    roi_align_fwd_footprint_kernel(LevelTable lv, int num_levels,
                                   const float* __restrict__ rois,
                                   T* __restrict__ out, int n_rois, int C,
                                   int out_size, int sampling, int min_level,
                                   int chunk, int pixels) {
  extern __shared__ float4 s_mem[];
  const int m = 2 * out_size * sampling;  // taps per axis
  const size_t stage_elems = (size_t)pixels * chunk;
  T* s_stage = reinterpret_cast<T*>(s_mem);  // [2][pixels][chunk]
  float* s_w = reinterpret_cast<float*>(s_mem) +
               (2 * stage_elems * sizeof(T) + 15) / 16 * 4;  // [2][out][m]
  float* s_tw = s_w + 2 * out_size * m;              // [2][m]
  int* s_tp = reinterpret_cast<int*>(s_tw + 2 * m);  // [2][m]
  int* s_idx = s_tp + 2 * m;                         // [2][m]
  int* s_pix = s_idx + 2 * m;                        // [2][m]
  int* s_band = s_pix + 2 * m;                       // [2][out][2]
  int* s_band_r = s_band + 4 * out_size;             // [m][2] bins
  __shared__ int s_level, s_count[2];
  __shared__ float s_geom[4];  // y start, x start, bin_h, bin_w
  const int r = blockIdx.x;
  const int b = r / n_rois;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  if (tid == 0)
    s_level = roi_level_and_geometry(lv, num_levels, rois, r, out_size,
                                     min_level, s_geom);
  for (int k = tid; k < 2 * out_size * m; k += nt) s_w[k] = 0.0f;
  for (int k = tid; k < m; k += nt) {
    s_band_r[2 * k] = out_size;
    s_band_r[2 * k + 1] = -1;
  }
  __syncthreads();
  const int li = s_level;
  const int H = lv.h[li];
  const int W = lv.w[li];
  list_footprint(s_geom, H, W, out_size, sampling, s_tw, s_tp, s_idx, s_pix,
                 s_count);

  const int nrows = s_count[0];
  const int ncols = s_count[1];
  // whole footprint rows per stage, and the number of stages to fill
  const int rows_per = ncols > 0 ? pixels / ncols : 0;
  const int n_groups = rows_per > 0 ? (nrows + rows_per - 1) / rows_per : 0;
  const T* base = static_cast<const T*>(lv.ptr[li]) + (size_t)b * H * W * C;
  const int c0 = blockIdx.y * chunk;

  // staging: thread = (pixel slot, 16-byte vector of the chunk); slot s
  // copies pixels s, s + slots, ... of the group, row-major over
  // (footprint row, footprint column), in steps of (dii rows, djj
  // columns)
  const int nv = chunk / SV;
  const int sv = tid % nv;
  const int slot = tid / nv;
  const int slots = nt / nv;
  const bool stager = slot < slots && c0 + sv * SV < C;
  const int dii = ncols > 0 ? slots / ncols : 0;
  const int djj = slots - dii * ncols;
  const int ii0 = ncols > 0 ? slot / ncols : 0;
  const int jj0 = slot - ii0 * ncols;
  auto stage_rows = [&](int g) {
    if (stager) {
      T* dst = s_stage + (size_t)(g & 1) * stage_elems + sv * SV;
      const T* src = base + c0 + sv * SV;
      const int i0 = g * rows_per;
      const int nr = min(rows_per, nrows - i0);
      for (int ii = ii0, j = jj0; ii < nr;) {
        stage_copy<T, SV>(
            dst + ((size_t)ii * ncols + j) * chunk,
            src + ((size_t)s_pix[i0 + ii] * W + s_pix[m + j]) * C);
        ii += dii;
        j += djj;
        if (j >= ncols) {
          j -= ncols;
          ++ii;
        }
      }
    }
    cp_async_commit();
  };

  // the first rows' copies run while the weights are banded
  if (n_groups > 0) stage_rows(0);
  banded_weights(out_size, sampling, s_w, s_tw, s_idx, s_band, s_band_r);

  // compute: thread = (row part, output column px, channel group)
  const int groups = chunk / CV;
  const int cg = tid % groups;
  const int px = (tid / groups) % out_size;
  const int py0 = tid / (groups * out_size) * NY;
  const int c = c0 + cg * CV;
  // the footprint rows that reach this thread's output rows
  int rlo = m, rhi = -1;
  for (int py = py0; py < min(py0 + NY, out_size); ++py) {
    rlo = min(rlo, s_band[2 * py]);
    rhi = max(rhi, s_band[2 * py + 1]);
  }
  // bin px's band of footprint columns and its weights: at most 2 * s
  // columns, in registers where that is at most 4
  const int xlo = s_band[2 * (out_size + px)];
  const int xn = s_band[2 * (out_size + px) + 1] - xlo + 1;
  const float* wx = s_w + (size_t)(out_size + px) * m + xlo;
  float wxr[4];
#pragma unroll
  for (int d = 0; d < 4; ++d) wxr[d] = d < xn ? wx[d] : 0.0f;
  float acc[NY][CV];
#pragma unroll
  for (int q = 0; q < NY; ++q)
#pragma unroll
    for (int v = 0; v < CV; ++v) acc[q][v] = 0.0f;

  for (int g = 0; g < n_groups; ++g) {
    if (g + 1 < n_groups) {
      stage_rows(g + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // stage g has landed for every thread
    const int i0 = g * rows_per;
    const int nr = min(rows_per, nrows - i0);
    const T* st = s_stage + (size_t)(g & 1) * stage_elems + cg * CV;
    const int ii_end = c < C ? min(nr, rhi - i0 + 1) : 0;
    for (int ii = max(0, rlo - i0); ii < ii_end; ++ii) {
      const int i = i0 + ii;
      // along x: sum over the columns of bin px
      float x[CV];
#pragma unroll
      for (int v = 0; v < CV; ++v) x[v] = 0.0f;
      const T* srow = st + ((size_t)ii * ncols + xlo) * chunk;
      if (xn <= 4) {
#pragma unroll
        for (int d = 0; d < 4; ++d) {
          if (d < xn) {
            float f[CV];
            load_floats<CV>(srow + (size_t)d * chunk, f);
#pragma unroll
            for (int v = 0; v < CV; ++v) x[v] = fmaf(wxr[d], f[v], x[v]);
          }
        }
      } else {
        for (int d = 0; d < xn; ++d) {
          float f[CV];
          load_floats<CV>(srow + (size_t)d * chunk, f);
#pragma unroll
          for (int v = 0; v < CV; ++v) x[v] = fmaf(wx[d], f[v], x[v]);
        }
      }
      // along y: into this thread's output rows py0 + q that footprint
      // row i reaches, q - q0 in [0, nq)
      const int q0 = s_band_r[2 * i] - py0;
      const unsigned nq = (unsigned)(s_band_r[2 * i + 1] - s_band_r[2 * i] + 1);
      const float* wy = s_w + (size_t)py0 * m + i;
#pragma unroll
      for (int q = 0; q < NY; ++q) {
        if ((unsigned)(q - q0) < nq) {
          const float w = wy[(size_t)q * m];
#pragma unroll
          for (int v = 0; v < CV; ++v) acc[q][v] = fmaf(w, x[v], acc[q][v]);
        }
      }
    }
    __syncthreads();  // stage g is read: stage_rows(g + 2) may refill it
  }

  // the mean over each bin's samples, in the feature dtype
  if (c < C) {
    const float count = (float)(sampling * sampling);
    T* dst = out + ((size_t)r * out_size * out_size + px) * C + c;
#pragma unroll
    for (int q = 0; q < NY; ++q) {
      const int py = py0 + q;
      if (py < out_size) {
        float v[CV];
#pragma unroll
        for (int u = 0; u < CV; ++u) v[u] = acc[q][u] / count;
        store_floats<CV>(dst + (size_t)py * out_size * C, v);
      }
    }
  }
}

// ---------------------------------------------------------------------
// rowwise design: grid = (B * N ROIs, out_size rows); threads stride over
// channels
// ---------------------------------------------------------------------

// The block first writes its row's out_size * sampling^2 tap tables to
// shared memory (the geometry is the same for every channel), then each
// thread sums its channel over them with one load per tap.
template <typename T>
__global__ void roi_align_fwd_rowwise_kernel(LevelTable lv, int num_levels,
                                             const float* __restrict__ rois,
                                             T* __restrict__ out, int n_rois,
                                             int C, int out_size,
                                             int sampling, int min_level) {
  extern __shared__ Taps s_taps[];  // [out_size * sampling^2]
  __shared__ int s_level;
  __shared__ float s_geom[4];  // y start, x start, bin_h, bin_w
  const int r = blockIdx.x;
  const int py = blockIdx.y;
  const int b = r / n_rois;

  if (threadIdx.x == 0) {
    s_level = roi_level_and_geometry(lv, num_levels, rois, r, out_size,
                                     min_level, s_geom);
  }
  __syncthreads();

  const int li = s_level;
  const int H = lv.h[li];
  const int W = lv.w[li];
  const int per_bin = sampling * sampling;
  row_taps(s_taps, s_geom, py, out_size, sampling, H, W);
  __syncthreads();

  const float count = (float)per_bin;
  const T* base = static_cast<const T*>(lv.ptr[li]) + (size_t)b * H * W * C;
  T* dst = out + ((size_t)r * out_size + py) * out_size * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const T* f = base + c;
    for (int px = 0; px < out_size; ++px) {
      float acc = 0.0f;
      for (int j = 0; j < per_bin; ++j) {
        const Taps& t = s_taps[px * per_bin + j];
        float v = t.w[0] * load_as_float(f + (size_t)t.off[0] * C);
        v += t.w[1] * load_as_float(f + (size_t)t.off[1] * C);
        v += t.w[2] * load_as_float(f + (size_t)t.off[2] * C);
        v += t.w[3] * load_as_float(f + (size_t)t.off[3] * C);
        acc += v;
      }
      store_from_float(dst + (size_t)px * C + c, acc / count);
    }
  }
}

// ---------------------------------------------------------------------
// entry point
// ---------------------------------------------------------------------

namespace {

constexpr int MAX_DEVICES = 64;

struct DeviceInfo {
  int index = 0;
  int sms = 0;
  int smem_optin = 0;  // largest dynamic shared memory a block may ask for
  int smem_per_sm = 0;
};

// The current device's attributes, read once per device; callers on
// several threads see either nothing or the whole entry.
cudaError_t device_info(DeviceInfo* out) {
  static std::mutex mu;
  static DeviceInfo cache[MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  DeviceInfo& d = cache[dev];
  if (d.sms == 0) {
    DeviceInfo n;
    if ((e = cudaDeviceGetAttribute(&n.sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&n.smem_optin,
                                    cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                    dev)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(
             &n.smem_per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor,
             dev)) != cudaSuccess)
      return e;
    if (n.sms < 1) return cudaErrorInvalidDevice;
    n.index = dev;
    d = n;
  }
  *out = d;
  return cudaSuccess;
}

// Channels per footprint block: out * ceil(out / NY) * chunk / cv
// threads at most FWD_THREADS, the sv-padded channels split evenly, and
// two stages of at least one worst-case footprint row (m pixels) within
// `budget` bytes of shared memory; *pixels = the pixels per stage that
// then fit (at most m * m).  0 where not even sv channels fit.
int footprint_chunk(int out_size, int m, int C, int sv, int cv, int esize,
                    size_t budget, int* pixels) {
  const int slots = out_size * ((out_size + NY - 1) / NY);
  int cmax = FWD_THREADS / slots * cv;
  cmax -= cmax % sv;
  if (cmax < sv) return 0;
  const int padded = (C + sv - 1) / sv * sv;
  for (int chunks = (padded + cmax - 1) / cmax;; ++chunks) {
    int chunk = (padded + chunks - 1) / chunks;
    chunk = (chunk + sv - 1) / sv * sv;
    const size_t fixed = 4 * fwd_footprint_words(out_size, m, chunk, 0, esize);
    const size_t per_pixel =
        4 * fwd_footprint_words(out_size, m, chunk, 1, esize) - fixed;
    if (budget >= fixed + per_pixel * m) {
      const size_t fit = (budget - fixed) / per_pixel;
      *pixels = fit < (size_t)m * m ? (int)fit : m * m;
      return chunk;
    }
    if (chunk == sv) return 0;
  }
}

// The footprint kernel where its threads and shared memory allow, else
// the rowwise one.  SV: elements per staged copy; CV: channels per
// thread.
template <typename T, int SV, int CV>
cudaError_t launch_fwd(const LevelTable& lv, int num_levels,
                       const float* rois, T* out, long long blocks,
                       int n_rois, int C, int out_size, int sampling,
                       int min_level, const DeviceInfo& dev,
                       cudaStream_t st) {
  const int m = 2 * out_size * sampling;
  // FWD_BLOCKS_PER_SM blocks per SM where the shared memory allows it
  // (each block also holds 1 KB the runtime reserves and its static
  // shared words)
  const size_t share = (size_t)dev.smem_per_sm / FWD_BLOCKS_PER_SM - 2048;
  const int esize = (int)sizeof(T);
  int pixels = 0;
  int chunk = footprint_chunk(
      out_size, m, C, SV, CV, esize,
      share < (size_t)dev.smem_optin ? share : dev.smem_optin, &pixels);
  if (chunk == 0)
    chunk = footprint_chunk(out_size, m, C, SV, CV, esize,
                            dev.smem_optin, &pixels);
  if (chunk > 0) {
    const int smem = (int)(4 * fwd_footprint_words(out_size, m, chunk,
                                                   pixels, esize));
    // the shared memory granted so far, per device (raised, never lowered)
    static std::atomic<int> granted[MAX_DEVICES];
    if (smem > 48 * 1024 && smem > granted[dev.index].load()) {
      const cudaError_t e = cudaFuncSetAttribute(
          roi_align_fwd_footprint_kernel<T, SV, CV>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return e;
      granted[dev.index].store(smem);
    }
    const int threads = out_size * ((out_size + NY - 1) / NY) *
                        (chunk / CV);
    const dim3 grid((unsigned)blocks, (unsigned)((C + chunk - 1) / chunk));
    roi_align_fwd_footprint_kernel<T, SV, CV><<<grid, threads, smem, st>>>(
        lv, num_levels, rois, out, n_rois, C, out_size, sampling, min_level,
        chunk, pixels);
    return cudaGetLastError();
  }
  const size_t smem = sizeof(Taps) * (size_t)out_size * sampling * sampling;
  if (smem > (size_t)dev.smem_optin || out_size > 65535)
    return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        roi_align_fwd_rowwise_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int threads = C < 256 ? ((C + 31) / 32) * 32 : 256;
  const dim3 grid((unsigned)blocks, (unsigned)out_size);
  roi_align_fwd_rowwise_kernel<T><<<grid, threads, smem, st>>>(
      lv, num_levels, rois, out, n_rois, C, out_size, sampling, min_level);
  return cudaGetLastError();
}

// 16-byte copies (4 float32 or 8 bfloat16) into shared memory and four
// channels per thread where every access is a whole vector, one channel
// at a time otherwise.
template <typename T>
cudaError_t launch_fwd_vec(bool vec, const LevelTable& lv, int num_levels,
                           const float* rois, void* out, long long blocks,
                           int n_rois, int C, int out_size, int sampling,
                           int min_level, const DeviceInfo& dev,
                           cudaStream_t st) {
  constexpr int SV = 16 / (int)sizeof(T);
  T* o = static_cast<T*>(out);
  return vec ? launch_fwd<T, SV, 4>(lv, num_levels, rois, o, blocks, n_rois,
                                    C, out_size, sampling, min_level, dev,
                                    st)
             : launch_fwd<T, 1, 1>(lv, num_levels, rois, o, blocks, n_rois,
                                   C, out_size, sampling, min_level, dev, st);
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

}  // namespace

extern "C" {

// feats: host array of `num_levels` device pointers to NHWC
// [B, H_l, W_l, C] maps; hw: host array of (H_l, W_l) pairs; scales:
// host array of 1/stride_l.  rois: device float32 [B * N, 4]; out:
// device [B * N, out_size, out_size, C] in the feature dtype
// (dtype 0 = float32, 1 = bfloat16).  Launches on `stream` and returns
// the launch's error code; it never synchronises.
cudaError_t eksml_roi_align_fwd(const void* feats, const void* hw,
                                const void* scales, int num_levels,
                                const void* rois, void* out, int batch,
                                int n_rois, int channels, int out_size,
                                int sampling, int min_level, int dtype,
                                void* stream) {
  if (num_levels < 1 || num_levels > EKSML_MAX_LEVELS || dtype < 0 ||
      dtype > 1 || sampling < 1 || out_size < 1 || channels < 1)
    return cudaErrorInvalidValue;
  const LevelTable lv = make_level_table(feats, hw, scales, num_levels);
  const long long blocks = (long long)batch * n_rois;
  if (blocks == 0) return cudaSuccess;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  DeviceInfo dev;
  const cudaError_t e = device_info(&dev);
  if (e != cudaSuccess) return e;
  // 16 bytes per load and store where every access is a whole vector
  bool vec = channels % (dtype == 0 ? 4 : 8) == 0 && aligned(out, 16);
  for (int i = 0; i < num_levels; ++i) vec = vec && aligned(lv.ptr[i], 16);
  const float* r = static_cast<const float*>(rois);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_fwd_vec<float>(vec, lv, num_levels, r, out, blocks, n_rois,
                                 channels, out_size, sampling, min_level, dev,
                                 st);
  return launch_fwd_vec<__nv_bfloat16>(vec, lv, num_levels, r, out, blocks,
                                       n_rois, channels, out_size, sampling,
                                       min_level, dev, st);
}

const char* eksml_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
