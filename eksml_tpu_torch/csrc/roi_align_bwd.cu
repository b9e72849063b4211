// Multilevel ROIAlign backward and the accumulator copy, for Hopper
// (sm_90a).
//
// 1. The ROIAlign backward replaces the Pallas TPU kernel
//    eksml_tpu/ops/pallas/roi_align_kernel.py::_bwd_kernel (driven by
//    _pallas_backward).  It computes the feature gradient of the forward
//    in roi_align_fwd.cu: each sample's four taps receive
//    w * g[c] / sampling^2 in float32, added into per-level float32
//    accumulators [B, H_l, W_l, C]; the gradient of the ROIs is zero, as
//    in the reference.  Taps outside the map are dropped, as the forward
//    reads them as zero.  The level rule, the geometry and the taps come
//    from roi_align_common.cuh, so the gradient lands on exactly the
//    pixels, with exactly the weights, that the forward read.  Blocks add
//    into the accumulators with float32 atomics, in an order that changes
//    from run to run: the gradient is not bitwise reproducible.
//
//    Bound on the H100 (3.35 TB/s): bytes.  The least traffic is g read
//    once plus every accumulator pixel the ROIs' taps touch, read and
//    written once in float32; the arithmetic is far below the card's
//    flops per byte.  What holds a direct design back is the number of
//    global atomics: one per tap per channel is 2048 ROIs x 49 bins x 16
//    taps x 256 channels = 411 M at the box-head training call, and
//    neighbouring samples and ROIs contend for the same pixels in L2.
//
//    Two kernels, one entry point, which takes the footprint kernel
//    wherever its shared memory fits:
//
//    - footprint (roi_align_bwd_footprint_kernel): one block
//      per (ROI, channel chunk).  The backward is separable: a tap's
//      weight is wy * wx.  The block lists the distinct map rows and
//      columns that the ROI's taps of nonzero weight reach (at most
//      2 * out * s each), folds each bin's taps into banded weight
//      matrices Wy [out x rows] and Wx [out x cols], reduces g along x
//      into shared memory, T[py][col] = sum_px Wx[px][col] g[py][px],
//      and then issues ONE global reduction per footprint pixel and
//      channel group: sum_py Wy[py][row] T[py][col] / s^2.  This is the
//      TPU kernel's RyP^T . g . CxP (roi_align_kernel.py:395) as banded
//      FFMA in shared memory instead of dense MXU products.
//    - rowwise (roi_align_bwd_rowwise_kernel): one block per (ROI,
//      output row) with the row's taps in shared memory and one
//      reduction per tap per channel group.  The entry point takes it
//      where the footprint's shared memory does not fit (large out).
//
//    Both reduce four channels at once with sm_90's float4 atomicAdd
//    (red.global.add.v4.f32) when C % 4 == 0 and the buffers are aligned
//    for vector access, and one channel at a time otherwise.
//
// 2. The copy replaces the kernel `k` inside
//    roi_align_kernel.py::_to_hbm, a whole-buffer DMA of its input into
//    an output buffer in HBM, used there to seed the backward's zeroed
//    float32 accumulators.  Bound: 2 x bytes / 3.35 TB/s.
//    copy_bulk_kernel runs a ring of BULK_STAGES TMA bulk copies per
//    block, cp.async.bulk global -> shared completed on an mbarrier,
//    then shared -> global, driven by one thread per block, on a
//    persistent grid of BULK_BLOCKS_PER_SM blocks per SM (at most their
//    occupancy): 32 KB in flight per SM.  On the H100 it ran about 2 %
//    ahead of a grid-stride copy of four in-flight 16-byte streaming
//    loads per thread at its best grid, also 2 blocks per SM, in both
//    event and device-only times.  The bytes before the first and after
//    the last aligned 16-byte vector are copied one at a time; buffers
//    whose addresses differ modulo 16 are copied byte by byte.

#include <mutex>

#include "roi_align_common.cuh"

// ---------------------------------------------------------------------
// vector access: VEC consecutive channels as float
// ---------------------------------------------------------------------

template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float* v) {
  if constexpr (VEC == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    v[0] = __ldg(p);
  }
}

template <int VEC>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* v) {
  if constexpr (VEC == 4) {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 lo = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&q.x));
    const float2 hi = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&q.y));
    v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
  } else {
    v[0] = __bfloat162float(*p);
  }
}

// Add v into p[0..VEC): one global vector reduction for VEC == 4.
template <int VEC>
__device__ __forceinline__ void red_add(float* p, const float* v) {
  if constexpr (VEC == 4) {
    atomicAdd(reinterpret_cast<float4*>(p),
              make_float4(v[0], v[1], v[2], v[3]));
  } else {
    atomicAdd(p, v[0]);
  }
}

// ---------------------------------------------------------------------
// rowwise design: grid = (B * N ROIs, out_size rows); threads stride over
// channel groups of VEC
// ---------------------------------------------------------------------

template <typename T, int VEC>
__global__ void roi_align_bwd_rowwise_kernel(LevelTable acc, int num_levels,
                                             const float* __restrict__ rois,
                                             const T* __restrict__ g,
                                             int n_rois, int C, int out_size,
                                             int sampling, int min_level) {
  extern __shared__ Taps s_taps[];  // [out_size * sampling^2]
  __shared__ int s_level;
  __shared__ float s_geom[4];  // y start, x start, bin_h, bin_w
  const int r = blockIdx.x;
  const int py = blockIdx.y;
  const int b = r / n_rois;

  if (threadIdx.x == 0) {
    s_level = roi_level_and_geometry(acc, num_levels, rois, r, out_size,
                                     min_level, s_geom);
  }
  __syncthreads();

  const int li = s_level;
  const int H = acc.h[li];
  const int W = acc.w[li];
  const int per_bin = sampling * sampling;
  row_taps(s_taps, s_geom, py, out_size, sampling, H, W);
  __syncthreads();

  const float count = (float)per_bin;
  float* base = static_cast<float*>(acc.ptr[li]) + (size_t)b * H * W * C;
  const T* grow = g + ((size_t)r * out_size + py) * out_size * C;
  for (int c = threadIdx.x * VEC; c < C; c += blockDim.x * VEC) {
    float* a = base + c;
    for (int px = 0; px < out_size; ++px) {
      float gv[VEC];
      load_vec<VEC>(grow + (size_t)px * C + c, gv);
#pragma unroll
      for (int v = 0; v < VEC; ++v) gv[v] /= count;
      for (int j = 0; j < per_bin; ++j) {
        const Taps& t = s_taps[px * per_bin + j];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (t.w[k] != 0.0f) {
            float d[VEC];
#pragma unroll
            for (int v = 0; v < VEC; ++v) d[v] = t.w[k] * gv[v];
            red_add<VEC>(a + (size_t)t.off[k] * C, d);
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------
// footprint design: grid = (B * N ROIs, channel chunks)
// ---------------------------------------------------------------------

// Dynamic shared memory of one footprint block, in 4-byte words: T
// [out][m][chunk], the banded weights [2][out][m], and per axis the taps'
// weights, pixels, first-occurrence flags and footprint indices, the
// footprint list and each entry's band of bins (m = 2 * out * sampling
// taps per axis).
__host__ __device__ __forceinline__ size_t footprint_words(int out_size,
                                                           int m, int chunk) {
  return (size_t)out_size * m * chunk + 2 * (size_t)out_size * m + 14 * (size_t)m;
}

constexpr int FOOTPRINT_THREADS = 512;

template <typename T, int VEC>
__global__ void __launch_bounds__(FOOTPRINT_THREADS, 2)
    roi_align_bwd_footprint_kernel(
    LevelTable acc, int num_levels, const float* __restrict__ rois,
    const T* __restrict__ g, int n_rois, int C, int out_size, int sampling,
    int min_level, int chunk) {
  extern __shared__ float4 s_mem[];
  const int m = 2 * out_size * sampling;  // taps per axis
  float* s_t = reinterpret_cast<float*>(s_mem);         // [out][m][chunk]
  float* s_w = s_t + (size_t)out_size * m * chunk;      // [2][out][m]
  float* s_tw = s_w + 2 * out_size * m;                 // [2][m]
  int* s_tp = reinterpret_cast<int*>(s_tw + 2 * m);     // [2][m] pixel
  int* s_first = s_tp + 2 * m;                          // [2][m]
  int* s_idx = s_first + 2 * m;                         // [2][m]
  int* s_pix = s_idx + 2 * m;                           // [2][m] footprint
  int* s_band = s_pix + 2 * m;                          // [2][m][2]
  __shared__ int s_level, s_count[2];
  __shared__ float s_geom[4];  // y start, x start, bin_h, bin_w
  const int r = blockIdx.x;
  const int b = r / n_rois;
  const int c0 = blockIdx.y * chunk;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  if (tid == 0) {
    s_level = roi_level_and_geometry(acc, num_levels, rois, r, out_size,
                                     min_level, s_geom);
    s_count[0] = s_count[1] = 0;
  }
  for (int k = tid; k < 2 * out_size * m; k += nt) s_w[k] = 0.0f;
  __syncthreads();
  const int li = s_level;
  const int H = acc.h[li];
  const int W = acc.w[li];

  // 1. each sample's two taps per axis (a = 0: rows, 1: columns): the
  //    pixel, or -1 outside the map or at weight 0, and the weight
  for (int k = tid; k < 2 * m; k += nt) {
    const int a = k / m;
    const int t = k % m;
    const int j = t >> 1;  // sample index along the axis: bin * s + i
    const AxisTaps at =
        axis_taps(sample_coord(s_geom[a], s_geom[2 + a], j / sampling,
                               j % sampling, sampling),
                  a == 0 ? H : W);
    const bool second = t & 1;
    const float w = second ? at.w1 : at.w0;
    const bool in = second ? at.in1 : at.in0;
    s_tp[k] = (in && w != 0.0f) ? (second ? at.i1 : at.i0) : -1;
    s_tw[k] = w;
  }
  __syncthreads();
  // 2. the first tap on each distinct pixel, counted per axis
  for (int k = tid; k < 2 * m; k += nt) {
    const int a = k / m;
    const int p = s_tp[k];
    bool first = p >= 0;
    for (int u = a * m; u < k && first; ++u) first = s_tp[u] != p;
    s_first[k] = first;
    if (first) atomicAdd(&s_count[a], 1);
  }
  __syncthreads();
  // 3. each tap's footprint index (distinct pixels below its pixel), and
  //    the sorted footprint lists
  for (int k = tid; k < 2 * m; k += nt) {
    const int a = k / m;
    const int p = s_tp[k];
    int rank = -1;
    if (p >= 0) {
      rank = 0;
      for (int u = a * m; u < (a + 1) * m; ++u)
        rank += (s_first[u] && s_tp[u] < p) ? 1 : 0;
      if (s_first[k]) s_pix[a * m + rank] = p;
    }
    s_idx[k] = rank;
  }
  __syncthreads();
  // 4. banded weights: W[a][bin][f] = the bin's tap weights on footprint
  //    entry f (one thread per (axis, bin): no two threads share a word)
  for (int k = tid; k < 2 * out_size; k += nt) {
    const int a = k / out_size;
    const int bin = k % out_size;
    float* wrow = s_w + (size_t)k * m;
    for (int t = bin * 2 * sampling; t < (bin + 1) * 2 * sampling; ++t) {
      const int f = s_idx[a * m + t];
      if (f >= 0) wrow[f] += s_tw[a * m + t];
    }
  }
  __syncthreads();
  // 5. each footprint entry's first and last bin of nonzero weight
  for (int k = tid; k < 2 * m; k += nt) {
    const int a = k / m;
    const int f = k % m;
    if (f >= s_count[a]) continue;
    int lo = out_size, hi = -1;
    for (int bin = 0; bin < out_size; ++bin) {
      if (s_w[((size_t)a * out_size + bin) * m + f] != 0.0f) {
        lo = min(lo, bin);
        hi = bin;
      }
    }
    s_band[2 * k] = lo;
    s_band[2 * k + 1] = hi;
  }
  __syncthreads();

  const int nrows = s_count[0];
  const int ncols = s_count[1];
  const int groups = chunk / VEC;
  const T* gr = g + (size_t)r * out_size * out_size * C;
  const float* wy = s_w;
  const float* wx = s_w + (size_t)out_size * m;
  const int* band_y = s_band;
  const int* band_x = s_band + 2 * m;

  // pass 1 along x: T[py][j] = sum over the bins px that reach column j
  // of Wx[px][j] * g[py][px]; threads own (py, j, channel group)
  for (int k = tid; k < out_size * ncols * groups; k += nt) {
    const int cg = k % groups;
    const int j = (k / groups) % ncols;
    const int py = k / (groups * ncols);
    const int c = c0 + cg * VEC;
    float sum[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) sum[v] = 0.0f;
    if (c < C) {
      for (int px = band_x[2 * j]; px <= band_x[2 * j + 1]; ++px) {
        float gv[VEC];
        load_vec<VEC>(gr + ((size_t)py * out_size + px) * C + c, gv);
        const float w = wx[(size_t)px * m + j];
#pragma unroll
        for (int v = 0; v < VEC; ++v) sum[v] = fmaf(w, gv[v], sum[v]);
      }
    }
    float* dst = s_t + ((size_t)py * m + j) * chunk + cg * VEC;
    if constexpr (VEC == 4) {
      *reinterpret_cast<float4*>(dst) =
          make_float4(sum[0], sum[1], sum[2], sum[3]);
    } else {
      dst[0] = sum[0];
    }
  }
  __syncthreads();

  // pass 2 along y: one reduction per footprint pixel and channel group,
  // sum over the bins py that reach row i of Wy[py][i] * T[py][j] / s^2;
  // threads own (i, j, channel group)
  const float inv_count = 1.0f / (float)(sampling * sampling);
  float* base = static_cast<float*>(acc.ptr[li]) + (size_t)b * H * W * C;
  for (int k = tid; k < nrows * ncols * groups; k += nt) {
    const int cg = k % groups;
    const int j = (k / groups) % ncols;
    const int i = k / (groups * ncols);
    const int c = c0 + cg * VEC;
    if (c >= C) continue;
    float sum[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) sum[v] = 0.0f;
    for (int py = band_y[2 * i]; py <= band_y[2 * i + 1]; ++py) {
      const float w = wy[(size_t)py * m + i];
      const float* t = s_t + ((size_t)py * m + j) * chunk + cg * VEC;
      if constexpr (VEC == 4) {
        const float4 q = *reinterpret_cast<const float4*>(t);
        sum[0] = fmaf(w, q.x, sum[0]);
        sum[1] = fmaf(w, q.y, sum[1]);
        sum[2] = fmaf(w, q.z, sum[2]);
        sum[3] = fmaf(w, q.w, sum[3]);
      } else {
        sum[0] = fmaf(w, t[0], sum[0]);
      }
    }
#pragma unroll
    for (int v = 0; v < VEC; ++v) sum[v] *= inv_count;
    red_add<VEC>(base + ((size_t)s_pix[i] * W + s_pix[m + j]) * C + c, sum);
  }
}

// ---------------------------------------------------------------------
// the accumulator copy
// ---------------------------------------------------------------------

constexpr int BULK_THREADS = 32;
constexpr int BULK_STAGES = 4;
constexpr int BULK_TILE = 4096;  // bytes per stage
constexpr int BULK_BLOCKS_PER_SM = 2;

// The bytes [0, lead) and [lead + 16 * n16, nbytes) one at a time,
// strided over the grid's threads.
__device__ __forceinline__ void copy_edges(const unsigned char* src,
                                           unsigned char* dst, size_t lead,
                                           size_t n16, size_t nbytes) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  const size_t tail = lead + n16 * 16;
  const size_t n_edge = lead + (nbytes - tail);
  for (size_t k = (size_t)blockIdx.x * blockDim.x + threadIdx.x; k < n_edge;
       k += stride) {
    const size_t at = k < lead ? k : tail + (k - lead);
    dst[at] = src[at];
  }
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned phase) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra.uni DONE;\n"
      "bra.uni WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(phase)
      : "memory");
}

// The 16-byte body as a ring of BULK_STAGES tiles in shared memory: one
// thread per block issues TMA bulk loads (completed on an mbarrier per
// stage) and bulk stores, refilling a stage once its store has read it.
__global__ void __launch_bounds__(BULK_THREADS) copy_bulk_kernel(
    const unsigned char* __restrict__ src, unsigned char* __restrict__ dst,
    size_t lead, size_t n16, size_t nbytes) {
  __shared__ __align__(128) unsigned char s_buf[BULK_STAGES * BULK_TILE];
  __shared__ __align__(8) unsigned long long s_bar[BULK_STAGES];
  if (threadIdx.x == 0) {
    const size_t body = n16 * 16;
    const size_t n_tiles = (body + BULK_TILE - 1) / BULK_TILE;
    const long long mine =
        n_tiles > blockIdx.x
            ? (long long)((n_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x)
            : 0;
    const unsigned bar0 = (unsigned)__cvta_generic_to_shared(s_bar);
    const unsigned buf0 = (unsigned)__cvta_generic_to_shared(s_buf);
    for (int s = 0; s < BULK_STAGES; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar0 + 8 * s)
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    auto tile = [&](long long i, size_t* off) {
      *off = ((size_t)blockIdx.x + (size_t)i * gridDim.x) * BULK_TILE;
      const size_t left = body - *off;
      return (unsigned)(left < BULK_TILE ? left : BULK_TILE);
    };
    auto load = [&](long long i) {
      size_t off;
      const unsigned bytes = tile(i, &off);
      const unsigned bar = bar0 + 8 * (unsigned)(i % BULK_STAGES);
      const unsigned buf = buf0 + BULK_TILE * (unsigned)(i % BULK_STAGES);
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
          "r"(bytes)
          : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n" ::"r"(buf),
          "l"(reinterpret_cast<unsigned long long>(src + lead + off)),
          "r"(bytes), "r"(bar)
          : "memory");
    };
    for (long long i = 0; i < mine && i < BULK_STAGES; ++i) load(i);
    for (long long i = 0; i < mine; ++i) {
      size_t off;
      const unsigned bytes = tile(i, &off);
      const unsigned stage = (unsigned)(i % BULK_STAGES);
      mbar_wait(bar0 + 8 * stage, (unsigned)((i / BULK_STAGES) & 1));
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
              reinterpret_cast<unsigned long long>(dst + lead + off)),
          "r"(buf0 + BULK_TILE * stage), "r"(bytes)
          : "memory");
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      // the previous tile's store has read its stage: refill that stage
      if (i >= 1 && i - 1 + BULK_STAGES < mine) {
        asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
        load(i - 1 + BULK_STAGES);
      }
    }
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
  copy_edges(src, dst, lead, n16, nbytes);
}

// ---------------------------------------------------------------------
// entry points
// ---------------------------------------------------------------------

namespace {

constexpr int MAX_DEVICES = 64;

struct DeviceInfo {
  int sms = 0;
  int smem_optin = 0;   // largest dynamic shared memory a block may ask for
  int smem_per_sm = 0;
  int copy_blocks = 0;  // blocks of the copy kernel per SM
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
             dev)) != cudaSuccess ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &n.copy_blocks, copy_bulk_kernel, BULK_THREADS, 0)) !=
            cudaSuccess)
      return e;
    if (n.sms < 1 || n.copy_blocks < 1) return cudaErrorInvalidDevice;
    if (n.copy_blocks > BULK_BLOCKS_PER_SM) n.copy_blocks = BULK_BLOCKS_PER_SM;
    d = n;
  }
  *out = d;
  return cudaSuccess;
}

// Channels per footprint block within `budget` bytes of shared memory:
// the chunks split the VEC-padded channels evenly; 0 when not even VEC
// channels fit.
int footprint_chunk(int out_size, int m, int C, int vec, size_t budget) {
  const size_t fixed = 4 * footprint_words(out_size, m, 0);
  const size_t per_channel = 4 * (size_t)out_size * m;
  if (budget < fixed + per_channel * vec) return 0;
  int cmax = (int)((budget - fixed) / per_channel);
  cmax -= cmax % vec;
  const int padded = (C + vec - 1) / vec * vec;
  const int chunks = (padded + cmax - 1) / cmax;
  const int chunk = (padded + chunks - 1) / chunks;
  return (chunk + vec - 1) / vec * vec;
}

// The footprint kernel where its shared memory fits, else the rowwise one.
template <typename T, int VEC>
cudaError_t launch_bwd(const LevelTable& lv, int num_levels,
                       const float* rois, const T* g, long long blocks,
                       int n_rois, int C, int out_size, int sampling,
                       int min_level, const DeviceInfo& dev,
                       cudaStream_t st) {
  const int m = 2 * out_size * sampling;
  // at least two blocks per SM where the shared memory allows it (each
  // block also holds 1 KB the runtime reserves and its static shared
  // words)
  const size_t two = (size_t)dev.smem_per_sm / 2 - 2048;
  int chunk = footprint_chunk(out_size, m, C, VEC,
                              two < (size_t)dev.smem_optin ? two
                                                           : dev.smem_optin);
  if (chunk == 0) chunk = footprint_chunk(out_size, m, C, VEC, dev.smem_optin);
  if (chunk > 0) {
    const size_t smem = 4 * footprint_words(out_size, m, chunk);
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          roi_align_bwd_footprint_kernel<T, VEC>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return e;
    }
    const dim3 grid((unsigned)blocks, (unsigned)((C + chunk - 1) / chunk));
    roi_align_bwd_footprint_kernel<T, VEC>
        <<<grid, FOOTPRINT_THREADS, smem, st>>>(
        lv, num_levels, rois, g, n_rois, C, out_size, sampling, min_level,
        chunk);
    return cudaGetLastError();
  }
  const size_t smem = sizeof(Taps) * (size_t)out_size * sampling * sampling;
  if (smem > (size_t)dev.smem_optin || out_size > 65535)
    return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        roi_align_bwd_rowwise_kernel<T, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int groups = (C + VEC - 1) / VEC;
  const int threads = groups < 256 ? ((groups + 31) / 32) * 32 : 256;
  const dim3 grid((unsigned)blocks, (unsigned)out_size);
  roi_align_bwd_rowwise_kernel<T, VEC><<<grid, threads, smem, st>>>(
      lv, num_levels, rois, g, n_rois, C, out_size, sampling, min_level);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd_vec(bool vec4, const LevelTable& lv, int num_levels,
                           const float* rois, const void* g,
                           long long blocks, int n_rois, int C, int out_size,
                           int sampling, int min_level, const DeviceInfo& dev,
                           cudaStream_t st) {
  const T* gt = static_cast<const T*>(g);
  return vec4 ? launch_bwd<T, 4>(lv, num_levels, rois, gt, blocks, n_rois, C,
                                 out_size, sampling, min_level, dev, st)
              : launch_bwd<T, 1>(lv, num_levels, rois, gt, blocks, n_rois, C,
                                 out_size, sampling, min_level, dev, st);
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

}  // namespace

extern "C" {

// accs: host array of `num_levels` device pointers to float32 NHWC
// [B, H_l, W_l, C] accumulators, added into (not overwritten); hw: host
// array of (H_l, W_l) pairs; scales: host array of 1/stride_l.  rois:
// device float32 [B * N, 4]; g: device [B * N, out_size, out_size, C]
// in the feature dtype (dtype 0 = float32, 1 = bfloat16).  Launches on
// `stream` and returns the launch's error code; it never synchronises.
cudaError_t eksml_roi_align_bwd(const void* accs, const void* hw,
                                const void* scales, int num_levels,
                                const void* rois, const void* g, int batch,
                                int n_rois, int channels, int out_size,
                                int sampling, int min_level, int dtype,
                                void* stream) {
  if (num_levels < 1 || num_levels > EKSML_MAX_LEVELS || dtype < 0 ||
      dtype > 1 || sampling < 1 || out_size < 1 || channels < 1)
    return cudaErrorInvalidValue;
  const LevelTable lv = make_level_table(accs, hw, scales, num_levels);
  const long long blocks = (long long)batch * n_rois;
  if (blocks == 0) return cudaSuccess;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  DeviceInfo dev;
  const cudaError_t e = device_info(&dev);
  if (e != cudaSuccess) return e;
  // four channels per reduction where every access is a whole vector
  bool vec4 = channels % 4 == 0 && aligned(g, dtype == 0 ? 16 : 8);
  for (int i = 0; i < num_levels; ++i) vec4 = vec4 && aligned(lv.ptr[i], 16);
  const float* r = static_cast<const float*>(rois);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd_vec<float>(vec4, lv, num_levels, r, g, blocks, n_rois,
                                 channels, out_size, sampling, min_level, dev,
                                 st);
  return launch_bwd_vec<__nv_bfloat16>(vec4, lv, num_levels, r, g, blocks,
                                       n_rois, channels, out_size, sampling,
                                       min_level, dev, st);
}

// Copy `nbytes` from device buffer `src` to device buffer `dst` (which
// must not overlap) on `stream`.  Returns the launch's error code.
cudaError_t eksml_copy_to_global(const void* src, void* dst,
                                 long long nbytes, void* stream) {
  if (nbytes < 0) return cudaErrorInvalidValue;
  if (nbytes == 0) return cudaSuccess;
  DeviceInfo dev;
  const cudaError_t e = device_info(&dev);
  if (e != cudaSuccess) return e;
  const uintptr_t sa = reinterpret_cast<uintptr_t>(src);
  const uintptr_t da = reinterpret_cast<uintptr_t>(dst);
  const size_t n = (size_t)nbytes;
  // 16-byte vectors where both buffers reach a 16-byte boundary together
  size_t lead = n, n16 = 0;
  if ((sa & 15) == (da & 15)) {
    lead = (16 - (sa & 15)) & 15;
    if (lead > n) lead = n;
    n16 = (n - lead) / 16;
  }
  // one block per tile of the body or per BULK_THREADS edge bytes, at
  // most the resident blocks
  const size_t tiles = (n16 * 16 + BULK_TILE - 1) / BULK_TILE;
  const size_t edge_blocks = (n - n16 * 16 + BULK_THREADS - 1) / BULK_THREADS;
  size_t blocks = tiles > edge_blocks ? tiles : edge_blocks;
  const size_t resident = (size_t)dev.copy_blocks * dev.sms;
  if (blocks > resident) blocks = resident;
  copy_bulk_kernel<<<(unsigned)blocks, BULK_THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(src), static_cast<unsigned char*>(dst),
      lead, n16, n);
  return cudaGetLastError();
}

const char* eksml_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
