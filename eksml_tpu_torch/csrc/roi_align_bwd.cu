// Multilevel ROIAlign backward and the accumulator copy, for Hopper
// (sm_90a).  Two kernels:
//
// 1. roi_align_bwd_kernel replaces the Pallas TPU kernel
//    eksml_tpu/ops/pallas/roi_align_kernel.py::_bwd_kernel (driven by
//    _pallas_backward).  It computes the feature gradient of the forward
//    in roi_align_fwd.cu: each sample's four taps receive
//    w * g[c] / sampling^2 in float32, into per-level float32
//    accumulators [B, H_l, W_l, C]; the gradient of the ROIs is zero, as
//    in the reference.  The TPU kernel contracts g with two pooled
//    weight matrices on the MXU (RyP^T . g . CxP) and read-modify-writes
//    a 64x64 accumulator tile per ROI through DMA, with an async
//    write-back and its hazard drain, a golden-ratio ROI permutation,
//    chunking and HBM pinning.  Those are TPU rules and none of them
//    carries over.  Here the level is the plain FPN heuristic, as in the
//    forward (roi_align_common.cuh), and blocks add into the accumulators
//    with float32 atomics, in an order that changes from run to run: the
//    gradient is not bitwise reproducible.  Taps outside the map are
//    dropped, as the forward reads them as zero.
//
//    Bound on the H100 (3.35 TB/s): bytes.  The least traffic is g read
//    once (R x out^2 x C in the feature dtype) plus every accumulator
//    pixel the ROIs' taps touch, read and written once in float32 (C
//    channels each); the arithmetic (a multiply and an add per tap per
//    channel) is far below the card's flops per byte.  What holds this
//    simple design back is the atomics: one per tap per channel, at the
//    box-head training shape 2048 ROIs x 49 bins x 16 taps x 256
//    channels = 411 M per call, and as many at the mask shape (512 x 196
//    x 16 x 256).  Neighbouring samples and ROIs hit the same pixels, so
//    many of them contend in L2.
//
//    Layout, as in the forward: one block per (ROI, output row), the
//    row's tap offsets and weights in shared memory, threads over
//    channels, so each tap's atomics are coalesced across a warp.
//
// 2. copy_to_global_kernel replaces the kernel `k` inside
//    roi_align_kernel.py::_to_hbm, a whole-buffer DMA of its input into
//    an output buffer in HBM, used there to seed the backward's zeroed
//    float32 accumulators.  Here it is a grid-stride copy with 16-byte
//    vector loads and stores when both buffers are 16-byte aligned, and
//    a byte loop for the rest.  Bound: 2 x bytes / 3.35 TB/s.

#include "roi_align_common.cuh"

// grid = (B * N ROIs, out_size rows); threads stride over channels.
template <typename T>
__global__ void roi_align_bwd_kernel(LevelTable acc, int num_levels,
                                     const float* __restrict__ rois,
                                     const T* __restrict__ g, int n_rois,
                                     int C, int out_size, int sampling,
                                     int min_level) {
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
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float* a = base + c;
    for (int px = 0; px < out_size; ++px) {
      const float gv = load_as_float(grow + (size_t)px * C + c) / count;
      for (int j = 0; j < per_bin; ++j) {
        const Taps& t = s_taps[px * per_bin + j];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (t.w[k] != 0.0f) atomicAdd(a + (size_t)t.off[k] * C, t.w[k] * gv);
        }
      }
    }
  }
}

__global__ void copy_to_global_kernel(const unsigned char* __restrict__ src,
                                      unsigned char* __restrict__ dst,
                                      size_t nbytes, size_t n16) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  const size_t tid = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const uint4* s4 = reinterpret_cast<const uint4*>(src);
  uint4* d4 = reinterpret_cast<uint4*>(dst);
  for (size_t i = tid; i < n16; i += stride) d4[i] = __ldg(s4 + i);
  for (size_t i = n16 * 16 + tid; i < nbytes; i += stride) dst[i] = src[i];
}

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
  const size_t smem = sizeof(Taps) * (size_t)out_size * sampling * sampling;
  if (blocks > 0x7fffffffLL || out_size > 65535 || smem > 48 * 1024)
    return cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (unsigned)out_size);
  int threads = channels < 256 ? ((channels + 31) / 32) * 32 : 256;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    roi_align_bwd_kernel<float><<<grid, threads, smem, st>>>(
        lv, num_levels, static_cast<const float*>(rois),
        static_cast<const float*>(g), n_rois, channels, out_size, sampling,
        min_level);
  } else {
    roi_align_bwd_kernel<__nv_bfloat16><<<grid, threads, smem, st>>>(
        lv, num_levels, static_cast<const float*>(rois),
        static_cast<const __nv_bfloat16*>(g), n_rois, channels, out_size,
        sampling, min_level);
  }
  return cudaGetLastError();
}

// Copy `nbytes` from device buffer `src` to device buffer `dst` (which
// must not overlap) on `stream`; returns the launch's error code.
cudaError_t eksml_copy_to_global(const void* src, void* dst,
                                 long long nbytes, void* stream) {
  if (nbytes < 0) return cudaErrorInvalidValue;
  if (nbytes == 0) return cudaSuccess;
  const bool aligned = ((reinterpret_cast<uintptr_t>(src) |
                         reinterpret_cast<uintptr_t>(dst)) & 15) == 0;
  const size_t n = (size_t)nbytes;
  const size_t n16 = aligned ? n / 16 : 0;
  const size_t work = n16 + (n - n16 * 16);
  const int threads = 256;
  // enough blocks to keep every SM's memory pipes busy; the grid-stride
  // loops cover the rest
  const size_t max_blocks = 132 * 16;
  size_t blocks = (work + threads - 1) / threads;
  if (blocks > max_blocks) blocks = max_blocks;
  copy_to_global_kernel<<<(unsigned)blocks, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(src),
      static_cast<unsigned char*>(dst), n, n16);
  return cudaGetLastError();
}

const char* eksml_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
