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
// PyTorch version in eksml_tpu_torch/ops/roi_align.py, and any pixel of
// the assigned level is read directly.
//
// Bound on the H100 (3.35 TB/s, 67 TFLOP/s float32 without tensor
// cores): bytes.  The least traffic is every feature pixel the ROIs'
// taps touch, read once (C channels each), plus the output
// [R, out, out, C] written once; the arithmetic is ~10 flops per tap per
// channel, two orders of magnitude below the card's ratio of flops to
// bytes.  At predict shapes (1344^2 canvas, C = 256, f32) the box-head
// call (4 x 1000 ROIs, out = 7) writes 200 MB and reads at most the
// 0.6 GB of P2..P5, so its bound is about 0.1-0.25 ms.
//
// What this simple design does about it: one thread block per (ROI, output
// row), all FPN levels in one launch, threads over channels so that each
// of a sample's four taps is one coalesced read of C contiguous NHWC
// values, and every tap is a plain global load.  Splitting a ROI's rows
// over blocks gives the mask-head call (400 ROIs) enough blocks to fill
// the card, and the row's sample geometry (tap offsets and weights) is
// computed once into shared memory instead of once per channel.
// Neighbouring samples and ROIs share taps, which the L1/L2 caches absorb;
// staging a ROI's feature footprint in shared memory and 16-byte vector
// loads are later work.

#include "roi_align_common.cuh"

// grid = (B * N ROIs, out_size rows); threads stride over channels.  The
// block first writes its row's out_size * sampling^2 tap tables to shared
// memory (the geometry is the same for every channel), then each thread
// sums its channel over them.
template <typename T>
__global__ void roi_align_fwd_kernel(LevelTable lv, int num_levels,
                                     const float* __restrict__ rois,
                                     T* __restrict__ out, int n_rois, int C,
                                     int out_size, int sampling,
                                     int min_level) {
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
  const size_t smem = sizeof(Taps) * (size_t)out_size * sampling * sampling;
  if (blocks > 0x7fffffffLL || out_size > 65535 || smem > 48 * 1024)
    return cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (unsigned)out_size);
  int threads = channels < 256 ? ((channels + 31) / 32) * 32 : 256;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    roi_align_fwd_kernel<float><<<grid, threads, smem, st>>>(
        lv, num_levels, static_cast<const float*>(rois),
        static_cast<float*>(out), n_rois, channels, out_size, sampling,
        min_level);
  } else {
    roi_align_fwd_kernel<__nv_bfloat16><<<grid, threads, smem, st>>>(
        lv, num_levels, static_cast<const float*>(rois),
        static_cast<__nv_bfloat16*>(out), n_rois, channels, out_size,
        sampling, min_level);
  }
  return cudaGetLastError();
}

const char* eksml_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
