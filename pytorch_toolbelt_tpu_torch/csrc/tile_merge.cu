// Grid merge: pyramid-weighted overlap-add of a complete row-major tile grid,
// fused with the normalisation and the margin crop.
//
// Replaces the TPU kernel pytorch_toolbelt_tpu/ops/tile_merge.py
// `pallas_grid_merge` (`_pallas_grid_merge_nhwc` / `_make_gather_kernel`).
//
// What bounds it on the H100: memory bytes.  Every tile element is read once
// and every output element is written once, with a handful of integer and
// float operations per element, so the kernel sits far below the card's
// operations-per-byte ridge.  The design therefore keeps the traffic at that
// minimum: one thread per element of the cropped output, gathering from the
// at most ceil(th/sh) x ceil(tw/sw) tiles that cover it.  Neighbouring threads
// take neighbouring x, so both the tile reads and the output writes are
// coalesced along W.  No atomics and no order between blocks are needed: each
// output element is owned by one thread (the scatter form of the TPU merge
// would race on a GPU).  Sums are formed in tile order with separately
// rounded products, so the result equals the slice-add reference exactly.
// Unlike the TPU kernel, the step need not divide the tile size and no lane
// alignment is asked of the geometry.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename TIn, typename TOut>
__global__ void grid_merge_kernel(const TIn* __restrict__ tiles, const float* __restrict__ weight,
                                  TOut* __restrict__ out, float* __restrict__ norm_out, int channels,
                                  int th, int tw, int ty, int tx, int sh, int sw, int out_h, int out_w,
                                  int off_y, int off_x, int normalize, float eps) {
  const int64_t total = (int64_t)channels * out_h * out_w;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += stride) {
    const int x = (int)(i % out_w);
    const int64_t r = i / out_w;
    const int y = (int)(r % out_h);
    const int k = (int)(r / out_h);
    const int Y = y + off_y;
    const int X = x + off_x;
    // tile a covers canvas rows [a*sh, a*sh + th)
    const int a_lo = Y >= th ? (Y - th) / sh + 1 : 0;
    const int a_hi = min(Y / sh, ty - 1);
    const int b_lo = X >= tw ? (X - tw) / sw + 1 : 0;
    const int b_hi = min(X / sw, tx - 1);
    float acc = 0.0f;
    float nrm = 0.0f;
    for (int a = a_lo; a <= a_hi; ++a) {
      const int ly = Y - a * sh;
      for (int b = b_lo; b <= b_hi; ++b) {
        const int lx = X - b * sw;
        const float w = weight[ly * tw + lx];
        const int64_t t = (int64_t)a * tx + b;
        const float v = load_f32(tiles + ((t * channels + k) * th + ly) * (int64_t)tw + lx);
        acc = __fadd_rn(acc, __fmul_rn(v, w));
        nrm = __fadd_rn(nrm, w);
      }
    }
    if (normalize) {
      store_f32(out + i, acc / fmaxf(nrm, eps));
    } else {
      store_f32(out + i, acc);
      if (norm_out != nullptr && k == 0) norm_out[(int64_t)y * out_w + x] = nrm;
    }
  }
}

template <typename TIn, typename TOut>
void launch(const void* tiles, const float* weight, void* out, float* norm_out, int channels, int th,
            int tw, int ty, int tx, int sh, int sw, int out_h, int out_w, int off_y, int off_x,
            int normalize, float eps, cudaStream_t stream) {
  const int64_t total = (int64_t)channels * out_h * out_w;
  const int threads = 256;
  const int64_t want = (total + threads - 1) / threads;
  const int blocks = (int)(want < 132 * 64 ? want : 132 * 64);
  grid_merge_kernel<TIn, TOut><<<blocks, threads, 0, stream>>>(
      static_cast<const TIn*>(tiles), weight, static_cast<TOut*>(out), norm_out, channels, th, tw, ty,
      tx, sh, sw, out_h, out_w, off_y, off_x, normalize, eps);
}

}  // namespace

extern "C" int ptt_grid_merge(int device, const void* tiles, int tiles_dtype, const void* weight,
                              void* out, int out_dtype, void* norm_out, int channels, int th, int tw,
                              int ty, int tx, int sh, int sw, int out_h, int out_w, int off_y,
                              int off_x, int normalize, float eps, void* stream) {
  const ptt::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  if (channels <= 0 || th <= 0 || tw <= 0 || ty <= 0 || tx <= 0 || sh <= 0 || sw <= 0 ||
      out_h <= 0 || out_w <= 0 || off_y < 0 || off_x < 0)
    return (int)cudaErrorInvalidValue;
  const float* w = static_cast<const float*>(weight);
  float* n = static_cast<float*>(norm_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tiles_dtype == kF32 && out_dtype == kF32)
    launch<float, float>(tiles, w, out, n, channels, th, tw, ty, tx, sh, sw, out_h, out_w, off_y,
                         off_x, normalize, eps, s);
  else if (tiles_dtype == kF32 && out_dtype == kBF16)
    launch<float, __nv_bfloat16>(tiles, w, out, n, channels, th, tw, ty, tx, sh, sw, out_h, out_w,
                                 off_y, off_x, normalize, eps, s);
  else if (tiles_dtype == kBF16 && out_dtype == kF32)
    launch<__nv_bfloat16, float>(tiles, w, out, n, channels, th, tw, ty, tx, sh, sw, out_h, out_w,
                                 off_y, off_x, normalize, eps, s);
  else if (tiles_dtype == kBF16 && out_dtype == kBF16)
    launch<__nv_bfloat16, __nv_bfloat16>(tiles, w, out, n, channels, th, tw, ty, tx, sh, sw, out_h,
                                         out_w, off_y, off_x, normalize, eps, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" const char* ptt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }
