// Scatter merge: in-place weighted overlap-add of one batch of tiles at
// arbitrary canvas coordinates, tile by tile in batch order:
//   canvas[:, y:y+th, x:x+tw] += tile * w;   norm[:, y:y+th, x:x+tw] += w
//
// Replaces the TPU kernel pytorch_toolbelt_tpu/ops/tile_merge.py
// `pallas_accumulate_tiles` (`_pallas_merge_2d` / `_merge_kernel`).
//
// The TPU kernel relies on its grid running in order: each step copies one
// canvas window into VMEM, adds one tile and copies the window back.  On the
// GPU blocks run in parallel, and the tiles of one batch overlap (at step =
// size/2 a pixel lies under up to four of them), so a tile-per-block scatter
// would race, and fp32 atomics would round in an order that changes from run
// to run.  This kernel inverts the loop instead ("owner computes"): one
// thread owns one canvas pixel of the batch's bounding box, walks the batch's
// tiles in batch order, and for the tiles that cover its pixel adds
// tile[c] * w to each channel and w to the norm.  Each canvas element it owns
// is read and written once per group of up to four covering tiles (once in
// all for the usual batches); pixels no tile covers are not touched.  Sums
// are formed in batch order with separately rounded products
// (__fadd_rn(acc, __fmul_rn(t, w)), no FMA contraction), so the result
// equals the slice-add reference bit for bit.  bf16 tiles convert to fp32
// exactly and are read as they are.
//
// What bounds it on the H100: memory bytes.  It reads every tile element
// once and reads and writes (C + 1) fp32 words per covered canvas pixel, with
// a few operations per element.  Neighbouring threads take neighbouring x,
// so the canvas and the tile rows are read and written in coalesced 128-byte
// lines.  The batch's coordinates sit in shared memory.  Offsets and the
// canvas size are 64-bit; no alignment is asked of the geometry.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

enum DType { kF32 = 0, kBF16 = 1 };

constexpr int kMaxTiles = 1024;  // tiles per launch; the wrapper splits larger batches
constexpr int kSlots = 4;        // covering tiles gathered before one pass over the channels
constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// Add the `count` gathered tiles, in their batch order, to every channel of
// one canvas pixel and to its norm.
template <typename TIn>
__device__ __forceinline__ void flush(float* __restrict__ canvas, float* __restrict__ norm,
                                      const TIn* __restrict__ tiles, int64_t pixel, int64_t plane,
                                      int64_t tile_plane, int channels, const float (&w)[kSlots],
                                      const int64_t (&off)[kSlots], int count) {
#pragma unroll 4
  for (int c = 0; c < channels; ++c) {
    float* dst = canvas + (int64_t)c * plane + pixel;
    float acc = *dst;
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      if (k < count) acc = __fadd_rn(acc, __fmul_rn(load_f32(tiles + off[k] + (int64_t)c * tile_plane), w[k]));
    }
    *dst = acc;
  }
  float nrm = norm[pixel];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    if (k < count) nrm = __fadd_rn(nrm, w[k]);
  }
  norm[pixel] = nrm;
}

template <typename TIn>
__global__ void __launch_bounds__(kBlockX * kBlockY)
scatter_merge_kernel(float* __restrict__ canvas, float* __restrict__ norm, const TIn* __restrict__ tiles,
                     const float* __restrict__ weight, const long long* __restrict__ coords, int n_tiles,
                     int channels, long long width, long long plane, int th, int tw, long long box_y0,
                     long long box_x0, long long box_h, long long box_w) {
  __shared__ long long s_y[kMaxTiles];
  __shared__ long long s_x[kMaxTiles];
  for (int i = threadIdx.y * kBlockX + threadIdx.x; i < n_tiles; i += kBlockX * kBlockY) {
    s_y[i] = coords[2 * i];
    s_x[i] = coords[2 * i + 1];
  }
  __syncthreads();

  const int64_t x = box_x0 + (int64_t)blockIdx.x * kBlockX + threadIdx.x;
  if (x >= box_x0 + box_w) return;
  const int64_t tile_plane = (int64_t)th * tw;
  const int64_t tile_stride = (int64_t)channels * tile_plane;
  for (int64_t y = box_y0 + (int64_t)blockIdx.y * kBlockY + threadIdx.y; y < box_y0 + box_h;
       y += (int64_t)gridDim.y * kBlockY) {
    const int64_t pixel = y * width + x;
    float w[kSlots];
    int64_t off[kSlots];
    int count = 0;
    for (int b = 0; b < n_tiles; ++b) {
      const int64_t ly = y - s_y[b];
      const int64_t lx = x - s_x[b];
      if (ly < 0 || ly >= th || lx < 0 || lx >= tw) continue;
      const int64_t local = ly * tw + lx;
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {  // static indices keep the slots in registers
        if (k == count) {
          w[k] = weight[local];
          off[k] = (int64_t)b * tile_stride + local;
        }
      }
      if (++count == kSlots) {
        flush(canvas, norm, tiles, pixel, plane, tile_plane, channels, w, off, count);
        count = 0;
      }
    }
    if (count > 0) flush(canvas, norm, tiles, pixel, plane, tile_plane, channels, w, off, count);
  }
}

}  // namespace

extern "C" int ptt_scatter_merge(int device, void* canvas, void* norm, const void* tiles, int tiles_dtype,
                                 const void* weight, const void* coords, int n_tiles, int channels,
                                 long long height, long long width, int th, int tw, long long box_y0,
                                 long long box_x0, long long box_h, long long box_w, void* stream) {
  const ptt::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  if (n_tiles <= 0 || n_tiles > kMaxTiles || channels <= 0 || th <= 0 || tw <= 0 || height <= 0 ||
      width <= 0 || box_y0 < 0 || box_x0 < 0 || box_h <= 0 || box_w <= 0 || box_y0 + box_h > height ||
      box_x0 + box_w > width)
    return (int)cudaErrorInvalidValue;
  const long long blocks_x = (box_w + kBlockX - 1) / kBlockX;
  const long long want_y = (box_h + kBlockY - 1) / kBlockY;
  if (blocks_x > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks_x, (unsigned)(want_y < 65535 ? want_y : 65535));
  const dim3 block(kBlockX, kBlockY);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* c = static_cast<float*>(canvas);
  float* n = static_cast<float*>(norm);
  const float* w = static_cast<const float*>(weight);
  const long long* yx = static_cast<const long long*>(coords);
  const long long plane = height * width;
  if (tiles_dtype == kF32)
    scatter_merge_kernel<float><<<grid, block, 0, s>>>(c, n, static_cast<const float*>(tiles), w, yx, n_tiles,
                                                       channels, width, plane, th, tw, box_y0, box_x0, box_h,
                                                       box_w);
  else if (tiles_dtype == kBF16)
    scatter_merge_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(c, n, static_cast<const __nv_bfloat16*>(tiles),
                                                               w, yx, n_tiles, channels, width, plane, th, tw,
                                                               box_y0, box_x0, box_h, box_w);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
