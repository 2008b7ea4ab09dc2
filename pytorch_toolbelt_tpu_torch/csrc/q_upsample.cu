// Requantized int8 bilinear upsample (kernel Q2).
//
// The JAX package runs it as two int8 einsums against quantized interpolation
// matrices, each followed by an int32 requant (pytorch_toolbelt_tpu/zoo/
// quantized_unet.py:175 `_q_upsample`):
//   rows[o, w] = clip((sum_h mh[o, h] x[h, w] + 64) >> 7, +-127)
//   y[o, p]    = clip((sum_w mw[p, w] rows[o, w] + 64) >> 7, +-127)
// Every row of the bilinear matrices has at most two nonzero taps, so one
// output pixel needs four input pixels: the host (ops/quantized.py) hands the
// kernel each output row's and column's two taps as (i0, i1, m0, m1) and the
// kernel computes both passes for the pixel, with the int8 clip between them.
// Integer sums are exact and a zero tap adds nothing, so this equals the dense
// einsums bit for bit.  It is not the port of a Pallas kernel: torch has no
// integer einsum on CUDA, and a dense `_int_mm` would move O(H) times the bytes.
//
// Layout: x [B, H, W, C] and y [B, OH, OW, C] int8 (channels_last storage of
// NCHW tensors).  One thread computes V channels of one output pixel (16 bytes
// when C % 16 == 0, else 4 when C % 4 == 0, else 1).  Bound on the card: bytes,
// x read once and y written once over 3.35 TB/s; the four reads of a pixel's
// neighbours hit L1/L2.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ int requant7(int v) { return max(-127, min(127, (v + 64) >> 7)); }

template <int V>
struct alignas(V) Pack {
  int8_t v[V];
};

template <int V>
__global__ void __launch_bounds__(THREADS)
q_upsample_kernel(const int8_t* __restrict__ x, int8_t* __restrict__ y, const int4* __restrict__ rows,
                  const int4* __restrict__ cols, int H, int W, int C, int OH, int OW, long long total) {
  using P = Pack<V>;
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= total) return;
  const int cv = C / V;
  const int c = (int)(idx % cv) * V;
  long long rest = idx / cv;
  const int p = (int)(rest % OW);
  rest /= OW;
  const int o = (int)(rest % OH);
  const long long b = rest / OH;
  const int4 r = rows[o];  // (h0, h1, mh0, mh1)
  const int4 q = cols[p];  // (w0, w1, mw0, mw1)
  const int8_t* xb = x + b * H * W * C + c;
  const P x00 = *reinterpret_cast<const P*>(xb + ((long long)r.x * W + q.x) * C);
  const P x10 = *reinterpret_cast<const P*>(xb + ((long long)r.y * W + q.x) * C);
  const P x01 = *reinterpret_cast<const P*>(xb + ((long long)r.x * W + q.y) * C);
  const P x11 = *reinterpret_cast<const P*>(xb + ((long long)r.y * W + q.y) * C);
  P out;
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const int r0 = requant7(r.z * x00.v[e] + r.w * x10.v[e]);  // rows pass at column w0
    const int r1 = requant7(r.z * x01.v[e] + r.w * x11.v[e]);  // and at column w1
    out.v[e] = (int8_t)requant7(q.z * r0 + q.w * r1);
  }
  *reinterpret_cast<P*>(y + idx * V) = out;
}

// The route (channels per thread) a call takes: the one place the rule lives.
int channels_per_thread(int C, uintptr_t x_addr, uintptr_t y_addr) {
  if (C % 16 == 0 && x_addr % 16 == 0 && y_addr % 16 == 0) return 16;
  if (C % 4 == 0 && x_addr % 4 == 0 && y_addr % 4 == 0) return 4;
  return 1;
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success); *route_out gets the
// channels per thread (16, 4 or 1).
extern "C" int ptt_q_upsample(int device, const void* x, void* y, const void* rows, const void* cols, int B,
                              int H, int W, int C, int OH, int OW, int* route_out, void* stream) {
  const ptt::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || OH <= 0 || OW <= 0) return (int)cudaErrorInvalidValue;
  const int vec = channels_per_thread(C, (uintptr_t)x, (uintptr_t)y);
  *route_out = vec;
  const long long total = (long long)B * OH * OW * (C / vec);
  const long long blocks = (total + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const int8_t*>(x);
  auto* yp = static_cast<int8_t*>(y);
  const auto* rp = static_cast<const int4*>(rows);
  const auto* cp = static_cast<const int4*>(cols);
  if (vec == 16)
    q_upsample_kernel<16><<<(unsigned)blocks, THREADS, 0, s>>>(xp, yp, rp, cp, H, W, C, OH, OW, total);
  else if (vec == 4)
    q_upsample_kernel<4><<<(unsigned)blocks, THREADS, 0, s>>>(xp, yp, rp, cp, H, W, C, OH, OW, total);
  else
    q_upsample_kernel<1><<<(unsigned)blocks, THREADS, 0, s>>>(xp, yp, rp, cp, H, W, C, OH, OW, total);
  return (int)cudaGetLastError();
}
