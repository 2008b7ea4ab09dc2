// 3x3 convolution, stride 1, zero ("SAME") padding, with the folded
// BatchNorm / ReLU epilogue:  y = relu?(conv3x3(x, W) * scale + bias),
// through WMMA (mma.sync) for any C_in.
//
// It was the port's first kernel for the TPU kernel
// pytorch_toolbelt_tpu/ops/conv_kernels.py `conv3x3_hcw` (`_conv_kernel`),
// which the wgmma kernel of conv3x3_wgmma.cuh now replaces on every path.
// It stays as the "wmma" route, taken only by weights packed with the
// private `_pack_wmma`: the yardstick chip_smoke.py times the wgmma kernel
// against at every UNet shape.
//
// Layout: x [B, H, W, C_in] and y [B, H, W, C_out] bf16 (PyTorch's
// channels_last storage of an NCHW tensor); W packed [9, C_in_pad, C_out_pad]
// bf16 (tap-major, zero padded, see ops/conv_kernels.py); scale and bias
// [C_out] fp32.  Accumulation is fp32.
//
// It is an implicit GEMM: M = output pixels, N = C_out, K = 9 * C_in.
// One block computes BM = 64 consecutive output pixels of
// one row for BN output channels.  For every chunk of CK = 16 input
// channels it stages the three input rows it needs (with the one-pixel halo,
// zero filled at the image border and beyond C_in) and the chunk's weights of
// all nine taps in shared memory; each of the nine taps is then a plain
// [64 x 16] x [16 x BN] product whose A operand is the staged rows shifted by
// dx, so no im2col buffer is ever written.  The products run on the tensor
// cores through WMMA m16n16k16 bf16 with fp32 accumulators; the epilogue
// applies scale, bias and ReLU in fp32 and stores bf16 with the N and W edges
// masked.  BN is 32 when C_out <= 32, else 64.  K is padded to 16 inside the
// kernel, so any C_in works.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

using namespace nvcuda;

constexpr int BM = 64;        // output pixels per block (one row segment)
constexpr int CK = 16;        // input channels per K step
constexpr int THREADS = 128;  // 4 warps, each owns 16 of the BM pixels

template <int BN>
__global__ void __launch_bounds__(THREADS)
conv3x3_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
               const float* __restrict__ scale, const float* __restrict__ bias,
               __nv_bfloat16* __restrict__ y, int H, int W, int cin, int cout, int cin_pad,
               int cout_pad, int relu) {
  constexpr int NF = BN / 16;
  __shared__ __align__(128) __nv_bfloat16 s_x[3][BM + 2][CK];
  __shared__ __align__(128) __nv_bfloat16 s_w[9][CK][BN];
  __shared__ __align__(128) float s_acc[BM][BN];

  const int row = blockIdx.x;  // b * H + oy
  const int b = row / H;
  const int oy = row - b * H;
  const int x0 = blockIdx.y * BM;
  const int n0 = blockIdx.z * BN;
  const int warp = threadIdx.x / 32;
  const bool vec = (cin % 8) == 0;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NF];
#pragma unroll
  for (int j = 0; j < NF; ++j) wmma::fill_fragment(acc[j], 0.0f);

  for (int c0 = 0; c0 < cin_pad; c0 += CK) {
    // Input rows oy-1..oy+1, pixels x0-1..x0+BM, channels c0..c0+15, 8 at a time.
    for (int idx = threadIdx.x; idx < 3 * (BM + 2) * (CK / 8); idx += THREADS) {
      const int g = idx % (CK / 8);
      const int p = (idx / (CK / 8)) % (BM + 2);
      const int r = idx / ((CK / 8) * (BM + 2));
      const int iy = oy + r - 1;
      const int ix = x0 + p - 1;
      const int c = c0 + g * 8;
      __align__(16) __nv_bfloat16 v[8];
      if (iy >= 0 && iy < H && ix >= 0 && ix < W && c < cin) {
        const __nv_bfloat16* src = x + (((int64_t)b * H + iy) * W + ix) * cin + c;
        if (vec) {
          *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(src);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = (c + e < cin) ? src[e] : __float2bfloat16(0.0f);
        }
      } else {
        *reinterpret_cast<uint4*>(v) = make_uint4(0u, 0u, 0u, 0u);
      }
      *reinterpret_cast<uint4*>(&s_x[r][p][g * 8]) = *reinterpret_cast<uint4*>(v);
    }
    // Weights of the chunk for all nine taps (packed and zero padded on the host).
    for (int idx = threadIdx.x; idx < 9 * CK * (BN / 8); idx += THREADS) {
      const int n8 = idx % (BN / 8);
      const int k = (idx / (BN / 8)) % CK;
      const int tap = idx / ((BN / 8) * CK);
      const __nv_bfloat16* src = w + ((int64_t)tap * cin_pad + c0 + k) * cout_pad + n0 + n8 * 8;
      *reinterpret_cast<uint4*>(&s_w[tap][k][n8 * 8]) = *reinterpret_cast<const uint4*>(src);
    }
    __syncthreads();

#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3;
      const int dx = tap % 3;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, &s_x[dy][warp * 16 + dx][0], CK);
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;
        wmma::load_matrix_sync(bf, &s_w[tap][0][j * 16], BN);
        wmma::mma_sync(acc[j], a, bf, acc[j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < NF; ++j)
    wmma::store_matrix_sync(&s_acc[warp * 16][j * 16], acc[j], BN, wmma::mem_row_major);
  __syncthreads();

  for (int idx = threadIdx.x; idx < BM * BN; idx += THREADS) {
    const int n = idx % BN;
    const int p = idx / BN;
    const int ox = x0 + p;
    const int co = n0 + n;
    if (ox < W && co < cout) {
      float v = s_acc[p][n] * scale[co] + bias[co];
      if (relu) v = fmaxf(v, 0.0f);
      y[(((int64_t)b * H + oy) * W + ox) * cout + co] = __float2bfloat16(v);
    }
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).
extern "C" int ptt_conv3x3_wmma_bf16(int device, const void* x, const void* w, const void* scale,
                                     const void* bias, void* y, int B, int H, int W, int cin, int cout,
                                     int cin_pad, int cout_pad, int relu, void* stream) {
  const ptt::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  const int bn = cout <= 32 ? 32 : 64;
  if (B <= 0 || H <= 0 || W <= 0 || cin <= 0 || cout <= 0 || cin_pad % CK != 0 || cin_pad < cin ||
      cout_pad % bn != 0 || cout_pad < cout || (int64_t)B * H > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(B * H), (unsigned)((W + BM - 1) / BM), (unsigned)(cout_pad / bn));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* wp = static_cast<const __nv_bfloat16*>(w);
  const auto* sp = static_cast<const float*>(scale);
  const auto* bp = static_cast<const float*>(bias);
  auto* yp = static_cast<__nv_bfloat16*>(y);
  if (bn == 32)
    conv3x3_kernel<32><<<grid, THREADS, 0, s>>>(xp, wp, sp, bp, yp, H, W, cin, cout, cin_pad,
                                                 cout_pad, relu);
  else
    conv3x3_kernel<64><<<grid, THREADS, 0, s>>>(xp, wp, sp, bp, yp, H, W, cin, cout, cin_pad,
                                                 cout_pad, relu);
  return (int)cudaGetLastError();
}
