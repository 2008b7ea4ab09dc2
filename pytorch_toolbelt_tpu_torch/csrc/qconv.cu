// int8 x int8 -> int32 convolution with a fused integer epilogue (kernel Q1).
//
// The JAX package runs its int8 convolutions as XLA ops,
// `lax.conv_general_dilated(..., preferred_element_type=int32)`
// (pytorch_toolbelt_tpu/zoo/quantized_unet.py:140 `_qconv_apply` and
// zoo/quantized_encdec.py:572 `conv_acc`); torch has no int8 convolution on
// CUDA, so the port brings this kernel.  It is not the port of a Pallas kernel.
//
// Layout: x [B, H, W, C] int8 (PyTorch's channels_last storage of an NCHW
// tensor); weights packed on the host (ops/quantized.py `pack_qconv2d_weights`)
// as [groups, N_pad, K_pad] int8, K = (dy * kw + dx) * ci_pg + c, zero padded
// to a multiple of 32 per group and N padded to the block's BN; y [B, Ho, Wo,
// C_out], int8 or (mode "acc") int32.  Any kh x kw, stride, explicit pads
// (top, left; bottom and right follow from Ho and Wo) and groups.
//
// It is an implicit GEMM per group: M = output pixels, N = the group's co_pg
// output channels, K = kh * kw * ci_pg.  A block of 128 threads computes BM = 128
// pixels x BN output channels of one group.  For every 32-byte K chunk it
// gathers the [128 x 32] im2col slice of x into registers (16-byte loads when
// ci_pg and C are multiples of 16, 4-byte loads when multiples of 4, else byte
// by byte: the routes mma_v16, mma_v4, mma_v1), while the tensor cores work on
// the previous chunk from
// shared memory (two buffers); the products are
// mma.sync.m16n8k32.row.col.s32.s8.s8.s32.  The epilogue applies, in int32
// with two's-complement wraparound as XLA does:
//   mode 0 "acc":   y = acc (int32)
//   mode 1 "shift": v = relu?(acc + b); y = clip((v + rnd) >> shift, +-127)
//   mode 2 "mul":   v = relu?(acc + b); v = clamp(v, +-clamp) * mult;
//                   y = clip((v + 2^22) >> 23, +-127)
// where >> is arithmetic and a shift of 32 or more leaves the sign.
//
// Bound on the card: the larger of the bytes (x, the weights and y once) over
// 3.35 TB/s and the operations over the int8 tensor cores' 1979 TOP/s; the
// narrow 512^2 layers of the UNet are byte-bound, the wide ones operation-bound
// (chip_smoke.py phase 16 prints which, per shape).  This kernel re-reads
// each input pixel from L2 for every tap and every N block and runs mma.sync,
// which reaches a fraction of the tensor cores' rate.  The 3x3 stride-1 pad-1
// groups-1 convs (every conv of the int8 UNet, the FPN's 3x3 convs) take the
// wgmma kernel of qconv_wgmma.cu instead (routes tma_wgmma and ld_wgmma), the
// 1x1 and grouped 3x3 convs of the ResNet-family encoders that of
// qconv_gemm.cu (gemm_wgmma, grouped_wgmma); what stays here is the 7x7
// stem, the dense strided 3x3 convs and whatever is not 16-byte aligned.
// ops/quantized.py `_conv_route` picks the route and ptt_qconv2d checks it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

constexpr int BM = 128;      // output pixels per block
constexpr int BK = 32;       // K bytes per chunk: one m16n8k32 step
constexpr int THREADS = 128;  // 4 warps
constexpr int MUL_SHIFT = 23;

__device__ __forceinline__ int wrap_add(int a, int b) { return (int)((unsigned)a + (unsigned)b); }
__device__ __forceinline__ int wrap_mul(int a, int b) { return (int)((unsigned)a * (unsigned)b); }
__device__ __forceinline__ int sra(int v, int s) { return s >= 31 ? (v >> 31) : (v >> s); }
__device__ __forceinline__ int clip127(int v) { return max(-127, min(127, v)); }

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct Geometry {
  int H, W, C, Ho, Wo, kw, stride, pad_top, pad_left, ci_pg, co_pg, cout, k_total, k_pad, n_pad;
  long long M;
};

// V: bytes per global load of x (16, 4 or 1).  A thread owns ROWS rows of the
// block's 128 pixels and, in each chunk, one fixed run of RUN bytes of K.
template <int V>
struct Gather {
  static constexpr int RUN = V == 16 ? 16 : 4;           // bytes of K per row per thread
  static constexpr int PER_ROW = BK / RUN;               // threads per row
  static constexpr int ROWS = BM * PER_ROW / THREADS;    // rows per thread
  static constexpr int WORDS = RUN / 4;                  // 32-bit words per row per thread
};

template <int BN, int V>
__global__ void __launch_bounds__(THREADS)
qconv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w, const int* __restrict__ bias,
             const int* __restrict__ p0, const int* __restrict__ p1, void* __restrict__ y, Geometry g,
             int mode, int relu) {
  using G = Gather<V>;
  constexpr int WARPS_N = BN == 64 ? 2 : 1;
  constexpr int WARPS_M = 4 / WARPS_N;
  constexpr int WM = BM / WARPS_M;  // 64 or 32
  constexpr int WN = BN / WARPS_N;  // 32, 32, 16 or 8
  constexpr int MT = WM / 16;
  constexpr int NT = WN / 8;
  constexpr int A_WORDS = BK / 4;  // words per smem row

  __shared__ __align__(16) unsigned s_a[2][BM][A_WORDS];
  __shared__ __align__(16) unsigned s_b[2][BN][A_WORDS];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warp_m = warp / WARPS_N;
  const int warp_n = warp % WARPS_N;
  const int grp = blockIdx.z;
  const int n_block = blockIdx.y * BN;
  const long long m0 = (long long)blockIdx.x * BM;

  // The rows (pixels) this thread gathers, fixed for the whole K loop.
  const int run = tid % G::PER_ROW;  // which RUN-byte run of the chunk
  long long row_base[G::ROWS];       // element offset of (b, 0, 0, grp * ci_pg) in x, or -1
  int row_iy[G::ROWS], row_ix[G::ROWS];
#pragma unroll
  for (int i = 0; i < G::ROWS; ++i) {
    const long long m = m0 + tid / G::PER_ROW + i * (THREADS / G::PER_ROW);
    if (m < g.M) {
      const long long hw = (long long)g.Ho * g.Wo;
      const int b = (int)(m / hw);
      const int r = (int)(m - (long long)b * hw);
      const int oy = r / g.Wo;
      const int ox = r - oy * g.Wo;
      row_base[i] = (long long)b * g.H * g.W * g.C + (long long)grp * g.ci_pg;
      row_iy[i] = oy * g.stride - g.pad_top;
      row_ix[i] = ox * g.stride - g.pad_left;
    } else {
      row_base[i] = -1;
      row_iy[i] = row_ix[i] = 0;
    }
  }

  unsigned a_reg[G::ROWS][G::WORDS];
  uint4 b_reg = make_uint4(0u, 0u, 0u, 0u);
  const int8_t* w_grp = w + (long long)grp * g.n_pad * g.k_pad;

  auto load = [&](int kc) {
    const int k0 = kc * BK + run * G::RUN;
    if constexpr (V == 1) {
      int dy[4], dx[4], c[4];
      bool kin[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = k0 + e;
        kin[e] = k < g.k_total;
        const int tap = k / g.ci_pg;
        c[e] = k - tap * g.ci_pg;
        dy[e] = tap / g.kw;
        dx[e] = tap - dy[e] * g.kw;
      }
#pragma unroll
      for (int i = 0; i < G::ROWS; ++i) {
        unsigned word = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int iy = row_iy[i] + dy[e];
          const int ix = row_ix[i] + dx[e];
          if (kin[e] && row_base[i] >= 0 && iy >= 0 && iy < g.H && ix >= 0 && ix < g.W) {
            const unsigned v = (unsigned char)x[row_base[i] + ((long long)iy * g.W + ix) * g.C + c[e]];
            word |= v << (8 * e);
          }
        }
        a_reg[i][0] = word;
      }
    } else {
      const bool kin = k0 < g.k_total;
      const int tap = k0 / g.ci_pg;
      const int c = k0 - tap * g.ci_pg;
      const int dy = tap / g.kw;
      const int dx = tap - dy * g.kw;
#pragma unroll
      for (int i = 0; i < G::ROWS; ++i) {
        const int iy = row_iy[i] + dy;
        const int ix = row_ix[i] + dx;
        if (kin && row_base[i] >= 0 && iy >= 0 && iy < g.H && ix >= 0 && ix < g.W) {
          const int8_t* src = x + row_base[i] + ((long long)iy * g.W + ix) * g.C + c;
          if constexpr (V == 16) {
            const uint4 v = *reinterpret_cast<const uint4*>(src);
            a_reg[i][0] = v.x;
            a_reg[i][1] = v.y;
            a_reg[i][2] = v.z;
            a_reg[i][3] = v.w;
          } else {
            a_reg[i][0] = *reinterpret_cast<const unsigned*>(src);
          }
        } else {
#pragma unroll
          for (int j = 0; j < G::WORDS; ++j) a_reg[i][j] = 0u;
        }
      }
    }
    if (tid < BN * 2) {  // B: BN rows of 32 bytes, 16 bytes a thread
      const int n = tid >> 1;
      b_reg = *reinterpret_cast<const uint4*>(w_grp + (long long)(n_block + n) * g.k_pad + kc * BK + (tid & 1) * 16);
    }
  };

  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < G::ROWS; ++i) {
      const int row = tid / G::PER_ROW + i * (THREADS / G::PER_ROW);
#pragma unroll
      for (int j = 0; j < G::WORDS; ++j) s_a[buf][row][run * G::WORDS + j] = a_reg[i][j];
    }
    if (tid < BN * 2) *reinterpret_cast<uint4*>(&s_b[buf][tid >> 1][(tid & 1) * 4]) = b_reg;
  };

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int nk = g.k_pad / BK;
  const int qr = lane >> 2;  // groupID
  const int qc = lane & 3;   // thread in group
  load(0);
  store(0);
  __syncthreads();
  for (int kc = 0; kc < nk; ++kc) {
    const int buf = kc & 1;
    if (kc + 1 < nk) load(kc + 1);
    unsigned bf[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = warp_n * WN + j * 8 + qr;
      bf[j][0] = s_b[buf][n][qc];
      bf[j][1] = s_b[buf][n][4 + qc];
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int r = warp_m * WM + i * 16 + qr;
      const unsigned af[4] = {s_a[buf][r][qc], s_a[buf][r + 8][qc], s_a[buf][r][4 + qc], s_a[buf][r + 8][4 + qc]};
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_s8(acc[i][j], af, bf[j][0], bf[j][1]);
    }
    if (kc + 1 < nk) store(buf ^ 1);
    __syncthreads();
  }

  // Epilogue: c0, c1 at (row qr, cols 2 qc, 2 qc + 1), c2, c3 at row qr + 8.
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n_local = n_block + warp_n * WN + j * 8 + 2 * qc + h;
      if (n_local >= g.co_pg) continue;
      const int n = grp * g.co_pg + n_local;
      const int b_n = mode == 0 ? 0 : bias[n];
      const int q0 = mode == 0 ? 0 : p0[n];
      const int q1 = mode == 0 ? 0 : p1[n];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const long long m = m0 + warp_m * WM + i * 16 + qr + half * 8;
          if (m >= g.M) continue;
          const int a = acc[i][j][half * 2 + h];
          const long long at = m * g.cout + n;
          if (mode == 0) {
            static_cast<int*>(y)[at] = a;
            continue;
          }
          int v = wrap_add(a, b_n);
          if (relu) v = max(v, 0);
          if (mode == 1) {  // p0 = rnd, p1 = shift
            v = sra(wrap_add(v, q0), q1);
          } else {  // p0 = mult, p1 = clamp
            v = max(-q1, min(q1, v));
            v = sra(wrap_add(wrap_mul(v, q0), 1 << (MUL_SHIFT - 1)), MUL_SHIFT);
          }
          static_cast<int8_t*>(y)[at] = (int8_t)clip127(v);
        }
      }
    }
  }
}

template <int BN>
cudaError_t launch_bn(int vec, dim3 grid, cudaStream_t s, const int8_t* x, const int8_t* w, const int* bias,
                      const int* p0, const int* p1, void* y, const Geometry& g, int mode, int relu) {
  if (vec == 16)
    qconv_kernel<BN, 16><<<grid, THREADS, 0, s>>>(x, w, bias, p0, p1, y, g, mode, relu);
  else if (vec == 4)
    qconv_kernel<BN, 4><<<grid, THREADS, 0, s>>>(x, w, bias, p0, p1, y, g, mode, relu);
  else
    qconv_kernel<BN, 1><<<grid, THREADS, 0, s>>>(x, w, bias, p0, p1, y, g, mode, relu);
  return cudaGetLastError();
}

// Whether gathers of `vec` bytes (16, 4 or 1) fit the channels and x's alignment.
bool gather_fits(int vec, int C, int ci_pg, uintptr_t x_addr) {
  return vec == 1 || ((vec == 4 || vec == 16) && ci_pg % vec == 0 && C % vec == 0 && x_addr % vec == 0);
}

enum Route { MMA_V16 = 0, MMA_V4 = 1, MMA_V1 = 2, TMA_WGMMA = 3, LD_WGMMA = 4, GEMM_WGMMA = 5, GROUPED_WGMMA = 6 };

}  // namespace

// qconv_wgmma.cu: the 3x3 stride-1 wgmma routes.
int qconv2d_wgmma(int device, const void* x, const void* w, const void* bias, const void* p0, const void* p1, void* y,
                  int B, int H, int W, int cin, int cout, int nt, int mode, int relu, int tma, void* stream);
// qconv_gemm.cu: the 1x1 and grouped 3x3 wgmma routes.
int qconv2d_gemm_wgmma(int device, const void* x, const void* w, const void* bias, const void* p0, const void* p1,
                       void* y, int B, int H, int W, int cin, int Ho, int Wo, int cout, int taps, int stride,
                       int pad_top, int pad_left, int n_pad, int mode, int relu, void* stream);

// `route` is the one ops/quantized.py `_conv_route` picked (the Route codes);
// a call that does not fit it is refused.  For the mma routes w is packed as
// [groups, n_pad, k_pad] with N tile bn; for tma_wgmma and ld_wgmma (3x3,
// stride 1, pads 1, groups 1) as [NB, KC, 9, bn, 128]; for gemm_wgmma (1x1,
// groups 1, stride 1 or 2, no padding) as [KC, n_pad, 128]; for grouped_wgmma
// (3x3, C_in = C_out, groups of a width dividing 32, stride 1 or 2, pads
// (1, 1, 1, 1) or at stride 2 (0, 1, 0, 1)) as [C / 128, 9, 32, 128].
// Returns the cudaError_t of the launch (0 on success).
extern "C" int ptt_qconv2d(int device, const void* x, const void* w, const void* bias, const void* p0,
                           const void* p1, void* y, int B, int H, int W, int C, int Ho, int Wo, int cout,
                           int groups, int kh, int kw, int stride, int pad_top, int pad_left, int k_pad,
                           int n_pad, int bn, int mode, int relu, int route, void* stream) {
  if (route == TMA_WGMMA || route == LD_WGMMA) {
    if (groups != 1 || kh != 3 || kw != 3 || stride != 1 || pad_top != 1 || pad_left != 1 || Ho != H || Wo != W)
      return (int)cudaErrorInvalidValue;
    return qconv2d_wgmma(device, x, w, bias, p0, p1, y, B, H, W, C, cout, bn, mode, relu, route == TMA_WGMMA,
                         stream);
  }
  if (route == GEMM_WGMMA) {
    if (groups != 1 || kh != 1 || kw != 1 || (stride != 1 && stride != 2) || pad_top != 0 || pad_left != 0 ||
        H <= 0 || W <= 0 || Ho != (H - 1) / stride + 1 || Wo != (W - 1) / stride + 1)
      return (int)cudaErrorInvalidValue;
    return qconv2d_gemm_wgmma(device, x, w, bias, p0, p1, y, B, H, W, C, Ho, Wo, cout, 1, stride, 0, 0, n_pad, mode,
                              relu, stream);
  }
  if (route == GROUPED_WGMMA) {
    // the pads are (1, 1, 1, 1), or (0, 1, 0, 1) at stride 2: the bottom and right ones are 1
    const int ci_pg = groups > 0 ? C / groups : 0;
    if (C <= 0 || groups < 2 || C % groups != 0 || cout != C || 32 % ci_pg != 0 || kh != 3 || kw != 3 ||
        (stride != 1 && stride != 2) || pad_top != pad_left || pad_top < 0 || pad_top > 1 ||
        (stride == 1 && pad_top != 1) || H + pad_top < 2 || W + pad_left < 2 ||
        Ho != (H + pad_top - 2) / stride + 1 || Wo != (W + pad_left - 2) / stride + 1)
      return (int)cudaErrorInvalidValue;
    return qconv2d_gemm_wgmma(device, x, w, bias, p0, p1, y, B, H, W, C, Ho, Wo, cout, 9, stride, pad_top, pad_left,
                              0, mode, relu, stream);
  }
  const ptt::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  if (route != MMA_V16 && route != MMA_V4 && route != MMA_V1) return (int)cudaErrorInvalidValue;
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || Ho <= 0 || Wo <= 0 || cout <= 0 || groups <= 0 || kh <= 0 ||
      kw <= 0 || stride <= 0 || C % groups != 0 || cout % groups != 0 || k_pad % BK != 0 || mode < 0 ||
      mode > 2 || (bn != 8 && bn != 16 && bn != 32 && bn != 64) || n_pad % bn != 0)
    return (int)cudaErrorInvalidValue;
  Geometry g;
  g.H = H, g.W = W, g.C = C, g.Ho = Ho, g.Wo = Wo, g.kw = kw, g.stride = stride, g.pad_top = pad_top,
  g.pad_left = pad_left, g.ci_pg = C / groups, g.co_pg = cout / groups, g.cout = cout;
  g.k_total = kh * kw * g.ci_pg, g.k_pad = k_pad, g.n_pad = n_pad;
  g.M = (long long)B * Ho * Wo;
  if (g.k_total > k_pad || g.co_pg > n_pad || (g.M + BM - 1) / BM > 0x7fffffffLL || n_pad / bn > 65535 ||
      groups > 65535)
    return (int)cudaErrorInvalidValue;
  const int vec = route == MMA_V16 ? 16 : route == MMA_V4 ? 4 : 1;
  if (!gather_fits(vec, C, g.ci_pg, (uintptr_t)x)) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((g.M + BM - 1) / BM), (unsigned)(n_pad / bn), (unsigned)groups);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* wp = static_cast<const int8_t*>(w);
  const auto* bp = static_cast<const int*>(bias);
  const auto* q0 = static_cast<const int*>(p0);
  const auto* q1 = static_cast<const int*>(p1);
  switch (bn) {
    case 8: return (int)launch_bn<8>(vec, grid, s, xp, wp, bp, q0, q1, y, g, mode, relu);
    case 16: return (int)launch_bn<16>(vec, grid, s, xp, wp, bp, q0, q1, y, g, mode, relu);
    case 32: return (int)launch_bn<32>(vec, grid, s, xp, wp, bp, q0, q1, y, g, mode, relu);
    default: return (int)launch_bn<64>(vec, grid, s, xp, wp, bp, q0, q1, y, g, mode, relu);
  }
}
