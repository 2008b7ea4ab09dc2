// Requantized int8 bilinear upsample (kernel Q2), alone or as the int8 UNet's
// whole decoder input: the upsample and the skip it is joined to, in one launch.
//
// What it replaces.  No Pallas kernel: the JAX package runs the upsample as
// two int8 einsums against quantized interpolation matrices, each followed by
// an int32 requant (pytorch_toolbelt_tpu/zoo/quantized_unet.py:175
// `_q_upsample`), and its decoder joins the result to the skip with
// `jnp.concatenate` (:354-355):
//   rows[o, w] = clip((sum_h mh[o, h] x[h, w] + 64) >> 7, +-127)
//   y[o, p]    = clip((sum_w mw[p, w] rows[o, w] + 64) >> 7, +-127)
//   out        = concatenate([y, skip], channels)
// Every row of the bilinear matrices has at most two nonzero taps: the host
// (ops/quantized.py `upsample_taps`) hands the kernel each output row's and
// column's two taps as (i0, i1, m0, m1).  Integer sums are exact and a zero
// tap adds nothing, so this equals the dense einsums bit for bit.
//
// What bounded the first design (one thread per output pixel and 16
// channels; kept below as the per-pixel route, `q_upsample_kernel`, for the
// channel counts that are not multiples of 16): instruction issue, not bytes.
// Each thread split a 64-bit flat index with three 64-bit divisions, ran the
// row pass twice per output pixel (each rows[o, w] was recomputed by every
// output column whose taps reach w) and worked one 32-bit lane per byte:
// some 20-35 integer instructions per output byte, 23% of the byte bound on
// the H100.  The decoder then copied its output and the skip once more with
// torch.cat.
//
// The banded design (`q_upsample_band_kernel`).  A block owns a band of R
// output rows by a strip of P output columns of one sample, every channel:
//   * warp 0 reads the band's and the strip's taps once into shared memory and
//     fetches the input rows and columns they reach, one bulk copy
//     (cp.async.bulk) per input row, behind an mbarrier; meanwhile every warp
//     copies the tile's skip channels to their place in the output;
//   * the row pass runs once per (o, w, c) into an int8 tile in shared memory,
//     clipped to +-127 as the JAX package's intermediate is;
//   * the column pass reads that tile and stores 16 bytes per thread.
// Offsets inside a tile are 32-bit, from blockIdx and a walk that steps
// without dividing; a tile's base offsets are 64-bit (the decoder input at
// the main path's batch passes 2^31 bytes).  Four channels at a time: one
// __byte_perm interleaves the two taps' bytes, __dp2a_lo/hi compute
// 2 (m0 a + m1 b + 64) with doubled taps, cvt.pack.sat.s16 saturates two of
// them into 16-bit lanes, a 16x2 max floors them at -127 * 256 and one
// __byte_perm takes the high bytes, which are (m0 a + m1 b + 64) >> 7
// clipped to +-127, exactly: 11 instructions for 4 bytes of one pass.  Where
// C % 32 == 0 (every call of the main paths) no 32-byte sector of the output
// holds both upsampled and skip channels, so each is written whole by one
// warp's stores.
//
// Bound: bytes.  x read once and the output written once, plus the skip read
// once in the decoder-input form, over 3.35 TB/s.
//
// Probe switches (a copy built by probes/q2_probe.py, never by ops/_build.py):
// PTT_Q2_PIXEL16 adds the first design's 16-channel per-pixel instance as
// route 3; PTT_Q2_NO_ARITH replaces every lerp by an XOR of its operands.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "device_guard.cuh"
#include "tma.cuh"

namespace {

constexpr int THREADS = 256;
// ptt_q_upsample's route codes, in the order of ops/quantized.py _UPSAMPLE_ROUTES
constexpr int ROUTE_BANDED = 0, ROUTE_V4 = 1, ROUTE_V1 = 2, ROUTE_V16 = 3;
constexpr int MAX_SMEM = 232448;  // dynamic shared memory a block may hold on the H100
constexpr int SKIP_LOADS = 4;     // skip loads a thread of the banded kernel keeps in flight

// ---------------------------------------------------------------------------
// The per-pixel route: one thread computes (or, past channel C, copies from
// the skip) V channels of one output pixel from its four input pixels.
// ---------------------------------------------------------------------------

__device__ __forceinline__ int requant7(int v) { return max(-127, min(127, (v + 64) >> 7)); }

template <int V>
struct alignas(V) Pack {
  int8_t v[V];
};

template <int V>
__global__ void __launch_bounds__(THREADS)
q_upsample_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ skip, int8_t* __restrict__ y,
                  const int4* __restrict__ rows, const int4* __restrict__ cols, int H, int W, int C, int Cs,
                  int OH, int OW, long long total) {
  using P = Pack<V>;
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= total) return;
  const int cv = (C + Cs) / V;
  const int c = (int)(idx % cv) * V;
  const long long pix = idx / cv;  // (b * OH + o) * OW + p
  P out;
  if (c >= C) {
    out = *reinterpret_cast<const P*>(skip + pix * Cs + (c - C));
  } else {
    const int p = (int)(pix % OW);
    const long long rest = pix / OW;
    const int o = (int)(rest % OH);
    const long long b = rest / OH;
    const int4 r = rows[o];  // (h0, h1, mh0, mh1)
    const int4 q = cols[p];  // (w0, w1, mw0, mw1)
    const int8_t* xb = x + b * H * W * C + c;
    const P x00 = *reinterpret_cast<const P*>(xb + ((long long)r.x * W + q.x) * C);
    const P x10 = *reinterpret_cast<const P*>(xb + ((long long)r.y * W + q.x) * C);
    const P x01 = *reinterpret_cast<const P*>(xb + ((long long)r.x * W + q.y) * C);
    const P x11 = *reinterpret_cast<const P*>(xb + ((long long)r.y * W + q.y) * C);
#pragma unroll
    for (int e = 0; e < V; ++e) {
#ifdef PTT_Q2_NO_ARITH
      out.v[e] = x00.v[e] ^ x10.v[e] ^ x01.v[e] ^ x11.v[e] ^ (int8_t)(r.z ^ q.w);
#else
      const int r0 = requant7(r.z * x00.v[e] + r.w * x10.v[e]);  // rows pass at column w0
      const int r1 = requant7(r.z * x01.v[e] + r.w * x11.v[e]);  // and at column w1
      out.v[e] = (int8_t)requant7(q.z * r0 + q.w * r1);
#endif
    }
  }
  *reinterpret_cast<P*>(y + idx * V) = out;
}

// ---------------------------------------------------------------------------
// The banded route
// ---------------------------------------------------------------------------

// (2 m0, 2 m1) as the two 16-bit halves __dp2a takes
__host__ __device__ __forceinline__ uint32_t doubled_taps(int m0, int m1) {
  return ((uint32_t)(2 * m0) & 0xffffu) | ((uint32_t)(2 * m1) << 16);
}

// clip((m0 a + m1 b + 64) >> 7, +-127) in each of the four int8 lanes of a
// and b, m2 = doubled_taps(m0, m1).  v = 2 (m0 a + m1 b + 64) fits 17 bits;
// saturated to 16 and floored at -127 * 256, its high byte is floor(v / 256)
// clipped to [-127, 127], which is the requant.
__device__ __forceinline__ uint32_t lerp4(uint32_t a, uint32_t b, uint32_t m2) {
#ifdef PTT_Q2_NO_ARITH
  return a ^ b ^ m2;
#else
  const int lo = (int)__byte_perm(a, b, 0x5140);  // (a0, b0, a1, b1)
  const int hi = (int)__byte_perm(a, b, 0x7362);  // (a2, b2, a3, b3)
  const int v0 = __dp2a_lo((int)m2, lo, 128), v1 = __dp2a_hi((int)m2, lo, 128);
  const int v2 = __dp2a_lo((int)m2, hi, 128), v3 = __dp2a_hi((int)m2, hi, 128);
  uint32_t p01, p23;  // (v0, v1) and (v2, v3), saturated to int16, low lane first
  asm("cvt.pack.sat.s16.s32 %0, %1, %2;" : "=r"(p01) : "r"(v1), "r"(v0));
  asm("cvt.pack.sat.s16.s32 %0, %1, %2;" : "=r"(p23) : "r"(v3), "r"(v2));
  asm("max.s16x2 %0, %0, %1;" : "+r"(p01) : "r"(0x81008100u));  // -127 * 256 in both lanes
  asm("max.s16x2 %0, %0, %1;" : "+r"(p23) : "r"(0x81008100u));
  return __byte_perm(p01, p23, 0x7531);  // the high byte of each lane
#endif
}

__device__ __forceinline__ uint4 lerp16(const uint4 a, const uint4 b, uint32_t m2) {
  return make_uint4(lerp4(a.x, b.x, m2), lerp4(a.y, b.y, m2), lerp4(a.z, b.z, m2), lerp4(a.w, b.w, m2));
}

// floor(n / d) for 0 <= n < 2^22, inv = 1.0f / d: (n + 1/2) / d lies at least
// 1/(2d) from an integer, more than the two float roundings can move it.
__device__ __forceinline__ int div_small(int n, float inv) { return (int)(((float)n + 0.5f) * inv); }

// A thread's walk over the flat index j = start, start + THREADS, ... of a
// [rows][cols][chunks] grid as (r, c, k), stepped without dividing; `step`
// is THREADS in the same terms (made on the host).
struct Walk {
  int r, c, k;
  __device__ __forceinline__ Walk(int j, int chunks, float inv_cols, float inv_chunks, int cols) {
    const int pix = div_small(j, inv_chunks);
    k = j - pix * chunks;
    r = div_small(pix, inv_cols);
    c = pix - r * cols;
  }
  __device__ __forceinline__ void next(const int3 step, int cols, int chunks) {
    k += step.z;
    c += step.y;
    r += step.x;
    if (k >= chunks) {
      k -= chunks;
      ++c;
    }
    if (c >= cols) {
      c -= cols;
      ++r;
    }
  }
};

struct Band {
  const int8_t* x;
  const int8_t* skip;
  int8_t* y;
  const int4* rows;
  const int4* cols;
  int B, H, W, C, Cs, OH, OW;
  int R, P;    // output rows and columns of a tile
  int RW, WW;  // the most input rows and columns one tile's taps reach
  // THREADS as a step of the row pass ([R][WW][C/16]), the column pass
  // ([R][P][C/16]) and the skip copy ([R][P][Cs/16])
  int3 step_rows, step_cols, step_skip;
  float inv_ww, inv_p, inv_cv, inv_sv;
};

// Shared memory: the mbarrier, the tile's row taps [R] and column taps [P]
// (int4: the byte offsets of the two taps in the tile they read, the doubled
// taps), the input tile [RW][WW][C] and the row-pass tile [R][WW][C].
__host__ __device__ __forceinline__ long long band_smem(int C, int R, int P, int RW, int WW) {
  return 16 + 16LL * (R + P) + (long long)(RW + R) * WW * C;
}

__device__ __forceinline__ uint4 lds128(const unsigned char* p) { return *reinterpret_cast<const uint4*>(p); }

// A bulk copy of contiguous bytes into shared memory, counted on the mbarrier.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(dst),
               "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}

__global__ void __launch_bounds__(THREADS) q_upsample_band_kernel(const Band p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t bar = smem_addr(smem);
  int4* row_taps = reinterpret_cast<int4*>(smem + 16);
  int4* col_taps = row_taps + p.R;
  const int cv = p.C >> 4, sv = p.Cs >> 4, ct = p.C + p.Cs;
  const int xrow = p.WW * p.C;  // bytes per row of either tile
  unsigned char* xs = reinterpret_cast<unsigned char*>(col_taps + p.P);
  unsigned char* rs = xs + p.RW * xrow;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int o0 = blockIdx.y * p.R, q0 = blockIdx.x * p.P;
  const int nr = min(p.R, p.OH - o0), nq = min(p.P, p.OW - q0);
  const int yrow = p.OW * ct, srow = p.OW * p.Cs;  // bytes per output and skip row (host: R rows < 2^31)

  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  uint32_t parity = 0;
  for (int b = blockIdx.z; b < p.B; b += gridDim.z, parity ^= 1) {
    const size_t first = ((size_t)b * p.OH + o0) * p.OW + q0;  // the tile's first output pixel
    int8_t* yb = p.y + first * ct;
    if (warp == 0) {
      // the input window of the tile's taps, then the taps as offsets into the tiles
      int hlo = INT_MAX, hhi = INT_MIN, wlo = INT_MAX, whi = INT_MIN;
      for (int i = lane; i < nr; i += 32) {
        const int4 t = p.rows[o0 + i];
        hlo = min(hlo, min(t.x, t.y));
        hhi = max(hhi, max(t.x, t.y));
      }
      for (int i = lane; i < nq; i += 32) {
        const int4 t = p.cols[q0 + i];
        wlo = min(wlo, min(t.x, t.y));
        whi = max(whi, max(t.x, t.y));
      }
      hlo = __reduce_min_sync(~0u, hlo);
      hhi = __reduce_max_sync(~0u, hhi);
      wlo = __reduce_min_sync(~0u, wlo);
      whi = __reduce_max_sync(~0u, whi);
      // rows and columns past the map's edge read the window's first input and are never stored
      for (int i = lane; i < p.R; i += 32) {
        const int4 t = i < nr ? p.rows[o0 + i] : make_int4(hlo, hlo, 0, 0);
        row_taps[i] = make_int4((t.x - hlo) * xrow, (t.y - hlo) * xrow, (int)doubled_taps(t.z, t.w), 0);
      }
      for (int i = lane; i < p.P; i += 32) {
        const int4 t = i < nq ? p.cols[q0 + i] : make_int4(wlo, wlo, 0, 0);
        col_taps[i] = make_int4((t.x - wlo) * p.C, (t.y - wlo) * p.C, (int)doubled_taps(t.z, t.w), 0);
      }
      const int hn = hhi - hlo + 1, wbytes = (whi - wlo + 1) * p.C;
      if (hn > p.RW || whi - wlo + 1 > p.WW) __trap();  // the host sized the tiles from the same taps
      if (lane == 0) mbar_expect_tx(bar, (uint32_t)(hn * wbytes));
      __syncwarp();
      const int8_t* src = p.x + (((size_t)b * p.H + hlo) * p.W + wlo) * p.C;
      for (int i = lane; i < hn; i += 32)
        bulk_load(smem_addr(xs + i * xrow), src + (size_t)i * p.W * p.C, (uint32_t)wbytes, bar);
    }
    if (sv) {
      // the skip's channels of the tile's pixels, while the input arrives: SKIP_LOADS 16-byte loads in flight
      // per thread, then their stores (a tile of the main paths is 4 per thread)
      const int8_t* sb = p.skip + first * p.Cs;
      for (Walk w(threadIdx.x, sv, p.inv_p, p.inv_sv, p.P); w.r < p.R;) {
        int4 v[SKIP_LOADS];
        int dst[SKIP_LOADS];
#pragma unroll
        for (int u = 0; u < SKIP_LOADS; ++u) {
          dst[u] = -1;
          v[u] = make_int4(0, 0, 0, 0);
          if (w.r < nr && w.c < nq) {
            v[u] = __ldcs(reinterpret_cast<const int4*>(sb + w.r * srow + w.c * p.Cs + 16 * w.k));
            dst[u] = w.r * yrow + w.c * ct + p.C + 16 * w.k;
          }
          w.next(p.step_skip, p.P, sv);
        }
#pragma unroll
        for (int u = 0; u < SKIP_LOADS; ++u)
          if (dst[u] >= 0) *reinterpret_cast<int4*>(yb + dst[u]) = v[u];
      }
    }
    __syncthreads();  // the taps
    mbar_wait(bar, parity);
    // row pass, once per (o, w, c): rs[r][w][c] = clip((mh0 x[h0, w, c] + mh1 x[h1, w, c] + 64) >> 7)
    for (Walk w(threadIdx.x, cv, p.inv_ww, p.inv_cv, p.WW); w.r < p.R; w.next(p.step_rows, p.WW, cv)) {
      const int4 t = row_taps[w.r];
      const int off = w.c * p.C + 16 * w.k;
      const uint4 v = lerp16(lds128(xs + t.x + off), lds128(xs + t.y + off), (uint32_t)t.z);
      *reinterpret_cast<uint4*>(rs + w.r * xrow + off) = v;
    }
    __syncthreads();
    // column pass: y[o, p, c] = clip((mw0 rs[o, w0, c] + mw1 rs[o, w1, c] + 64) >> 7)
    for (Walk w(threadIdx.x, cv, p.inv_p, p.inv_cv, p.P); w.r < p.R; w.next(p.step_cols, p.P, cv)) {
      const int4 t = col_taps[w.c];
      const unsigned char* row = rs + w.r * xrow + 16 * w.k;
      const uint4 v = lerp16(lds128(row + t.x), lds128(row + t.y), (uint32_t)t.z);
      if (w.r < nr && w.c < nq) *reinterpret_cast<uint4*>(yb + w.r * yrow + w.c * ct + 16 * w.k) = v;
    }
    __syncthreads();  // before the next sample's taps and input overwrite the tiles
  }
}

// THREADS as a step over [*][cols][chunks]: (rows, cols, chunks)
int3 walk_step(int cols, int chunks) {
  const int pix = THREADS / chunks;
  return make_int3(pix / cols, pix % cols, THREADS % chunks);
}

float inverse(int d) { return d > 0 ? 1.0f / (float)d : 0.0f; }

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  skip is null and Cs
// 0 for the upsample alone; else the output holds each pixel's C upsampled
// channels, then its Cs skip channels.  route: ROUTE_*; tile: (R, P, RW, WW)
// of the banded route (ops/quantized.py _band_tile), unread by the others.
extern "C" int ptt_q_upsample(int device, const void* x, const void* skip, void* y, const void* rows,
                              const void* cols, int B, int H, int W, int C, int Cs, int OH, int OW, int route,
                              const int* tile, void* stream) {
  const ptt::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || Cs < 0 || OH <= 0 || OW <= 0 || (Cs > 0 && skip == nullptr))
    return (int)cudaErrorInvalidValue;
  const uintptr_t addr = (uintptr_t)x | (uintptr_t)y | (Cs > 0 ? (uintptr_t)skip : 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* sp = static_cast<const int8_t*>(skip);
  auto* yp = static_cast<int8_t*>(y);
  const auto* rp = static_cast<const int4*>(rows);
  const auto* cp = static_cast<const int4*>(cols);
  if (route == ROUTE_BANDED) {
    const int R = tile[0], P = tile[1], RW = tile[2], WW = tile[3];
    if (C % 16 || Cs % 16 || addr % 16 || R <= 0 || P <= 0 || RW <= 0 || WW <= 0) return (int)cudaErrorInvalidValue;
    const long long smem = band_smem(C, R, P, RW, WW);
    if (smem > MAX_SMEM || (long long)R * OW * (C + Cs) > INT_MAX || (long long)W * C > INT_MAX)
      return (int)cudaErrorInvalidValue;
    Band p{xp, sp, yp, rp, cp, B, H, W, C, Cs, OH, OW, R, P, RW, WW,
           walk_step(WW, C / 16), walk_step(P, C / 16), Cs > 0 ? walk_step(P, Cs / 16) : make_int3(0, 0, 0),
           inverse(WW), inverse(P), inverse(C / 16), inverse(Cs / 16)};
    if (smem > 48 * 1024) {
      const cudaError_t err =
          cudaFuncSetAttribute(q_upsample_band_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    const dim3 grid((OW + P - 1) / P, (OH + R - 1) / R, B < 65535 ? B : 65535);
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;
    q_upsample_band_kernel<<<grid, THREADS, (size_t)smem, s>>>(p);
    return (int)cudaGetLastError();
  }
  int vec = route == ROUTE_V4 ? 4 : route == ROUTE_V1 ? 1 : 0;
#ifdef PTT_Q2_PIXEL16
  if (route == ROUTE_V16) vec = 16;
#endif
  if (vec == 0 || C % vec || Cs % vec || addr % vec) return (int)cudaErrorInvalidValue;
  const long long total = (long long)B * OH * OW * ((C + Cs) / vec);
  const long long blocks = (total + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (vec == 4)
    q_upsample_kernel<4><<<(unsigned)blocks, THREADS, 0, s>>>(xp, sp, yp, rp, cp, H, W, C, Cs, OH, OW, total);
  else if (vec == 1)
    q_upsample_kernel<1><<<(unsigned)blocks, THREADS, 0, s>>>(xp, sp, yp, rp, cp, H, W, C, Cs, OH, OW, total);
#ifdef PTT_Q2_PIXEL16
  else
    q_upsample_kernel<16><<<(unsigned)blocks, THREADS, 0, s>>>(xp, sp, yp, rp, cp, H, W, C, Cs, OH, OW, total);
#endif
  return (int)cudaGetLastError();
}
