// int8 1x1 convolutions (stride 1 or 2, groups 1) and grouped 3x3
// convolutions (stride 1 or 2, as many input as output channels per group,
// a group width dividing 32, C a multiple of 128), with Q1's integer epilogue,
// as wgmma implicit GEMMs for Hopper (sm_90a): the `gemm_wgmma` and
// `grouped_wgmma` routes of ops/quantized.py `qconv2d` (kernel Q1).  Its other
// routes: qconv_wgmma.cu (3x3 stride-1 groups-1 convs) and qconv.cu (the rest).
//
// Like them it replaces no Pallas kernel: the JAX package runs these convs as
// XLA ops (pytorch_toolbelt_tpu/zoo/quantized_encdec.py:572 `conv_acc`, the
// ResNet-family encoders' bottlenecks, projections and FPN laterals), and
// torch has no int8 convolution on CUDA.  It computes what qconv.cu computes,
// bit for bit, in int32 with two's-complement wraparound:
//   mode 0 "acc":   y = acc (int32)
//   mode 1 "shift": v = relu?(acc + b); y = clip((v + rnd) >> shift, +-127)
//   mode 2 "mul":   v = relu?(acc + b); v = clamp(v, +-clamp) * mult;
//                   y = clip((v + 2^22) >> 23, +-127)
//
// Layout: x [B, H, W, C_in] and y [B, Ho, Wo, C_out] (int32 for "acc"), the
// channels_last storage of NCHW tensors.  Weights packed by ops/quantized.py:
//   1x1 (`_pack_gemm`): [KC, N_pad, 128] int8, K chunk (qconv_wgmma.cu's
//     chunks of C_in), output channel (N_pad a multiple of 128, so a slab of
//     either N tile is contiguous), the chunk's input channels in a 128-byte
//     row with the 128-byte swizzle;
//   grouped (`_pack_banded`): [C / 128, 9, 32, 128] int8, 128-channel block,
//     tap, output channel n of a 32-channel band, then the four bands'
//     32-byte rows side by side: bytes 32 k + c hold band k's weight from its
//     input channel c to its output channel n, zero where c and n lie in other
//     groups (a band of 32 / width groups is one block-diagonal 32 x 32 tile).
//
// What bounds it on the H100 (chip_smoke.py phase 16 reckons each call: x,
// the weights and y once over 3.35 TB/s; 2 * C_in/groups * C_out operations
// per output pixel and tap over 1979 TOP/s).  A 1x1 conv moves C_in + C_out
// bytes and does 2 C_in C_out operations per pixel: SEResNeXt50's stage-1 and
// stage-2 convs (64..512 channels, e.g. 256 -> 128: 171 per byte) are bound by
// bytes, the stage-4 expand (1024 -> 2048: 1365 per byte) by operations.  The
// grouped convs do 2 * 9 * width * C operations on 2 C bytes: bound by bytes.
//
// Design: qconv_wgmma.cu's, for other shapes.  A block is persistent and
// walks output tiles of P = 128 or 256 pixels x NT = 64 or 128 channels (the
// requant compiled per mode, each thread's per-channel operands serving 2 MW
// rows); warpgroup 2 is the
// producer, 0 and 1 the consumers, each owning MW m64 row tiles.  A tile's
// pixels are a box of TR rows x TC columns (TC a power of two); for a 1x1
// stride-1 conv the input is one [B * H * W, C_in] matrix and a tile P
// consecutive pixels of it.  For each K chunk the producer TMA-loads the box's
// input into a ring stage (zero fill past the image and past C_in) and
// bulk-copies the weight slabs into a ring of slots; the consumers form A with
// ldmatrix.x4 at each row's staged pixel, decoding the swizzle in the address,
// and B by descriptor: wgmma.mma_async.m64nNk32.s32.s8.s8.
// - 1x1 (`gemm_wgmma`): one tap; N = C_out in tiles of 128 or 64, K = C_in
//   in chunks of 128 (a 64 / 32 tail).  Stride 2 loads every second pixel of
//   each second row with a tensor map whose traversal strides on W and H are
//   2, so the staged box is dense and no byte of the skipped pixels moves.
//   Tiles shrink (MW 2 -> 1, then NT 128 -> 64) until they number at least
//   the SMs, so the small maps of stage 4 fill the card.
// - grouped 3x3 (`grouped_wgmma`): a tile's N block is 128 channels, four
//   bands of 32; its one K chunk is the same 128 input channels, and the
//   halo box of the tile ((TR - 1) s + 3 rows x (TC - 1) s + 3 columns,
//   starting at s * (first output pixel) - pad) is loaded once by TMA, its
//   zero fill the padding.  Per tap, band k's A is the chunk's k32 step k at
//   the tap-shifted pixel (s * row + dy, s * column + dx) and its B the
//   slab's 32-byte column k: one m64n32k32 wgmma per band into the band's 16
//   accumulator registers.  So each byte of x moves from device memory once
//   per tile (plus the halo's L2 reads), and the products on zeros are only
//   those inside a band: 32 / width times the useful ones, which keeps the
//   convs bound by bytes (288 operations per byte at width 4).
// The epilogue is qconv_wgmma.cu's: int8 output with C_out % 16 == 0 goes
// through a swizzled shared-memory tile and TMA stores, the rest through
// register stores; the requant is compiled per mode and ReLU.
//
// What holds it back (chip_smoke.py phase 16 and PERF.md have the times): on
// the byte-bound layers the integer requant, which runs after the tile's
// main loop on the same warps (dropping an N = 256 tile whose requant read
// its mode at run time cut the 1x1 convs' device time by a tenth); the 1x1
// tile's A and B come from L2 once per N tile and per M tile (no multicast
// across a cluster); a 1x1 chunk is one wgmma group, so the tensor cores
// idle while the consumers wait for it before releasing its slot.  At batch
// 1 a call's kernel (~16 us) is shorter than its host cost (32-55 us on the
// H100 machine, most of it the Python wrapper).

#include <cuda.h>  // CUtensorMap and its enums; tma.cuh fetches the driver entry point at run time
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "device_guard.cuh"
#include "qconv_wgmma.cuh"
#include "tma.cuh"

namespace {

constexpr int BAND = 32;  // channels of a band of the grouped route: one k32 step

struct Params {
  const int8_t* w;
  const int* bias;
  const int* p0;  // "shift": rnd; "mul": mult
  const int* p1;  // "shift": shift; "mul": clamp
  void* y;
  int Ho, Wo, cout, mode, relu;  // y as the kernel indexes it: [B, Ho, Wo, C_out] ([1, 1, M, C_out] flat)
  Chunks ch;                     // the K chunks of a 1x1 conv (the grouped route: one per tile)
  int nb_count, tiles_x, tiles_y, tiles;
  int tc_log2, tr;          // a tile: 2^tc_log2 columns x tr rows of output pixels
  int ss, hc;               // the staged box: its pixel stride between output pixels, its pixels per row
  int in_step, pad_top, pad_left;  // a tile's box starts at in_step * (its first output pixel) - pad
  int halo_stages, w_slots, resident, tma_store;
  uint32_t halo_stage_bytes, box_pixels, out_bytes;
  long long w_nb, w_kc, w_tap;  // bytes between the weight slabs of N blocks, K chunks and taps
};

// One 1x1 K chunk of NK k32 steps against its [NT, 128] weight slab.  Step
// kk + 1's A fragments are loaded while step kk's wgmmas run.
template <int NT, int MW, int NK>
__device__ __forceinline__ void mma_gemm(int (&acc)[MW][NT / 2], const Params& p, uint32_t halo, uint32_t wbase,
                                         uint32_t w_full, uint32_t w_empty, int kc, uint32_t& wn,
                                         const int (&qa)[MW], int a_half, int lane) {
  constexpr uint32_t WB = NT * CK;
  const int ws = p.resident ? kc : wn % p.w_slots;
  mbar_wait(w_full + 8 * ws, p.resident ? 0 : (wn / p.w_slots) & 1);
  const uint64_t desc = desc_sw128(wbase + ws * WB);
  uint32_t a[2][MW][4];
#pragma unroll
  for (int i = 0; i < MW; ++i) ldmatrix_x4(a[0][i], halo + staged<32 * NK>(qa[i], a_half));
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
#pragma unroll
    for (int i = 0; i < MW; ++i) fence_operands<NT / 2>(acc[i]);
    wgmma_fence();
#pragma unroll
    for (int i = 0; i < MW; ++i) Wgmma<NT>::mma(acc[i], a[kk & 1][i], desc + 2 * kk);  // +32 bytes per k32
    wgmma_commit();
    wgmma_wait<1>();  // step kk - 1 is done: its A registers are free
#pragma unroll
    for (int i = 0; i < MW; ++i) fence_operands<NT / 2>(acc[i]);
    if (kk + 1 < NK) {
#pragma unroll
      for (int i = 0; i < MW; ++i)
        ldmatrix_x4(a[(kk + 1) & 1][i], halo + staged<32 * NK>(qa[i], 2 * (kk + 1) + a_half));
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < MW; ++i) fence_operands<NT / 2>(acc[i]);
  mbar_arrive_warp(w_empty + 8 * ws, lane);
  ++wn;
}

// The A fragments of one tap for the NK bands of a 128-channel chunk, at the
// staged pixel `off` past each row's.
template <int NK, int MW>
__device__ __forceinline__ void load_bands(uint32_t (&a)[NK][MW][4], uint32_t halo, const int (&qa)[MW], int off,
                                           int a_half) {
#pragma unroll
  for (int i = 0; i < MW; ++i) {
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) ldmatrix_x4(a[kk][i], halo + staged<32 * NK>(qa[i] + off, 2 * kk + a_half));
  }
}

// The nine taps of a grouped tile: per tap, band kk's k32 step into its 16
// accumulator registers (columns 32 kk .. 32 kk + 31) with B at the slab's
// 32-byte column kk.  Tap t's wgmmas are one group; once tap t - 1's group
// has completed, its weight slot is released and its A registers take tap
// t + 1's fragments.
template <int NT, int MW>
__device__ __forceinline__ void mma_bands(int (&acc)[MW][NT / 2], const Params& p, uint32_t halo, uint32_t wbase,
                                          uint32_t w_full, uint32_t w_empty, uint32_t& wn, const int (&qa)[MW],
                                          int a_half, int lane) {
  constexpr int NK = NT / BAND;
  constexpr uint32_t WB = BAND * CK;
  uint32_t a[2][NK][MW][4];
  load_bands<NK, MW>(a[0], halo, qa, 0, a_half);
  int ws_prev = 0;
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int ws = p.resident ? tap : wn % p.w_slots;
    mbar_wait(w_full + 8 * ws, p.resident ? 0 : (wn / p.w_slots) & 1);
    const uint64_t desc = desc_sw128(wbase + ws * WB);
#pragma unroll
    for (int i = 0; i < MW; ++i) fence_operands<NT / 2>(acc[i]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
#pragma unroll
      for (int i = 0; i < MW; ++i) Wgmma<BAND>::mma(acc[i] + 16 * kk, a[tap & 1][kk][i], desc + 2 * kk);
    }
    wgmma_commit();
    wgmma_wait<1>();
#pragma unroll
    for (int i = 0; i < MW; ++i) fence_operands<NT / 2>(acc[i]);
    if (tap > 0) mbar_arrive_warp(w_empty + 8 * ws_prev, lane);
    if (tap < 8) load_bands<NK, MW>(a[(tap + 1) & 1], halo, qa, ((tap + 1) / 3) * p.hc + (tap + 1) % 3, a_half);
    ws_prev = ws;
    ++wn;
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < MW; ++i) fence_operands<NT / 2>(acc[i]);
  mbar_arrive_warp(w_empty + 8 * ws_prev, lane);
}

// TAPS 1: the 1x1 route (K chunks of C_in, dense B); TAPS 9 with BANDED: the
// grouped route.  map128 / map64 / map32: the input's tensor maps for boxes of
// 128, 64 and 32 channels; ymap the output's (int8 output, C_out % 16 == 0).
template <int NT, int MW, int TAPS, bool BANDED>
__global__ void __launch_bounds__(THREADS, 1)
qconv_gemm_kernel(const __grid_constant__ CUtensorMap map128, const __grid_constant__ CUtensorMap map64,
                  const __grid_constant__ CUtensorMap map32, const __grid_constant__ CUtensorMap ymap,
                  const Params p) {
  static_assert(NT == 64 || NT == 128, "one output box of at most 128 channels");
  constexpr uint32_t WB = (BANDED ? BAND : NT) * CK;  // one weight slab
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;  // swizzle atoms are 1024-byte aligned
  const uint32_t wbase = base + p.halo_stages * p.halo_stage_bytes;
  const uint32_t obuf = wbase + p.w_slots * WB;  // the staged output tile of the TMA-store epilogue
  const uint32_t bars = obuf + p.out_bytes;
  const uint32_t halo_full = bars, halo_empty = bars + 8 * MAX_HALO_STAGES;
  const uint32_t w_full = bars + 16 * MAX_HALO_STAGES, w_empty = w_full + 8 * MAX_W_SLOTS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tc = 1 << p.tc_log2;
  const int chunks = BANDED ? 1 : p.ch.count;

  if (threadIdx.x == 0) {
    // empty barriers take one arrival per consumer warp, full ones one expect_tx
    for (int s = 0; s < p.halo_stages; ++s) {
      mbar_init(halo_full + 8 * s, 1);
      mbar_init(halo_empty + 8 * s, CONSUMERS * 4);
    }
    for (int s = 0; s < p.w_slots; ++s) {
      mbar_init(w_full + 8 * s, 1);
      mbar_init(w_empty + 8 * s, CONSUMERS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= CONSUMERS * 4) {
    // Producer (one thread): input boxes and weight slabs, in the order the consumers take them.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(Regs<true>::producer));
    if (threadIdx.x != CONSUMERS * 128) return;
    uint32_t hn = 0, wn = 0;
    bool loaded = false;
    for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
      int r = t;
      const int nb = r % p.nb_count;
      r /= p.nb_count;
      const int tx = r % p.tiles_x;
      r /= p.tiles_x;
      const int ty = r % p.tiles_y;
      const int b = r / p.tiles_y;
      for (int kc = 0; kc < chunks; ++kc) {
        const int hs = hn % p.halo_stages;
        const int width = BANDED ? CK : p.ch.width(kc), c0 = BANDED ? nb * CK : p.ch.first(kc);
        mbar_wait(halo_empty + 8 * hs, ((hn / p.halo_stages) & 1) ^ 1);
        mbar_expect_tx(halo_full + 8 * hs, p.box_pixels * (uint32_t)width);
        tma_load_4d(base + hs * p.halo_stage_bytes, width == CK ? &map128 : width == 64 ? &map64 : &map32, c0,
                    p.in_step * tx * tc - p.pad_left, p.in_step * ty * p.tr - p.pad_top, b, halo_full + 8 * hs);
        ++hn;
        if (p.resident && loaded) continue;
        for (int tap = 0; tap < TAPS; ++tap) {
          const int ws = p.resident ? kc * TAPS + tap : wn % p.w_slots;
          mbar_wait(w_empty + 8 * ws, p.resident ? 1 : ((wn / p.w_slots) & 1) ^ 1);
          mbar_expect_tx(w_full + 8 * ws, WB);
          bulk_load(wbase + ws * WB, p.w + nb * p.w_nb + kc * p.w_kc + tap * p.w_tap, WB, w_full + 8 * ws);
          ++wn;
        }
      }
      loaded = true;
    }
    return;
  }

  // Consumers: warpgroup g owns the tile's m64 row tiles g * MW .. g * MW + MW - 1.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(Regs<true>::consumer));
  const int g = warp / 4, wi = warp % 4;
  const int a_half = lane >> 4;  // which 16-byte half of a k32 step this lane's ldmatrix address gives
  int qa[MW];  // the staged pixel of this lane's A row in each of its row tiles, at tap (0, 0)
#pragma unroll
  for (int i = 0; i < MW; ++i) {
    const int m = (g * MW + i) * 64 + 16 * wi + (lane & 15);
    qa[i] = p.ss * ((m >> p.tc_log2) * p.hc + (m & (tc - 1)));
  }
  uint32_t hn = 0, wn = 0;
  int acc[MW][NT / 2];
  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
    int r = t;
    const int nb = r % p.nb_count;
    r /= p.nb_count;
    const int tx = r % p.tiles_x;
    r /= p.tiles_x;
    const int ty = r % p.tiles_y;
    const int b = r / p.tiles_y;
#pragma unroll
    for (int i = 0; i < MW; ++i) {
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) acc[i][j] = 0;
    }
    for (int kc = 0; kc < chunks; ++kc) {
      const int hs = hn % p.halo_stages;
      mbar_wait(halo_full + 8 * hs, (hn / p.halo_stages) & 1);
      const uint32_t halo = base + hs * p.halo_stage_bytes;
      if constexpr (BANDED) {
        mma_bands<NT, MW>(acc, p, halo, wbase, w_full, w_empty, wn, qa, a_half, lane);
      } else {
        const int width = p.ch.width(kc);
        if (width == CK)
          mma_gemm<NT, MW, 4>(acc, p, halo, wbase, w_full, w_empty, kc, wn, qa, a_half, lane);
        else if (width == 64)
          mma_gemm<NT, MW, 2>(acc, p, halo, wbase, w_full, w_empty, kc, wn, qa, a_half, lane);
        else
          mma_gemm<NT, MW, 1>(acc, p, halo, wbase, w_full, w_empty, kc, wn, qa, a_half, lane);
      }
      mbar_arrive_warp(halo_empty + 8 * hs, lane);
      ++hn;
    }

    // Epilogue.  Accumulator element 4j + 2h + e of row tile i is tile pixel
    // 64 (g MW + i) + 16 wi + lane / 4 + 8 h and channel 8j + 2 (lane % 4) + e.
    if (p.tma_store) {
      tma_store_wait_read(threadIdx.x == 0);  // the last tile's store has left the buffer
      consumer_barrier();
      requant_tile<NT, MW>(acc, p, obuf, nb, g, wi, lane);
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // visible to the TMA unit
      consumer_barrier();
      tma_store_4d(&ymap, obuf, nb * NT, tx * tc, ty * p.tr, b, threadIdx.x == 0);
      continue;
    }
    store_from_registers<NT, MW>(acc, p, b, nb, p.Ho, p.Wo, lane, [&](int i, int h) {
      const int m = (g * MW + i) * 64 + 16 * wi + (lane >> 2) + 8 * h;
      return make_int2(ty * p.tr + (m >> p.tc_log2), tx * tc + (m & (tc - 1)));
    });
  }
  tma_store_wait_read(threadIdx.x == 0);  // shared memory must outlive the last store's reads
}

// The launch; the kernel may take all the shared memory a block can have,
// set once per device (a call of ~µs on the host that every launch would
// otherwise pay).
template <int NT, int MW, int TAPS, bool BANDED>
cudaError_t launch(int device, const CUtensorMap* maps, const Params& p, int grid, int smem, cudaStream_t stream) {
  static std::atomic<uint64_t> configured{0};  // a bit per device
  auto kernel = qconv_gemm_kernel<NT, MW, TAPS, BANDED>;
  const uint64_t bit = device < 64 ? uint64_t(1) << device : 0;
  if (!(configured.load() & bit)) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (err != cudaSuccess) return err;
    configured.fetch_or(bit);
  }
  kernel<<<grid, THREADS, smem, stream>>>(maps[0], maps[1], maps[2], maps[3], p);
  return cudaGetLastError();
}

int log2_of(int v) {
  int k = 0;
  while ((1 << k) < v) ++k;
  return k;
}

// The tile grid of (NT, MW): fills the geometry of p; returns the tile count.
int64_t tile_grid(Params& p, int nt, int mw, bool flat, int B, int Ho, int Wo, int cout) {
  const int px = CONSUMERS * mw * 64;
  const int tc = flat ? px : 1 << log2_of(Wo < 8 ? 8 : Wo > 64 ? 64 : Wo);
  p.tc_log2 = log2_of(tc);
  p.tr = px / tc;
  p.Ho = flat ? 1 : Ho;
  p.Wo = flat ? B * Ho * Wo : Wo;
  p.tiles_x = (p.Wo + tc - 1) / tc;
  p.tiles_y = (p.Ho + p.tr - 1) / p.tr;
  p.nb_count = (cout + nt - 1) / nt;
  return (int64_t)(flat ? 1 : B) * p.tiles_y * p.tiles_x * p.nb_count;
}

}  // namespace

// The gemm_wgmma (taps 1: a 1x1 conv, groups 1, stride 1 or 2, no padding,
// C_in % 16 == 0, weights [KC, n_pad, 128]) and grouped_wgmma (taps 9: a
// grouped 3x3 conv, C_in = C_out a multiple of 128, a group width dividing 32,
// stride 1 or 2, pads top = left, weights [C / 128, 9, 32, 128]) routes of
// ptt_qconv2d (qconv.cu), which checks the shapes.  x must be 16-byte
// aligned.  Returns the cudaError_t of the launch.
int qconv2d_gemm_wgmma(int device, const void* x, const void* w, const void* bias, const void* p0, const void* p1,
                       void* y, int B, int H, int W, int cin, int Ho, int Wo, int cout, int taps, int stride,
                       int pad_top, int pad_left, int n_pad, int mode, int relu, void* stream) {
  const ptt::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  const bool banded = taps == 9;
  if (B <= 0 || H <= 0 || W <= 0 || Ho <= 0 || Wo <= 0 || cin <= 0 || cout <= 0 || mode < 0 || mode > 2 ||
      (taps != 1 && taps != 9) || (stride != 1 && stride != 2) || cin % 16 != 0 ||
      (reinterpret_cast<uintptr_t>(x) & 15) != 0 || (reinterpret_cast<uintptr_t>(w) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(y) & 15) != 0 || (banded && (cin % CK != 0 || cout != cin)) ||
      (!banded && (n_pad % 128 != 0 || n_pad < cout)) || (int64_t)B * Ho * Wo > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;

  Params p = {};
  p.w = static_cast<const int8_t*>(w);
  p.bias = static_cast<const int*>(bias);
  p.p0 = static_cast<const int*>(p0);
  p.p1 = static_cast<const int*>(p1);
  p.y = y;
  p.cout = cout;
  p.mode = mode;
  p.relu = relu;
  p.ch = chunks_of(cin);
  // The tile: the largest (first) of the candidates whose tiles number at
  // least the SMs, else the smallest; a grouped stride-2 tile has one row
  // tile per warpgroup, its halo box being four times its output.
  const bool flat = !banded && stride == 1;
  int nt = CK, mw = banded && stride == 2 ? 1 : 2;
  int64_t tiles = 0;
  if (banded) {
    tiles = tile_grid(p, nt, mw, flat, B, Ho, Wo, cout);
    if (mw == 2 && tiles < sms) tiles = tile_grid(p, nt, mw = 1, flat, B, Ho, Wo, cout);
  } else {
    const int cands[3][2] = {{128, 2}, {128, 1}, {64, 1}};
    for (const auto& c : cands) {
      if (c[0] == 128 && cout <= 64) continue;
      nt = c[0], mw = c[1];
      tiles = tile_grid(p, nt, mw, flat, B, Ho, Wo, cout);
      if (tiles >= sms) break;
    }
  }
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  p.tiles = (int)tiles;
  const int tc = 1 << p.tc_log2;
  if (banded) {  // the halo box
    p.ss = p.in_step = stride;
    p.hc = stride * (tc - 1) + 3;
    p.box_pixels = (uint32_t)(p.hc * (stride * (p.tr - 1) + 3));
    p.pad_top = pad_top;
    p.pad_left = pad_left;
  } else {  // the output tile's own pixels (stride 2: every second input pixel, by the map's traversal strides)
    p.ss = 1;
    p.hc = tc;
    p.box_pixels = (uint32_t)(tc * p.tr);
    p.in_step = stride;
  }
  const int widest = banded || p.ch.full > 0 ? CK : p.ch.tail;
  p.halo_stage_bytes = (p.box_pixels * (uint32_t)widest + 1023u) & ~1023u;
  p.tma_store = mode != 0 && cout % 16 == 0;
  p.out_bytes = p.tma_store ? (uint32_t)(CONSUMERS * mw * 64 * nt) : 0u;
  const int wb = (banded ? BAND : nt) * CK, slabs = taps * (banded ? 1 : p.ch.count);
  p.w_nb = banded ? 9LL * BAND * CK : (long long)nt * CK;
  p.w_kc = banded ? 0 : (long long)n_pad * CK;
  p.w_tap = banded ? (long long)BAND * CK : 0;
  const int budget = SMEM_LIMIT - 1024 - BAR_BYTES - (int)p.out_bytes;
  const int hsb = (int)p.halo_stage_bytes;
  p.resident = p.nb_count == 1 && slabs <= MAX_W_SLOTS && slabs * wb + 2 * hsb <= budget;
  if (p.resident) {
    p.w_slots = slabs;
    p.halo_stages = (budget - slabs * wb) / hsb;
  } else if (!banded) {  // a chunk takes one input stage and one slab: rings of the same depth
    p.halo_stages = p.w_slots = budget / (hsb + wb);
  } else {
    p.halo_stages = 2;
    p.w_slots = (budget - 2 * hsb) / wb;
  }
  if (p.halo_stages > MAX_HALO_STAGES) p.halo_stages = MAX_HALO_STAGES;
  if (p.w_slots > MAX_W_SLOTS) p.w_slots = MAX_W_SLOTS;
  // a grouped tile's producer loads tap t + 1's slab while tap t's is in use: two slots at least
  if (p.halo_stages < 1 || p.w_slots < (banded && !p.resident ? 2 : 1)) return (int)cudaErrorInvalidValue;
  const int smem = 1024 + p.halo_stages * hsb + p.w_slots * wb + (int)p.out_bytes + BAR_BYTES;

  CUtensorMap maps[4] = {};
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  {
    // x as a 4-D tensor map, innermost first: [B, H, W, C_in], or [1, 1, M, C_in]
    // for the flat 1x1 stride-1 tile; one box is a chunk of a tile's input:
    // 128, 64 or 32 channels with the swizzle of that many bytes.
    const cuuint64_t m = (cuuint64_t)B * H * W;
    const cuuint64_t dims[4] = {(cuuint64_t)cin, flat ? m : (cuuint64_t)W, flat ? 1 : (cuuint64_t)H,
                                flat ? 1 : (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)cin, flat ? m * cin : (cuuint64_t)W * cin,
                                   flat ? m * cin : (cuuint64_t)H * W * cin};
    const bool step2 = !banded && stride == 2;
    const cuuint32_t box_w = banded ? (cuuint32_t)p.hc : (cuuint32_t)(tc * stride);
    const cuuint32_t box_h = banded ? (cuuint32_t)(stride * (p.tr - 1) + 3) : (cuuint32_t)(p.tr * stride);
    const cuuint32_t traversal[4] = {1, step2 ? 2u : 1u, step2 ? 2u : 1u, 1};
    const int widths[3] = {CK, 64, 32};
    const CUtensorMapSwizzle swizzles[3] = {CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_SWIZZLE_64B,
                                            CU_TENSOR_MAP_SWIZZLE_32B};
    const bool used[3] = {banded || p.ch.full > 0, !banded && p.ch.tail == 64,
                          !banded && (p.ch.tail == 32 || p.ch.count == p.ch.full + 2)};
    for (int k = 0; k < 3; ++k) {
      if (!used[k]) continue;
      const cuuint32_t box[4] = {(cuuint32_t)widths[k], box_w, box_h, 1};
      if (encode(&maps[k], CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(x), dims, strides, box, traversal,
                 CU_TENSOR_MAP_INTERLEAVE_NONE, swizzles[k], CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                 CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
        return (int)cudaErrorInvalidValue;
    }
  }
  if (p.tma_store) {
    // y as [B, Ho, Wo, C_out] (flat: [1, 1, M, C_out]); one box is an output
    // tile of up to 128 channels, in the swizzled layout the epilogue wrote
    const cuuint64_t dims[4] = {(cuuint64_t)cout, (cuuint64_t)p.Wo, (cuuint64_t)p.Ho, flat ? 1 : (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)cout, (cuuint64_t)p.Wo * cout, (cuuint64_t)p.Ho * p.Wo * cout};
    const cuuint32_t box[4] = {(cuuint32_t)nt, (cuuint32_t)tc, (cuuint32_t)p.tr, 1};
    const cuuint32_t unit[4] = {1, 1, 1, 1};
    const CUtensorMapSwizzle swizzle = nt == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
    if (encode(&maps[3], CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, y, dims, strides, box, unit,
               CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_NONE,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return (int)cudaErrorInvalidValue;
  }

  const int grid = p.tiles < sms ? p.tiles : sms;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (banded) return (int)(mw == 2 ? launch<128, 2, 9, true>(device, maps, p, grid, smem, s)
                                   : launch<128, 1, 9, true>(device, maps, p, grid, smem, s));
  if (nt == 64) return (int)launch<64, 1, 1, false>(device, maps, p, grid, smem, s);
  return (int)(mw == 2 ? launch<128, 2, 1, false>(device, maps, p, grid, smem, s)
                       : launch<128, 1, 1, false>(device, maps, p, grid, smem, s));
}
