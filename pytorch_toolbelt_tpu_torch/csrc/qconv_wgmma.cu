// int8 3x3 convolution, stride 1, zero padding 1, groups 1, with Q1's
// integer epilogue, as a wgmma implicit GEMM for Hopper (sm_90a): the
// `tma_wgmma` and `ld_wgmma` routes of ops/quantized.py `qconv2d` (kernel Q1;
// its other routes, for every other shape, are qconv.cu's mma.sync kernel).
//
// Like qconv.cu it replaces no Pallas kernel: the JAX package runs these convs
// as XLA ops (pytorch_toolbelt_tpu/zoo/quantized_unet.py:140 `_qconv_apply`,
// zoo/quantized_encdec.py:572 `conv_acc`), and torch has no int8 convolution
// on CUDA.  It computes exactly what qconv.cu computes, bit for bit:
//   mode 0 "acc":   y = acc (int32)
//   mode 1 "shift": v = relu?(acc + b); y = clip((v + rnd) >> shift, +-127)
//   mode 2 "mul":   v = relu?(acc + b); v = clamp(v, +-clamp) * mult;
//                   y = clip((v + 2^22) >> 23, +-127)
// in int32 with two's-complement wraparound, >> arithmetic, a shift of 32 or
// more leaving the sign.
//
// Layout: x [B, H, W, C_in] int8 and y [B, H, W, C_out] int8 (int32 for
// "acc"): PyTorch's channels_last storage of NCHW tensors.  Weights packed by
// ops/quantized.py `_pack_wgmma` as [NB, KC, 9, NT, 128] int8: N block, K
// chunk, tap (3 * dy + dx), output channel, the chunk's input channels in a
// 128-byte row with the 128-byte swizzle already applied (K2's way: one bulk
// copy puts a slab where a wgmma B descriptor reads it, so the kernel needs no
// second tensor map and the packing is tested on the CPU).
//
// K chunks.  C_in is cut into chunks of 128 channels (one 128-byte swizzle
// row), and a remainder r into one 128-channel chunk (r > 96), 64 + 32
// (r > 64), 64 (r > 32) or 32: the 64- and 32-channel chunks are staged as
// 64- and 32-byte rows with the matching swizzle, so the UNet's C_in 32, 64,
// 96 and 192 are not padded to 128.
//
// What bounds it on the H100 (chip_smoke.py phase 16 reckons each shape so:
// bytes = x, the weights and y once, over 3.35 TB/s; operations = 2 * 9 *
// C_in * C_out per output pixel, over the int8 tensor cores' 1979 TOP/s).
// Per output pixel a layer moves C_in + C_out bytes (C_in + 4 for the int32
// head) and does 18 * C_in * C_out operations, so it is bound by bytes below
// 591 operations per byte:
//   512^2 (3->32, 32->32, 96->32, the 32->1 head): 49-432 per byte, bytes;
//   256^2 (32->64, 64->64): 384 and 576, bytes; 192->64: 864, operations;
//   128^2 (64->128, 128->128, 384->128) and 64^2 (128->256, 256->256):
//   768-2304, operations.
// The byte-bound layers need each input byte read from device memory about
// once and the output written once, at full width; the operation-bound ones
// need the tensor cores fed at wgmma rate with the weights (up to 32 KB per
// tap at N = 256) streaming from L2 beside the input.
//
// Design: K2's (conv3x3_wgmma.cuh), with s8 operands.  M = output pixels,
// N = C_out, K = 9 taps x C_in.  A block is persistent (one per SM) and walks
// output tiles of TH rows x 64 pixels x NT channels; NT covers all of C_out up
// to 256, so the input of a pixel tile is read once.  TH is twice the rows MW
// of a consumer warpgroup: 4 at NT <= 16, 2 up to 128, 1 at 256, and 4 up to
// NT = 64 in the NARROW kernels (C_in <= 96, whose A fragments are at most
// two k32 steps deep, so the accumulator may double): more wgmmas per tap for
// the byte-bound 512^2 and 256^2 layers.  Warpgroup 2 is the
// producer.  For every K chunk it fills one stage of a ring (up to eight) with
// the (TH + 2) x 66 pixel halo box of the chunk: on the TMA route
// (C_in % 16 == 0, x 16-byte aligned) one lane issues one TMA load of a box
// starting at (y0 - 1, x0 - 1), whose zero fill of out-of-bounds elements is
// the padding (and the zero channels of a chunk past C_in); on the load route
// (any other C_in: the 3-channel stem) its 128 threads gather the box with
// plain loads and write the zeros themselves (a ring that only ever holds one
// chunk is zeroed once, and then only the words that hold channels are
// written).  One lane also issues bulk copies of the weight slabs: resident
// where all 9 x KC slabs fit beside the ring (on the UNet: C_in <= 96 with
// C_out <= 64), else streamed per tap through a ring of slots.  mbarriers carry
// the full / empty hand-offs.  Warpgroups 0 and 1 are the consumers, each
// owning MW rows of 64 pixels.  For every tap (dy, dx) the A operand is the
// halo shifted by dy rows and dx pixels: ldmatrix.x4 reads it at the shifted
// addresses, decoding the swizzle in the address.  One s8 k32 step is 32
// bytes per row, as one bf16 k16 step, and the four 8 x 16-byte matrices of
// ldmatrix.x4 (rows g and g + 8, bytes 0-15 and 16-31) land in the .s8 A
// fragment's registers: lane l holds bytes 4 (l % 4) .. 4 (l % 4) + 3 of rows
// l / 4 and l / 4 + 8, then bytes 16 + 4 (l % 4) .. of the same rows.  So one
// staged halo serves all nine taps, and B comes from the weight slab by
// descriptor: wgmma.mma_async.m64nNk32.s32.s8.s8.
//
// The one deliberate difference from K2: the accumulator is int32 and the
// epilogue is Q1's integer requant (with its per-channel operands read per
// 8-channel group, not held for the tile).  Where the output is int8 and
// C_out % 16 == 0 it writes the tile to shared memory, in rows of up to 128
// bytes with the matching swizzle (two boxes at N = 256), and one thread
// hands it to TMA stores, so the consumers start the next tile while it
// drains; int32 output ("acc") and other C_out take 2- or 8-byte stores from
// registers.  The requant is compiled once per mode and ReLU (the integer
// pipe issues at half the FP32 rate, and a run-time mode would predicate both
// modes' instructions), but at N = 256, where four copies beside the 128
// accumulator registers would spill.
//
// What holds it back (chip_smoke.py phase 16 and PERF.md have the times).
// Per output pixel the main loop reads 9 * C_in bytes of A through ldmatrix
// and, in the wgmmas, 9 * C_in * C_out / 64 bytes of B from shared memory: at
// 64 -> 64 that is ~1.1 KB against 128 bytes of device memory.  The epilogue
// runs after the main loop, on the same warps, and its integer requant takes
// about as long again as the main loop on the byte-bound layers; nothing of
// one tile's epilogue overlaps the next tile's wgmmas.

#include <cuda.h>  // CUtensorMap and its enums; tma.cuh fetches the driver entry point at run time
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"
#include "qconv_wgmma.cuh"
#include "tma.cuh"

namespace {

constexpr int TW = 64;                          // output pixels per tile row: one m64 wgmma tile
constexpr int HALO_W = TW + 2;                  // pixels per staged halo row
constexpr int LD_UNROLL = 4;        // words each producer thread gathers at once (load route)

// Rows of 64 pixels each consumer warpgroup owns: fewer as N, and with it
// the accumulator, grows.  A NARROW kernel takes only C_in <= 96 (no
// 128-channel chunk, so its A fragments are at most two k32 steps deep) and
// holds four rows up to N = 64: more wgmmas per tap for the byte-bound layers.
__host__ __device__ constexpr int rows_per_warpgroup(int nt, bool narrow) {
  return nt <= 16 || (narrow && nt <= 64) ? 4 : nt <= 128 ? 2 : 1;
}

struct Params {
  const int8_t* x;  // the load route reads x directly
  const int8_t* w;
  const int* bias;
  const int* p0;  // "shift": rnd; "mul": mult
  const int* p1;  // "shift": shift; "mul": clamp
  void* y;
  int H, W, cin, cout, mode, relu;
  Chunks ch;
  int nb_count, tiles_y, tiles_x, tiles;
  int halo_stages, w_slots, resident, tma_store, x_words;
  uint32_t halo_stage_bytes, out_bytes;
};

// The A fragments of one tap for NK k32 steps (a chunk of 32 * NK channels)
// and MW row tiles: ldmatrix at the tap's shifted pixel, decoding the swizzle
// in the address.
template <int NK, int MW>
__device__ __forceinline__ void load_a(uint32_t (&a)[NK][MW][4], uint32_t halo, int row0, int a_px, int a_half,
                                       int tap) {
  const int dy = tap / 3, dx = tap % 3;
#pragma unroll
  for (int i = 0; i < MW; ++i) {
    const int q = (row0 + i + dy) * HALO_W + a_px + dx;  // pixel of the halo box
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) ldmatrix_x4(a[kk][i], halo + staged<32 * NK>(q, 2 * kk + a_half));
  }
}

// The nine taps of one K chunk of NK k32 steps.  Tap t's wgmmas are
// committed as one group; once tap t - 1's group has completed, its weight
// slot is released and its A registers take tap t + 1's fragments, so the
// tensor cores always have the next group queued.
template <int NT, int MW, int NK>
__device__ __forceinline__ void mma_chunk(int (&acc)[MW][NT / 2], const Params& p, uint32_t halo, uint32_t wbase,
                                          uint32_t w_full, uint32_t w_empty, int kc, uint32_t& wn, int row0,
                                          int a_px, int a_half, int lane) {
  constexpr uint32_t WB = NT * CK;
  uint32_t a[2][NK][MW][4];
  load_a<NK, MW>(a[0], halo, row0, a_px, a_half, 0);
  int ws_prev = 0;
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int ws = p.resident ? kc * 9 + tap : wn % p.w_slots;
    mbar_wait(w_full + 8 * ws, p.resident ? 0 : (wn / p.w_slots) & 1);
    const uint64_t desc = desc_sw128(wbase + ws * WB);
#pragma unroll
    for (int i = 0; i < MW; ++i) fence_operands<NT / 2>(acc[i]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
#pragma unroll
      for (int i = 0; i < MW; ++i) Wgmma<NT>::mma(acc[i], a[tap & 1][kk][i], desc + 2 * kk);  // +32 bytes per k32
    }
    wgmma_commit();
    wgmma_wait<1>();  // tap t - 1 is done
#pragma unroll
    for (int i = 0; i < MW; ++i) fence_operands<NT / 2>(acc[i]);
    if (tap > 0) mbar_arrive_warp(w_empty + 8 * ws_prev, lane);  // harmless for resident weights: nobody waits again
    if (tap < 8) load_a<NK, MW>(a[(tap + 1) & 1], halo, row0, a_px, a_half, tap + 1);
    ws_prev = ws;
    ++wn;
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < MW; ++i) fence_operands<NT / 2>(acc[i]);
  mbar_arrive_warp(w_empty + 8 * ws_prev, lane);
}

// Load route: the producer warpgroup's 128 threads fill one halo stage with
// the `width` channels from c0 of the box of tile (b, ty, tx), as 4-byte
// words in the swizzled layout TMA would give, zeros for pixels off the image
// and channels past C_in.  The first `words` words of each staged pixel are
// written: all width / 4 of them, or, where the ring was zeroed once, those
// that hold channels.
template <int TH>
__device__ __forceinline__ void gather_halo(const Params& p, uint32_t stage, int ptid, int b, int ty, int tx, int c0,
                                            int width, int words) {
  const int total = (TH + 2) * HALO_W * words;
  for (int e0 = ptid; e0 < total; e0 += 128 * LD_UNROLL) {
    uint32_t v[LD_UNROLL];
#pragma unroll
    for (int u = 0; u < LD_UNROLL; ++u) {
      const int e = e0 + 128 * u;
      const int q = e / words, wd = e - q * words;  // consecutive threads take consecutive words
      const int y = ty * TH - 1 + q / HALO_W, xx = tx * TW - 1 + q % HALO_W, c = c0 + 4 * wd;
      v[u] = 0u;
      if (e < total && y >= 0 && y < p.H && xx >= 0 && xx < p.W && c < p.cin) {
        const int8_t* src = p.x + (((size_t)b * p.H + y) * p.W + xx) * p.cin + c;
        if (p.x_words) {
          v[u] = __ldg(reinterpret_cast<const unsigned*>(src));
        } else {
          const int n = p.cin - c;
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (k < n) v[u] |= (uint32_t)(uint8_t)__ldg(src + k) << (8 * k);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < LD_UNROLL; ++u) {
      const int e = e0 + 128 * u;
      const int q = e / words, wd = e - q * words;
      if (e < total) st_shared_u32(stage + staged_rt(width, q, wd >> 2) + 4 * (wd & 3), v[u]);
    }
  }
}

// TMA: the input comes by tensor map (C_in % 16 == 0) or by the load route.
// NARROW: C_in <= 96, four rows per warpgroup up to N = 64.  map128 / map64 /
// map32 are the input maps of 128-, 64- and 32-channel boxes; ymap the
// output's (int8 output with C_out % 16 == 0).
template <int NT, bool TMA, bool NARROW>
__global__ void __launch_bounds__(THREADS, 1)
qconv_wgmma_kernel(const __grid_constant__ CUtensorMap map128, const __grid_constant__ CUtensorMap map64,
                   const __grid_constant__ CUtensorMap map32, const __grid_constant__ CUtensorMap ymap,
                   const Params p) {
  constexpr int MW = rows_per_warpgroup(NT, NARROW);
  constexpr int TH = CONSUMERS * MW;       // output rows per tile
  constexpr uint32_t WB = NT * CK;         // one weight slab: [NT, 128] int8
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;  // swizzle atoms are 1024-byte aligned
  const uint32_t wbase = base + p.halo_stages * p.halo_stage_bytes;
  const uint32_t obuf = wbase + p.w_slots * WB;  // the staged output tile of the TMA-store epilogue
  const uint32_t bars = obuf + p.out_bytes;
  const uint32_t halo_full = bars, halo_empty = bars + 8 * MAX_HALO_STAGES;
  const uint32_t w_full = bars + 16 * MAX_HALO_STAGES, w_empty = w_full + 8 * MAX_W_SLOTS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    // empty barriers take one arrival per consumer warp; a full halo stage one
    // expect_tx (TMA) or one arrival per producer warp (load route)
    for (int s = 0; s < p.halo_stages; ++s) {
      mbar_init(halo_full + 8 * s, TMA ? 1 : 4);
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
    // Producer: halo stages and weight slabs, in the order the consumers take them.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(Regs<TMA>::producer));
    const int ptid = threadIdx.x - CONSUMERS * 128;
    if (!TMA && p.ch.count == 1) {
      // a ring that only ever holds one chunk keeps its zero channels: zero it
      // once, then each fill writes only the words that hold channels
      for (uint32_t off = 4 * ptid; off < p.halo_stages * p.halo_stage_bytes; off += 4 * 128)
        st_shared_u32(base + off, 0u);
      asm volatile("bar.sync 2, 128;" ::: "memory");
    }
    if (TMA && ptid != 0) return;
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
      for (int kc = 0; kc < p.ch.count; ++kc) {
        const int hs = hn % p.halo_stages;
        const uint32_t stage = base + hs * p.halo_stage_bytes;
        const int width = p.ch.width(kc), c0 = p.ch.first(kc);
        mbar_wait(halo_empty + 8 * hs, ((hn / p.halo_stages) & 1) ^ 1);
        if (TMA) {
          mbar_expect_tx(halo_full + 8 * hs, (uint32_t)((TH + 2) * HALO_W * width));
          tma_load_4d(stage, width == CK ? &map128 : width == 64 ? &map64 : &map32, c0, tx * TW - 1, ty * TH - 1, b,
                      halo_full + 8 * hs);
        } else {
          const int words = p.ch.count == 1 ? (min(p.cin - c0, width) + 3) / 4 : width / 4;
          gather_halo<TH>(p, stage, ptid, b, ty, tx, c0, width, words);
          mbar_arrive_warp(halo_full + 8 * hs, lane);
        }
        ++hn;
        if (ptid != 0 || (p.resident && loaded)) continue;
        for (int tap = 0; tap < 9; ++tap) {
          const int ws = p.resident ? kc * 9 + tap : wn % p.w_slots;
          mbar_wait(w_empty + 8 * ws, p.resident ? 1 : ((wn / p.w_slots) & 1) ^ 1);
          mbar_expect_tx(w_full + 8 * ws, WB);
          bulk_load(wbase + ws * WB, p.w + ((size_t)(nb * p.ch.count + kc) * 9 + tap) * WB, WB, w_full + 8 * ws);
          ++wn;
        }
      }
      loaded = true;
    }
    return;
  }

  // Consumers: warpgroup g owns output rows g * MW .. g * MW + MW - 1 of the tile.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(Regs<TMA>::consumer));
  const int g = warp / 4, wi = warp % 4;
  const int a_px = 16 * wi + (lane & 15);  // the A row (pixel) whose address this lane gives ldmatrix
  const int a_half = lane >> 4;            // and which 16-byte half of the k32 step
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
    for (int kc = 0; kc < p.ch.count; ++kc) {
      const int hs = hn % p.halo_stages;
      mbar_wait(halo_full + 8 * hs, (hn / p.halo_stages) & 1);
      const uint32_t halo = base + hs * p.halo_stage_bytes;
      const int width = p.ch.width(kc);
      if (!NARROW && width == CK)
        mma_chunk<NT, MW, NARROW ? 2 : 4>(acc, p, halo, wbase, w_full, w_empty, kc, wn, g * MW, a_px, a_half, lane);
      else if (width == 64)
        mma_chunk<NT, MW, 2>(acc, p, halo, wbase, w_full, w_empty, kc, wn, g * MW, a_px, a_half, lane);
      else
        mma_chunk<NT, MW, 1>(acc, p, halo, wbase, w_full, w_empty, kc, wn, g * MW, a_px, a_half, lane);
      mbar_arrive_warp(halo_empty + 8 * hs, lane);
      ++hn;
    }

    // Epilogue.  Accumulator element 4j + 2h + e of this thread is output pixel
    // 16 wi + lane / 4 + 8 h of its row and channel 8j + 2 (lane % 4) + e.
    if (p.tma_store) {
      // The requantized int8 tile into shared memory, then TMA stores (which
      // drop what lies past the image or C_out); the consumers go on to the
      // next tile while they drain.
      tma_store_wait_read(threadIdx.x == 0);  // the last tile's store has left the buffer
      consumer_barrier();
      requant_tile<NT, MW>(acc, p, obuf, nb, g, wi, lane);
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // visible to the TMA unit
      consumer_barrier();
      tma_store_4d(&ymap, obuf, nb * NT, tx * TW, ty * TH, b, threadIdx.x == 0);
      if constexpr (NT == 256) tma_store_4d(&ymap, obuf + TH * TW * 128, nb * NT + 128, tx * TW, ty * TH, b, threadIdx.x == 0);
      continue;
    }
    store_from_registers<NT, MW>(acc, p, b, nb, p.H, p.W, lane, [&](int i, int h) {
      return make_int2(ty * TH + g * MW + i, tx * TW + 16 * wi + (lane >> 2) + 8 * h);
    });
  }
  tma_store_wait_read(threadIdx.x == 0);  // shared memory must outlive the last store's reads
}

template <int NT, bool TMA, bool NARROW = false>
cudaError_t launch(const CUtensorMap* maps, const Params& p, int grid, int smem, cudaStream_t stream) {
  auto kernel = qconv_wgmma_kernel<NT, TMA, NARROW>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, smem, stream>>>(maps[0], maps[1], maps[2], maps[3], p);
  return cudaGetLastError();
}

template <bool TMA>
cudaError_t launch_nt(int nt, bool narrow, const CUtensorMap* maps, const Params& p, int grid, int smem,
                      cudaStream_t s) {
  switch (nt) {
    case 8: return launch<8, TMA>(maps, p, grid, smem, s);
    case 16: return launch<16, TMA>(maps, p, grid, smem, s);
    case 32: return narrow ? launch<32, TMA, true>(maps, p, grid, smem, s) : launch<32, TMA>(maps, p, grid, smem, s);
    case 64: return narrow ? launch<64, TMA, true>(maps, p, grid, smem, s) : launch<64, TMA>(maps, p, grid, smem, s);
    case 128: return launch<128, TMA>(maps, p, grid, smem, s);
    default: return launch<256, TMA>(maps, p, grid, smem, s);
  }
}

}  // namespace

// The wgmma routes of ptt_qconv2d (qconv.cu): a 3x3, stride-1, pad-1,
// groups-1 conv of x [B, H, W, cin] with weights packed as
// [NB, KC, 9, nt, 128] (nt: 8, 16, 32, 64, 128 or 256); `tma` selects the
// TMA route (cin % 16 == 0, x 16-byte aligned) or the load route.  Returns
// the cudaError_t of the launch.
int qconv2d_wgmma(int device, const void* x, const void* w, const void* bias, const void* p0, const void* p1, void* y,
                  int B, int H, int W, int cin, int cout, int nt, int mode, int relu, int tma, void* stream) {
  const ptt::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  if (B <= 0 || H <= 0 || W <= 0 || cin <= 0 || cout <= 0 || mode < 0 || mode > 2 ||
      (tma && (cin % 16 != 0 || (xa & 15) != 0)) || (reinterpret_cast<uintptr_t>(w) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(y) & 15) != 0 ||
      (nt != 8 && nt != 16 && nt != 32 && nt != 64 && nt != 128 && nt != 256))
    return (int)cudaErrorInvalidValue;

  const bool narrow = cin <= 96;  // no 128-channel chunk
  const int th = CONSUMERS * rows_per_warpgroup(nt, narrow);
  Params p;
  p.x = static_cast<const int8_t*>(x);
  p.w = static_cast<const int8_t*>(w);
  p.bias = static_cast<const int*>(bias);
  p.p0 = static_cast<const int*>(p0);
  p.p1 = static_cast<const int*>(p1);
  p.y = y;
  p.H = H;
  p.W = W;
  p.cin = cin;
  p.cout = cout;
  p.mode = mode;
  p.relu = relu;
  p.ch = chunks_of(cin);
  p.nb_count = (cout + nt - 1) / nt;
  p.tiles_y = (H + th - 1) / th;
  p.tiles_x = (W + TW - 1) / TW;
  const int64_t tiles = (int64_t)B * p.tiles_y * p.tiles_x * p.nb_count;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  p.tiles = (int)tiles;
  p.x_words = !tma && cin % 4 == 0 && (xa & 3) == 0;
  const int widest = p.ch.full > 0 ? CK : p.ch.tail;
  p.halo_stage_bytes = ((uint32_t)((th + 2) * HALO_W * widest) + 1023u) & ~1023u;
  // the TMA-store epilogue: int8 output whose rows are whole 16-byte units
  p.tma_store = mode != 0 && cout % 16 == 0;
  p.out_bytes = p.tma_store ? (uint32_t)(th * TW * nt) : 0u;
  const int wb = nt * CK, slabs = 9 * p.ch.count;
  const int budget = SMEM_LIMIT - 1024 - BAR_BYTES - (int)p.out_bytes;
  const int hsb = (int)p.halo_stage_bytes;
  p.resident = p.nb_count == 1 && slabs <= MAX_W_SLOTS && slabs * wb + 2 * hsb <= budget;
  if (p.resident) {
    p.w_slots = slabs;
    p.halo_stages = (budget - slabs * wb) / hsb;
    if (p.halo_stages > MAX_HALO_STAGES) p.halo_stages = MAX_HALO_STAGES;
  } else {
    p.halo_stages = 2;
    p.w_slots = (budget - 2 * hsb) / wb;
    if (p.w_slots > MAX_W_SLOTS) p.w_slots = MAX_W_SLOTS;
  }
  const int smem = 1024 + p.halo_stages * hsb + p.w_slots * wb + (int)p.out_bytes + BAR_BYTES;

  CUtensorMap maps[4] = {};
  EncodeTiledFn encode = tma || p.tma_store ? encode_tiled() : nullptr;
  if ((tma || p.tma_store) && encode == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  if (tma) {
    // [B, H, W, C_in] as 4-D tensor maps, innermost first; one box is the halo
    // of a tile for one chunk: 128, 64 or 32 channels with the swizzle of that
    // many bytes.  Only the widths the chunks use are encoded.
    const cuuint64_t dims[4] = {(cuuint64_t)cin, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)cin, (cuuint64_t)W * cin, (cuuint64_t)H * W * cin};
    const int widths[3] = {CK, 64, 32};
    const CUtensorMapSwizzle swizzles[3] = {CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_SWIZZLE_64B,
                                            CU_TENSOR_MAP_SWIZZLE_32B};
    const bool used[3] = {p.ch.full > 0, p.ch.tail == 64, p.ch.tail == 32 || p.ch.count == p.ch.full + 2};
    for (int m = 0; m < 3; ++m) {
      if (!used[m]) continue;
      const cuuint32_t box[4] = {(cuuint32_t)widths[m], (cuuint32_t)HALO_W, (cuuint32_t)(th + 2), 1};
      if (encode(&maps[m], CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(x), dims, strides, box, unit,
                 CU_TENSOR_MAP_INTERLEAVE_NONE, swizzles[m], CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                 CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
        return (int)cudaErrorInvalidValue;
    }
  }
  if (p.tma_store) {
    // [B, H, W, C_out]; one box is an output tile of up to 128 channels, in
    // the swizzled layout the epilogue wrote (out_at)
    const cuuint64_t dims[4] = {(cuuint64_t)cout, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)cout, (cuuint64_t)W * cout, (cuuint64_t)H * W * cout};
    const int rb = nt > 128 ? 128 : nt;
    const cuuint32_t box[4] = {(cuuint32_t)rb, (cuuint32_t)TW, (cuuint32_t)th, 1};
    const CUtensorMapSwizzle swizzle = rb == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                       : rb == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                       : rb == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                                                  : CU_TENSOR_MAP_SWIZZLE_NONE;
    if (encode(&maps[3], CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, y, dims, strides, box, unit,
               CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_NONE,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return (int)cudaErrorInvalidValue;
  }

  int sms = 0;
  const cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const int grid = p.tiles < sms ? p.tiles : sms;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(tma ? launch_nt<true>(nt, narrow, maps, p, grid, smem, s)
                    : launch_nt<false>(nt, narrow, maps, p, grid, smem, s));
}
