// Row-wise key/payload sort: a segmented, stable LSD radix sort of 32-bit keys,
// one sweep per digit place with decoupled look-back ("one-sweep").
//
// Replaces the TPU kernel pytorch_toolbelt_tpu/ops/sort.py
// `bitonic_sort_chunked` (`_range_sort_kernel` / `_merge_sweep_kernel` through
// `_pallas_sweep`).  It computes what that kernel computes -- each row of
// [R, N] 4-byte keys sorted ascending, carrying a 4-byte payload -- but not its
// network: the TPU has no element-granular scatter, so it sorted by
// compare-exchange passes (O(N log^2 N) work); Hopper has that scatter, so this
// is a radix sort (O(N) work per pass).  Unlike the network it is stable, so
// equal keys keep their input order and the result equals
// torch.sort(stable=True) bit for bit, ties included.  Any R >= 1 and
// 1 <= N <= 2^32 - 1.
//
// What bounds it on the H100: memory bytes.  The design reads the keys once
// for all four histograms, then makes four passes of 8 bits, each reading and
// writing keys and payloads once: 4 + 4 * 16 = 68 bytes per pair.  A sort is
// one memset (status words, histograms, counters) and six launches:
//   1. histogram: each block counts all four digit places of a 64K-key chunk
//      of one row in shared sub-histograms (four per block, so the lanes of
//      a warp that share a digit seldom share a counter), then adds the
//      non-zero counts to [4, R, 256] in device memory;
//   2. bases: per (place, row), the exclusive scan over the 256 digits;
//   3. four passes, one launch each.  A block takes the next (row, tile) of
//      7680 pairs from the pass's counter, not from blockIdx, so every tile it
//      waits on belongs to a block that is already running: the look-back
//      cannot deadlock.  Tiles go row by row, so neighbouring tiles of a row
//      run together and the partial sectors at the ends of their digit runs
//      meet in L2.  The block asks L2 for its payload lines at once, then
//      ranks its keys stably (per warp, in input order: ballots on the
//      digit's bits find the lanes that share it, per-warp digit counters in
//      shared memory), publishes its per-digit counts in the status words,
//      and looks back over the row's earlier tiles, adding their counts
//      until it meets an inclusive prefix, which it then publishes for its
//      own tile.  Keys, then payloads, go through shared memory into
//      tile-local digit order, so consecutive threads write consecutive
//      addresses of each digit's run in the row.
// A status word is 64 bits: the count below, and above it an epoch that says
// which pass wrote it and whether it holds the tile's own counts (2 pass + 1)
// or the row's inclusive prefix (2 pass + 2).  One array serves the four
// passes; anything older than this pass's epochs reads as not yet published.
// Offsets into a row are 32-bit (N < 2^32), the row's start 64-bit: one
// config-4 sort holds 19 x 2^23 pairs.  The input is never written.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "device_guard.cuh"
#include "sort_keys.cuh"

namespace {

using ptt_sort::order_bits;

constexpr int kBits = 8;
constexpr int kBins = 1 << kBits;
constexpr int kPasses = 32 / kBits;
constexpr unsigned kFull = 0xffffffffu;

constexpr int kHistThreads = 512;
constexpr int kHistUnroll = 8;        // keys in flight per thread
constexpr int kHistParts = 4;         // shared sub-histograms; lane % 4 picks one
constexpr int kHistChunk = 1 << 16;   // keys of one row per histogram block

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 15;                 // per thread
constexpr int kTile = kThreads * kItems;   // pairs of one (row, tile)
constexpr int kWarpItems = 32 * kItems;    // consecutive pairs ranked by one warp

template <int Kind>
__device__ __forceinline__ uint32_t digit_of(uint32_t key, int shift) {
  return (order_bits<Kind>(key) >> shift) & (kBins - 1);
}

// Exclusive scan of one value per thread over the block, in thread order.
// warp_totals holds Threads / 32 words; the caller syncs before reusing it.
template <int Threads>
__device__ __forceinline__ uint32_t block_exclusive_scan(uint32_t v, uint32_t* warp_totals) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint32_t incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t up = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += up;
  }
  if (lane == 31) warp_totals[warp] = incl;
  __syncthreads();
  uint32_t before = 0;
  for (int w = 0; w < warp; ++w) before += warp_totals[w];
  return before + incl - v;
}

// The lanes of the warp whose digit equals this lane's (CUB's MatchAny).
__device__ __forceinline__ uint32_t match_digit(uint32_t d) {
  uint32_t peers = kFull;
#pragma unroll
  for (int b = 0; b < kBits; ++b) {
    const bool bit = (d >> b) & 1u;
    const uint32_t ones = __ballot_sync(kFull, bit);
    peers &= bit ? ones : ~ones;
  }
  return peers;
}

// A status word carries its whole message (epoch and count), so relaxed
// device-scope accesses suffice: nothing else is published through it, and a
// release store would first wait for the thread's payload loads in flight.
__device__ __forceinline__ void store_status(uint64_t* p, uint64_t v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ uint64_t load_status(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// hist[place, row, d] += the chunk's keys whose digit at `place` is d.
template <int Kind>
__global__ void __launch_bounds__(kHistThreads)
    radix_histogram_kernel(const uint32_t* __restrict__ keys, int64_t n, int64_t chunks, int64_t rows,
                           uint32_t* __restrict__ hist) {
  // [place][digit][part]: the parts of one digit lie in neighbouring banks
  __shared__ uint32_t bins[kPasses * kBins * kHistParts];
  for (int i = threadIdx.x; i < kPasses * kBins * kHistParts; i += kHistThreads) bins[i] = 0;
  __syncthreads();
  const int64_t row = blockIdx.x / chunks;
  const int64_t begin = (blockIdx.x % chunks) * kHistChunk;
  const int64_t end = min(begin + (int64_t)kHistChunk, n);
  const uint32_t* rk = keys + row * n;
  const int part = threadIdx.x % kHistParts;
  for (int64_t base = begin + threadIdx.x; base < end; base += kHistThreads * kHistUnroll) {
    uint32_t b[kHistUnroll];
#pragma unroll
    for (int u = 0; u < kHistUnroll; ++u) {
      const int64_t i = base + u * kHistThreads;
      b[u] = i < end ? order_bits<Kind>(rk[i]) : 0u;
    }
#pragma unroll
    for (int u = 0; u < kHistUnroll; ++u) {
      if (base + u * kHistThreads < end) {
#pragma unroll
        for (int p = 0; p < kPasses; ++p)
          atomicAdd(&bins[(p * kBins + ((b[u] >> (p * kBits)) & (kBins - 1))) * kHistParts + part], 1u);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kPasses * kBins; i += kHistThreads) {
    uint32_t c = 0;
#pragma unroll
    for (int q = 0; q < kHistParts; ++q) c += bins[i * kHistParts + q];
    if (c) atomicAdd(&hist[((int64_t)(i / kBins) * rows + row) * kBins + i % kBins], c);
  }
}

// bases[place, row, d] <- the row's keys whose digit at `place` is below d.
__global__ void __launch_bounds__(kBins)
    radix_bases_kernel(const uint32_t* __restrict__ hist, uint32_t* __restrict__ bases) {
  __shared__ uint32_t warp_totals[kBins / 32];
  const int64_t at = (int64_t)blockIdx.x * kBins + threadIdx.x;
  bases[at] = block_exclusive_scan<kBins>(hist[at], warp_totals);
}

struct PassSmem {
  uint32_t keys[kTile];  // the tile in tile-local digit order
  uint32_t vals[kTile];
  uint32_t warp_hist[kWarps][kBins];  // per-warp digit counts, then each warp's first local position
  uint32_t offset[kBins];             // row position of tile-local position 0 of each digit (mod 2^32)
  uint32_t warp_totals[kWarps];
  uint32_t tile_id;
};

// One digit place: keys_in/vals_in -> keys_out/vals_out, stable, per row.
template <int Kind>
__global__ void __launch_bounds__(kThreads, 2)
    radix_pass_kernel(const uint32_t* __restrict__ keys_in, const uint32_t* __restrict__ vals_in,
                      uint32_t* __restrict__ keys_out, uint32_t* __restrict__ vals_out, int64_t n, int64_t tiles,
                      int pass, const uint32_t* __restrict__ bases, uint64_t* __restrict__ status,
                      uint32_t* __restrict__ counter) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  PassSmem& sm = *reinterpret_cast<PassSmem*>(smem_raw);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int shift = pass * kBits;
  const uint64_t own_epoch = 2u * pass + 1u;   // a tile's own counts
  const uint64_t incl_epoch = 2u * pass + 2u;  // the row's prefix through the tile

  uint32_t* hist = sm.warp_hist[warp];
  for (int d = lane; d < kBins; d += 32) hist[d] = 0;
  if (threadIdx.x == 0) sm.tile_id = atomicAdd(counter, 1u);
  __syncthreads();
  // row-major: neighbouring tiles of a row run at the same time, so the
  // partial sectors at the ends of their digit runs meet in L2
  const int64_t row = sm.tile_id / tiles;
  const int64_t tile = sm.tile_id % tiles;
  const int64_t tile_begin = row * n + tile * kTile;
  const int count = (int)min((int64_t)kTile, n - tile * kTile);
  const int first = warp * kWarpItems;
  // The payload is read only after the ranking: bring its lines into L2 now.
  for (int line = threadIdx.x; line * 32 < count; line += kThreads)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(vals_in + tile_begin + line * 32));

  uint32_t key[kItems], pos[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = first + j * 32 + lane;
    key[j] = i < count ? keys_in[tile_begin + i] : 0u;
  }
  // Rank within the warp, in input order: earlier rounds first, then lower lanes.
  const uint32_t lower_lanes = (1u << lane) - 1u;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const bool valid = first + j * 32 + lane < count;
    const uint32_t d = digit_of<Kind>(key[j], shift);
    const uint32_t peers = match_digit(d) & __ballot_sync(kFull, valid);
    const uint32_t before = hist[d];
    pos[j] = before + __popc(peers & lower_lanes);
    __syncwarp();
    if (valid && (peers & lower_lanes) == 0) hist[d] = before + __popc(peers);
    __syncwarp();
  }
  __syncthreads();

  // Per digit (thread d): the tile's count, published at once; the tile-local
  // start of the digit; each warp's first position within it.
  const int d = threadIdx.x;
  uint32_t total = 0;
  uint64_t* own = status + (row * tiles + tile) * kBins + d;
  if (d < kBins) {
    for (int w = 0; w < kWarps; ++w) total += sm.warp_hist[w][d];
    store_status(own, ((tile == 0 ? incl_epoch : own_epoch) << 32) | total);
  }
  const uint32_t start = block_exclusive_scan<kThreads>(total, sm.warp_totals);
  if (d < kBins) {
    uint32_t run = start;
    for (int w = 0; w < kWarps; ++w) {
      const uint32_t c = sm.warp_hist[w][d];
      sm.warp_hist[w][d] = run;
      run += c;
    }
  }
  __syncthreads();

#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (first + j * 32 + lane < count) {
      pos[j] += hist[digit_of<Kind>(key[j], shift)];
      sm.keys[pos[j]] = key[j];
    }
  }
  uint32_t val[kItems];  // loads in flight during the look-back
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = first + j * 32 + lane;
    val[j] = i < count ? vals_in[tile_begin + i] : 0u;
  }

  // Look back: add the earlier tiles' counts until an inclusive prefix.
  if (d < kBins) {
    uint32_t prefix = 0;
    if (tile > 0) {
      const uint64_t* s = own - kBins;
      for (;;) {
        const uint64_t word = load_status(s);
        const uint64_t epoch = word >> 32;
        if (epoch < own_epoch) continue;  // not published yet
        prefix += (uint32_t)word;
        if (epoch == incl_epoch) break;
        s -= kBins;
      }
      store_status(own, (incl_epoch << 32) | (prefix + total));
    }
    sm.offset[d] = bases[row * kBins + d] + prefix - start;
  }
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (first + j * 32 + lane < count) sm.vals[pos[j]] = val[j];
  }
  __syncthreads();

  // Each digit's run of the tile: consecutive threads, consecutive addresses.
  uint32_t* ko = keys_out + row * n;
  uint32_t* vo = vals_out + row * n;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = k * kThreads + threadIdx.x;
    if (i < count) {
      const uint32_t k_i = sm.keys[i];
      const uint32_t at = sm.offset[digit_of<Kind>(k_i, shift)] + (uint32_t)i;
      ko[at] = k_i;
      vo[at] = sm.vals[i];
    }
  }
}

int64_t tiles_of(int64_t n) { return (n + kTile - 1) / kTile; }

struct Workspace {
  uint32_t* keys_tmp;
  uint32_t* vals_tmp;
  uint64_t* status;     // [rows, tiles, kBins]      } zeroed by one memset
  uint32_t* hist;       // [kPasses, rows, kBins]    }
  uint32_t* counters;   // [kPasses]                 }
  uint32_t* bases;      // [kPasses, rows, kBins]
  size_t zeroed_bytes;
};

// 4-byte words: two [rows, n] buffers (an even count, so the status words are
// 8-byte aligned), the status words, histograms, counters and bases.
int64_t workspace_words(int64_t rows, int64_t n) {
  return 2 * rows * n + 2 * rows * tiles_of(n) * kBins + 2 * kPasses * rows * kBins + kPasses;
}

Workspace layout(void* base, int64_t rows, int64_t n) {
  Workspace w;
  w.keys_tmp = static_cast<uint32_t*>(base);
  w.vals_tmp = w.keys_tmp + rows * n;
  w.status = reinterpret_cast<uint64_t*>(w.vals_tmp + rows * n);
  w.hist = reinterpret_cast<uint32_t*>(w.status + rows * tiles_of(n) * kBins);
  w.counters = w.hist + kPasses * rows * kBins;
  w.bases = w.counters + kPasses;
  w.zeroed_bytes = reinterpret_cast<char*>(w.bases) - reinterpret_cast<char*>(w.status);
  return w;
}

// Lets the pass kernel take sizeof(PassSmem) of dynamic shared memory, more
// than the 48 KiB default, on `device` (the current one): once per device.
template <int Kind>
cudaError_t allow_pass_smem(int device) {
  constexpr int kMaxDevices = 64;
  static std::atomic<bool> allowed[kMaxDevices];
  const bool known = device >= 0 && device < kMaxDevices;
  if (known && allowed[device].load(std::memory_order_acquire)) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(radix_pass_kernel<Kind>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)sizeof(PassSmem));
  if (known && err == cudaSuccess) allowed[device].store(true, std::memory_order_release);
  return err;
}

template <int Kind>
cudaError_t run(int device, const uint32_t* keys, const uint32_t* vals, uint32_t* keys_out, uint32_t* vals_out,
                const Workspace& ws, int64_t rows, int64_t n, cudaStream_t stream) {
  const int64_t tiles = tiles_of(n);
  const int64_t chunks = (n + kHistChunk - 1) / kHistChunk;
  if (rows * tiles > 0x7fffffffLL || rows * chunks > 0x7fffffffLL || kPasses * rows > 0x7fffffffLL)
    return cudaErrorInvalidConfiguration;
  cudaError_t err = allow_pass_smem<Kind>(device);
  if (err != cudaSuccess) return err;
  if ((err = cudaMemsetAsync(ws.status, 0, ws.zeroed_bytes, stream)) != cudaSuccess) return err;
  radix_histogram_kernel<Kind><<<(unsigned)(rows * chunks), kHistThreads, 0, stream>>>(keys, n, chunks, rows,
                                                                                       ws.hist);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  radix_bases_kernel<<<(unsigned)(kPasses * rows), kBins, 0, stream>>>(ws.hist, ws.bases);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const uint32_t* src_k = keys;
  const uint32_t* src_v = vals;
  for (int pass = 0; pass < kPasses; ++pass) {
    // in -> tmp -> out -> tmp -> out: the input is never written
    uint32_t* dst_k = pass % 2 == 0 ? ws.keys_tmp : keys_out;
    uint32_t* dst_v = pass % 2 == 0 ? ws.vals_tmp : vals_out;
    radix_pass_kernel<Kind><<<(unsigned)(rows * tiles), kThreads, sizeof(PassSmem), stream>>>(
        src_k, src_v, dst_k, dst_v, n, tiles, pass, ws.bases + pass * rows * kBins, ws.status, ws.counters + pass);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    src_k = dst_k;
    src_v = dst_v;
  }
  return cudaSuccess;
}

}  // namespace

// 4-byte words of scratch that ptt_radix_sort needs for [rows, n].
extern "C" long long ptt_radix_sort_workspace(long long rows, long long n) {
  if (rows <= 0 || n <= 0) return 0;
  return workspace_words(rows, n);
}

// The pass kernel's geometry on `device`: info[0] pairs per tile, info[1]
// threads per block, info[2] bytes of shared memory per block, info[3] blocks
// resident per SM.  Returns a cudaError_t.
extern "C" int ptt_radix_sort_pass_info(int device, int* info) {
  const ptt::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  cudaError_t err = allow_pass_smem<ptt_sort::kFloat32>(device);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, radix_pass_kernel<ptt_sort::kFloat32>, kThreads,
                                                      sizeof(PassSmem));
  info[0] = kTile;
  info[1] = kThreads;
  info[2] = (int)sizeof(PassSmem);
  info[3] = blocks;
  return (int)err;
}

// keys: [rows, n] float32 (key_kind 0) or int32 (key_kind 1); vals: [rows, n]
// of any 4-byte type; workspace: ptt_radix_sort_workspace(rows, n) words,
// 8-byte aligned.
extern "C" int ptt_radix_sort(int device, const void* keys, const void* vals, void* keys_out, void* vals_out,
                              void* workspace, int key_kind, long long rows, long long n, void* stream) {
  const ptt::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  if (rows <= 0 || n <= 0 || n > 0xffffffffLL || (reinterpret_cast<uintptr_t>(workspace) & 7) != 0)
    return (int)cudaErrorInvalidValue;
  const Workspace ws = layout(workspace, rows, n);
  const uint32_t* k = static_cast<const uint32_t*>(keys);
  const uint32_t* v = static_cast<const uint32_t*>(vals);
  uint32_t* ko = static_cast<uint32_t*>(keys_out);
  uint32_t* vo = static_cast<uint32_t*>(vals_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (key_kind == ptt_sort::kFloat32) return (int)run<ptt_sort::kFloat32>(device, k, v, ko, vo, ws, rows, n, s);
  if (key_kind == ptt_sort::kInt32) return (int)run<ptt_sort::kInt32>(device, k, v, ko, vo, ws, rows, n, s);
  return (int)cudaErrorInvalidValue;
}
