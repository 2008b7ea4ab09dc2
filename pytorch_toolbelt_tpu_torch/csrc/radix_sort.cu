// Row-wise key/payload sort: a segmented, stable LSD radix sort of 32-bit keys.
//
// Replaces the TPU kernel pytorch_toolbelt_tpu/ops/sort.py
// `bitonic_sort_chunked` (`_range_sort_kernel` / `_merge_sweep_kernel` through
// `_pallas_sweep`).  It computes what that kernel computes -- each row of
// [R, N] 4-byte keys sorted ascending, carrying a 4-byte payload -- but not its
// network: the TPU has no element-granular scatter, so it sorted by
// compare-exchange passes (O(N log^2 N) work); Hopper has that scatter, so this
// is a radix sort (O(N) work per pass).  Unlike the network it is stable, so
// equal keys keep their input order and the result equals
// torch.sort(stable=True) bit for bit, ties included.  Any R >= 1, N >= 1.
//
// What bounds it on the H100: memory bytes.  Four passes of 8 bits each; each
// pass reads the keys twice and the payload once and writes both once, with a
// few integer operations per element.  A pass is three launches:
//   1. histogram: per-(row, tile) digit counts of each 4096-element tile
//      (warp-aggregated shared-memory counts), plus per-row digit totals;
//   2. scan: one warp per (row, digit) turns the counts into each tile's
//      first output position for that digit (exclusive over digits, then tiles);
//   3. scatter: each tile ranks its elements stably (warp match + popc, per-warp
//      digit counters in shared memory) and writes key and payload to their
//      final place in the row.
// Offsets are 64-bit: one config-4 sort holds 19 x 2^23 pairs.  Onesweep-style
// decoupled look-back (one pass instead of three launches) and a wider digit
// are the known ways to make it faster.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sort_keys.cuh"

namespace {

using ptt_sort::order_bits;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;                 // per thread
constexpr int kTile = kThreads * kItems;   // elements of one (row, tile)
constexpr int kWarpItems = 32 * kItems;    // consecutive elements ranked by one warp
constexpr int kBits = 8;
constexpr int kBins = 1 << kBits;
constexpr int kPasses = 32 / kBits;
constexpr int kScanWarps = 8;
constexpr unsigned kFull = 0xffffffffu;

template <int Kind>
__device__ __forceinline__ uint32_t digit_of(uint32_t key, int shift) {
  return (order_bits<Kind>(key) >> shift) & (kBins - 1);
}

template <int Kind>
__global__ void __launch_bounds__(kThreads)
    radix_histogram_kernel(const uint32_t* __restrict__ keys, int64_t n, int64_t tiles, int shift,
                           uint32_t* __restrict__ counts, uint32_t* __restrict__ row_hist) {
  __shared__ uint32_t hist[kBins];
  for (int d = threadIdx.x; d < kBins; d += kThreads) hist[d] = 0;
  __syncthreads();
  const int64_t row = blockIdx.x / tiles;
  const int64_t tile = blockIdx.x % tiles;
  const uint32_t* rk = keys + row * n;
  const int64_t begin = tile * kTile;
  const int64_t end = min(begin + kTile, n);
  const int lane = threadIdx.x & 31;
  for (int64_t base = begin; base < end; base += kThreads) {  // uniform trip count
    const int64_t i = base + threadIdx.x;
    const bool valid = i < end;
    const uint32_t d = valid ? digit_of<Kind>(rk[i], shift) : kBins;
    const uint32_t peers = __match_any_sync(kFull, d);
    if (valid && lane == __ffs(peers) - 1) atomicAdd(&hist[d], (uint32_t)__popc(peers));
  }
  __syncthreads();
  for (int d = threadIdx.x; d < kBins; d += kThreads) {
    const uint32_t c = hist[d];
    counts[(row * kBins + d) * tiles + tile] = c;
    if (c) atomicAdd(&row_hist[row * kBins + d], c);
  }
}

// counts[(row, d, tile)] <- first position in the row of the tile's digit-d
// elements: the row's elements of smaller digits plus those of digit d in
// earlier tiles.
__global__ void __launch_bounds__(kScanWarps * 32)
    radix_scan_kernel(uint32_t* __restrict__ counts, const uint32_t* __restrict__ row_hist,
                      int64_t segments, int64_t tiles) {
  const int lane = threadIdx.x & 31;
  const int64_t seg = (int64_t)blockIdx.x * kScanWarps + (threadIdx.x >> 5);
  if (seg >= segments) return;  // whole warps
  const int64_t row = seg / kBins;
  const int d = (int)(seg % kBins);
  uint32_t run = 0;
  for (int e = lane; e < d; e += 32) run += row_hist[row * kBins + e];
  for (int o = 16; o > 0; o >>= 1) run += __shfl_xor_sync(kFull, run, o);
  uint32_t* c = counts + seg * tiles;
  for (int64_t t0 = 0; t0 < tiles; t0 += 32) {
    const int64_t t = t0 + lane;
    const uint32_t v = t < tiles ? c[t] : 0u;
    uint32_t incl = v;
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t up = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += up;
    }
    if (t < tiles) c[t] = run + incl - v;
    run += __shfl_sync(kFull, incl, 31);
  }
}

template <int Kind>
__global__ void __launch_bounds__(kThreads)
    radix_scatter_kernel(const uint32_t* __restrict__ keys_in, const uint32_t* __restrict__ vals_in,
                         uint32_t* __restrict__ keys_out, uint32_t* __restrict__ vals_out, int64_t n,
                         int64_t tiles, int shift, const uint32_t* __restrict__ offsets) {
  __shared__ uint32_t warp_hist[kWarps][kBins];
  for (int i = threadIdx.x; i < kWarps * kBins; i += kThreads) (&warp_hist[0][0])[i] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t row = blockIdx.x / tiles;
  const int64_t tile = blockIdx.x % tiles;
  const int64_t row_base = row * n;
  const int64_t first = tile * kTile + (int64_t)warp * kWarpItems;
  const uint32_t lower_lanes = (1u << lane) - 1u;

  uint32_t key[kItems], val[kItems], rank[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int64_t i = first + j * 32 + lane;
    key[j] = i < n ? keys_in[row_base + i] : 0u;
    val[j] = i < n ? vals_in[row_base + i] : 0u;
  }
  // Rank within the warp, in input order: earlier rounds first, then lower lanes.
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const bool valid = first + j * 32 + lane < n;
    const uint32_t d = valid ? digit_of<Kind>(key[j], shift) : kBins;
    const uint32_t peers = __match_any_sync(kFull, d);
    const uint32_t before = valid ? warp_hist[warp][d] : 0u;
    rank[j] = before + __popc(peers & lower_lanes);
    __syncwarp();
    if (valid && (peers & lower_lanes) == 0) warp_hist[warp][d] = before + __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  // Per digit: the tile's first position, then exclusive over the warps.
  for (int d = threadIdx.x; d < kBins; d += kThreads) {
    uint32_t run = offsets[(row * kBins + d) * tiles + tile];
    for (int w = 0; w < kWarps; ++w) {
      const uint32_t c = warp_hist[w][d];
      warp_hist[w][d] = run;
      run += c;
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (first + j * 32 + lane < n) {
      const int64_t pos = row_base + warp_hist[warp][digit_of<Kind>(key[j], shift)] + rank[j];
      keys_out[pos] = key[j];
      vals_out[pos] = val[j];
    }
  }
}

int64_t workspace_words(int64_t rows, int64_t n) {
  const int64_t tiles = (n + kTile - 1) / kTile;
  return 2 * rows * n + rows * kBins * tiles + (int64_t)kPasses * rows * kBins;
}

struct Workspace {
  uint32_t* keys_tmp;
  uint32_t* vals_tmp;
  uint32_t* counts;    // [rows, kBins, tiles]
  uint32_t* row_hist;  // [kPasses, rows, kBins]
};

Workspace layout(void* base, int64_t rows, int64_t n) {
  const int64_t tiles = (n + kTile - 1) / kTile;
  Workspace w;
  w.keys_tmp = static_cast<uint32_t*>(base);
  w.vals_tmp = w.keys_tmp + rows * n;
  w.counts = w.vals_tmp + rows * n;
  w.row_hist = w.counts + rows * kBins * tiles;
  return w;
}

template <int Kind>
cudaError_t run(const uint32_t* keys, const uint32_t* vals, uint32_t* keys_out, uint32_t* vals_out,
                const Workspace& ws, int64_t rows, int64_t n, cudaStream_t stream) {
  const int64_t tiles = (n + kTile - 1) / kTile;
  const int64_t blocks = rows * tiles;
  const int64_t segments = rows * kBins;
  const int64_t scan_blocks = (segments + kScanWarps - 1) / kScanWarps;
  if (blocks > 0x7fffffffLL || scan_blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaMemsetAsync(ws.row_hist, 0, sizeof(uint32_t) * kPasses * segments, stream);
  if (err != cudaSuccess) return err;
  const uint32_t* src_k = keys;
  const uint32_t* src_v = vals;
  for (int pass = 0; pass < kPasses; ++pass) {
    // in -> tmp -> out -> tmp -> out: the input is never written
    uint32_t* dst_k = pass % 2 == 0 ? ws.keys_tmp : keys_out;
    uint32_t* dst_v = pass % 2 == 0 ? ws.vals_tmp : vals_out;
    uint32_t* row_hist = ws.row_hist + pass * segments;
    const int shift = pass * kBits;
    radix_histogram_kernel<Kind><<<(unsigned)blocks, kThreads, 0, stream>>>(src_k, n, tiles, shift, ws.counts,
                                                                            row_hist);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    radix_scan_kernel<<<(unsigned)scan_blocks, kScanWarps * 32, 0, stream>>>(ws.counts, row_hist, segments,
                                                                             tiles);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    radix_scatter_kernel<Kind><<<(unsigned)blocks, kThreads, 0, stream>>>(src_k, src_v, dst_k, dst_v, n, tiles,
                                                                          shift, ws.counts);
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

// keys: [rows, n] float32 (key_kind 0) or int32 (key_kind 1); vals: [rows, n]
// of any 4-byte type; workspace: ptt_radix_sort_workspace(rows, n) words.
extern "C" int ptt_radix_sort(int device, const void* keys, const void* vals, void* keys_out, void* vals_out,
                              void* workspace, int key_kind, long long rows, long long n, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows <= 0 || n <= 0 || n > 0xffffffffLL) return (int)cudaErrorInvalidValue;
  const Workspace ws = layout(workspace, rows, n);
  const uint32_t* k = static_cast<const uint32_t*>(keys);
  const uint32_t* v = static_cast<const uint32_t*>(vals);
  uint32_t* ko = static_cast<uint32_t*>(keys_out);
  uint32_t* vo = static_cast<uint32_t*>(vals_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (key_kind == ptt_sort::kFloat32) return (int)run<ptt_sort::kFloat32>(k, v, ko, vo, ws, rows, n, s);
  if (key_kind == ptt_sort::kInt32) return (int)run<ptt_sort::kInt32>(k, v, ko, vo, ws, rows, n, s);
  return (int)cudaErrorInvalidValue;
}
