// Row-wise key/payload sort by chunks: a block-local merge sort of each chunk
// in shared memory, then k-way merge rounds through device memory.
//
// Replaces the TPU kernel pytorch_toolbelt_tpu/ops/sort.py `split_sort`
// (`lax.sort` per chunk, then `_global_merge` through `_pallas_sweep`).  It
// keeps that kernel's contract and its shape -- sort each chunk, then merge
// the chunks across -- but not its bitonic network: every merge here is
// stable, so the result equals torch.sort(stable=True) bit for bit, ties
// included.  Any R >= 1, 1 <= N <= 2^32 - 1.  It is a different algorithm
// from radix_sort.cu, so the two check each other.
//
// What bounds it on the H100: memory bytes, 16 per pair per pass (the key and
// the payload read and written once), and the merging in shared memory, about
// 20 instructions per pair and level with log2(N / 16) levels in all.  So the
// design cuts the passes: a row of N pairs takes one chunk-sort pass and
// ceil(log_32(ceil(N / 8192))) merge rounds, two at N = 2^23 (a 2-way merge
// of 4096-pair chunks takes twelve passes there), five launches in all.
//   1. block_sort_kernel: 512 threads sort an 8192-pair chunk in dynamic
//      shared memory (66 KiB, two blocks per SM): each thread sorts its 16
//      pairs in registers (odd-even transposition, stable), then 9 levels of
//      merge-path merges in shared memory build the sorted chunk; the first
//      five stay inside a warp and need only a warp barrier.
//   2. per merge round, runs of width W are merged in groups of `ways` runs
//      (a power of two <= 32, chosen per round so that no round is wasted;
//      the last group and its last run may be short):
//      a. partition_kernel: one warp per output tile of 8192 pairs, one lane
//         per run of the tile's group, finds how many elements of each run come
//         before the tile's first output in the order (key, run, position):
//         a bisection on the 32 order bits that starts from the highest bit
//         in which the keys left in the per-run windows still differ, each
//         step a binary search over the splitter table (every 32nd key, in
//         order bits, written by the launch that made the runs) and then over
//         the fewer than 32 keys between two splitters; the tied remainder
//         goes to the runs in run order.  Bound by the L1 traffic of loads
//         whose 32 lanes touch 32 runs.
//      b. merge_kernel: one block per output tile stages its `ways` segments
//         (their lengths sum to the tile) in shared memory with cp.async,
//         merges them in log2(ways) levels of pairwise merge-path merges (the
//         left segment wins ties), and writes the tile coalesced.
// Both kernels keep order bits in shared memory, so that a comparison is one
// instruction, unless a block's float keys include -0.0 or a NaN, whose bits
// the order bits do not keep: such a block merges its raw keys.  Loads and
// stores of device memory are coalesced; shared-memory indices are padded by
// one word in 32 so the blocked per-thread accesses do not conflict.
// Ping-pong buffers are ordered so that the last launch writes keys_out; the
// input is never written.  No atomics, no look-back: 1 + 2 * rounds launches.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "device_guard.cuh"
#include "sort_keys.cuh"

namespace {

using ptt_sort::order_bits;

constexpr int kThreads = 512;
constexpr int kItems = 16;                 // per thread
constexpr int kChunk = kThreads * kItems;  // pairs sorted per block; outputs per merge block
constexpr int kBlocksPerSm = 1024 / kThreads;  // resident blocks the registers are sized for
constexpr int kMaxWays = 32;               // runs merged at once: one warp lane each
// One word of slack: a merge reads the key one past a segment's end (and ignores it).
constexpr int kSmemWords = kChunk + kChunk / 32 + 1;
constexpr int kSmemBytes = 2 * kSmemWords * 4;  // keys, then payloads
constexpr int kPartitionThreads = 256;          // 8 warps, one tile boundary each
constexpr int kSample = 32;                     // the splitter table holds every kSample-th key of a row
constexpr unsigned kFull = 0xffffffffu;
// Padding beyond a row's end: a NaN as float32 and INT32_MAX as int32, so it
// orders last, and after every real key of that order because it comes later.
constexpr uint32_t kPadKey = 0x7fffffffu;

__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

// What a key word in shared memory holds: a raw key of kind kFloat32 or kInt32,
// or kOrderWords, its order bits.  A block holds order bits, so that a
// comparison is one instruction, unless its float keys include -0.0 or a NaN,
// whose bits the order bits do not keep.
constexpr int kOrderWords = 2;

template <int Words>
__device__ __forceinline__ uint32_t order_of(uint32_t w) {
  return Words == kOrderWords ? w : order_bits<Words>(w);
}

// The key whose order bits are o, for a key that order_bits maps one-to-one.
template <int Kind>
__device__ __forceinline__ uint32_t key_of_order(uint32_t o) {
  if (Kind == ptt_sort::kInt32) return o ^ 0x80000000u;
  return (o & 0x80000000u) ? o ^ 0x80000000u : ~o;
}

// -0.0 and every NaN: order_bits maps them many-to-one.
template <int Kind>
__device__ __forceinline__ bool lossy(uint32_t b) {
  return Kind == ptt_sort::kFloat32 && (b == 0x80000000u || (b & 0x7fffffffu) > 0x7f800000u);
}

// Merge path in shared memory: how many of the first `diag` outputs of the
// stable merge of sk[a, a + a_len) and sk[b, b + b_len) come from a (a wins ties).
template <int Words>
__device__ __forceinline__ int merge_path(const uint32_t* sk, int a, int a_len, int b, int b_len, int diag) {
  int lo = max(0, diag - b_len), hi = min(diag, a_len);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (order_of<Words>(sk[pad(a + mid)]) <= order_of<Words>(sk[pad(b + diag - 1 - mid)]))
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// The serial part of a merge: from a[ia, a_end) and b[ib, b_end), whose next
// keys have order bits oa / ob, make this thread's outputs p, p + 1, ...
// Branch-free per output: a payload and the next key from shared memory (and,
// for raw words, the key itself: order bits alone would not give it back).
// Checked: stop at `total`, and switch to the next pair of runs where one ends.
template <int Words, bool Checked, typename Bound>
__device__ __forceinline__ void serial_merge(const uint32_t* sk, const uint32_t* sv, Bound bound, int segs, int span,
                                             int total, int p, int q, int ia, int a_end, int ib, int b_end,
                                             uint32_t (&k)[kItems], uint32_t (&v)[kItems]) {
  uint32_t oa = order_of<Words>(sk[pad(ia)]), ob = order_of<Words>(sk[pad(ib)]);
  const int ab = ia + ib;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (Checked) {
      if (p + j >= total) break;
      while (p + j == b_end) {  // the next pair starts here (an empty pair ends here too)
        q += 2 * span;
        ia = b_end;
        a_end = bound(q + span);
        b_end = bound(q + 2 * span);
        ib = a_end;
        oa = order_of<Words>(sk[pad(ia)]);
        ob = order_of<Words>(sk[pad(ib)]);
      }
    }
    const bool take_a = ib >= b_end || (ia < a_end && oa <= ob);
    const int src = take_a ? ia : ib;
    k[j] = Words == kOrderWords ? (take_a ? oa : ob) : sk[pad(src)];
    v[j] = sv[pad(src)];
    const uint32_t next = order_of<Words>(sk[pad(src + 1)]);
    ia += take_a;
    // ia + ib rises by one per output: unchecked, ib follows from ia
    ib = Checked ? ib + !take_a : ab - ia + j + 1;
    oa = take_a ? next : oa;
    ob = take_a ? ob : next;
  }
}

// Merge the outputs [p, min(p + kItems, total)) of this round into registers.
// The round merges, in pairs, the sorted runs whose bounds are bound(0..segs):
// pair q (a multiple of 2 * span) merges [bound(q), bound(q + span)) with
// [bound(q + span), bound(q + 2 * span)) (indices clamped to segs).  With
// Uniform, run j starts at j * kItems (the chunk sort); otherwise at off[j].
// A thread's outputs may run from one pair into the next, where the merge
// path starts at 0.  Every lane of the warp calls it.
template <int Words, bool Uniform>
__device__ __forceinline__ void merge_into_registers(const uint32_t* sk, const uint32_t* sv, const uint32_t* off,
                                                     int segs, int span, int total, int p, uint32_t (&k)[kItems],
                                                     uint32_t (&v)[kItems]) {
  const auto bound = [&](int j) { return Uniform ? min(j, segs) * kItems : (int)off[min(j, segs)]; };
  int q = Uniform ? (p / kItems) & ~(2 * span - 1) : 0;
  if (!Uniform)
    while (q + 2 * span < segs && bound(q + 2 * span) <= p) q += 2 * span;
  const int a_begin = bound(q);
  const int a_end = bound(q + span), b_end = bound(q + 2 * span);
  // In the chunk sort every pair holds a whole number of threads' outputs.
  // Otherwise a warp takes the checked loop if one of its threads needs it, so
  // that its lanes do not run both loops one after the other.
  const bool checked = !Uniform && __any_sync(kFull, p < total && p + kItems > b_end);
  if (p >= total) return;
  const int take = merge_path<Words>(sk, a_begin, a_end - a_begin, a_end, b_end - a_end, p - a_begin);
  const int ia = a_begin + take, ib = a_end + (p - a_begin - take);
  if (checked)
    serial_merge<Words, true>(sk, sv, bound, segs, span, total, p, q, ia, a_end, ib, b_end, k, v);
  else
    serial_merge<Words, false>(sk, sv, bound, segs, span, total, p, q, ia, a_end, ib, b_end, k, v);
}

// Merge the `segs` sorted runs of the `total` pairs in shared memory in
// ceil(log2(segs)) rounds of pairwise merges, each thread making kItems
// consecutive outputs per round; the result is left in shared memory.
template <int Words, bool Uniform>
__device__ __forceinline__ void merge_runs(uint32_t* sk, uint32_t* sv, const uint32_t* off, int segs, int total,
                                           uint32_t (&k)[kItems], uint32_t (&v)[kItems]) {
  const int mine = threadIdx.x * kItems, at = pad(mine);  // pad(mine + j) = at + j: kItems divides 32
  for (int span = 1; span < segs; span *= 2) {
    // In the chunk sort, a pair of runs of up to 16 threads' outputs each is one
    // warp's alone: a warp barrier orders what this level and the next read.
    const bool in_warp = Uniform && span <= 16, next_in_warp = Uniform && 2 * span <= 16 && 2 * span < segs;
    merge_into_registers<Words, Uniform>(sk, sv, off, segs, span, total, mine, k, v);
    in_warp ? __syncwarp() : __syncthreads();
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if (mine + j < total) {
        sk[at + j] = k[j];
        sv[at + j] = v[j];
      }
    }
    next_in_warp ? __syncwarp() : __syncthreads();
  }
}

__host__ __device__ __forceinline__ int64_t samples_of(int64_t n) { return (n + kSample - 1) / kSample; }

// Write the `count` sorted pairs in shared memory out coalesced, and the order
// bits of every kSample-th key into the splitter table (`samples`, for the
// first pair's row position, a multiple of kSample).
template <int Kind, int Words>
__device__ __forceinline__ void write_out(const uint32_t* sk, const uint32_t* sv, uint32_t* keys, uint32_t* vals,
                                          uint32_t* samples, int count) {
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int i = r * kThreads + threadIdx.x;
    if (i < count) {
      const uint32_t word = sk[pad(i)];
      keys[i] = Words == kOrderWords ? key_of_order<Kind>(word) : word;
      vals[i] = sv[pad(i)];
      if (i % kSample == 0) samples[i / kSample] = order_of<Words>(word);
    }
  }
}

// Stage the pairs k, v (this thread's kItems, strided by kThreads) in shared
// memory as Words.
template <int Kind, int Words>
__device__ __forceinline__ void stage(uint32_t* sk, uint32_t* sv, const uint32_t (&k)[kItems],
                                      const uint32_t (&v)[kItems], int count) {
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int i = r * kThreads + threadIdx.x;
    if (i < count) {
      sk[pad(i)] = Words == kOrderWords ? order_bits<Kind>(k[r]) : k[r];
      sv[pad(i)] = v[r];
    }
  }
  __syncthreads();
}

// Asynchronous 4-byte copies from device to shared memory (cp.async): a
// thread puts all of its loads in flight without holding them in registers.
__device__ __forceinline__ void copy_async(uint32_t* dst, const uint32_t* src) {
  const unsigned to = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(to), "l"(src) : "memory");
}
__device__ __forceinline__ void copies_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void copies_wait() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// The raw keys of sk[0, count) have landed: turn them into order bits, unless
// one of them is lossy, and fill [count, fill) with the pad key.  True when
// the words are order bits.  Every thread of the block calls it.
template <int Kind>
__device__ __forceinline__ bool prepare(uint32_t* sk, int count, int fill) {
  uint32_t w[kItems];
  bool lossy_keys = false;
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int i = r * kThreads + threadIdx.x;
    w[r] = i < count ? sk[pad(i)] : kPadKey;
    lossy_keys |= i < count && lossy<Kind>(w[r]);
  }
  const bool ordered = !(Kind == ptt_sort::kFloat32 && __syncthreads_or(lossy_keys));
#pragma unroll
  for (int r = 0; r < kItems; ++r) {  // each thread rewrites only the words it read
    const int i = r * kThreads + threadIdx.x;
    if (i < fill) sk[pad(i)] = ordered ? order_bits<Kind>(w[r]) : w[r];
  }
  __syncthreads();
  return ordered;
}

// Sort the kChunk pairs (padded) staged in shared memory; write the first `count`.
template <int Kind, int Words>
__device__ __forceinline__ void sort_chunk(uint32_t* sk, uint32_t* sv, uint32_t (&k)[kItems], uint32_t (&v)[kItems],
                                           uint32_t* keys, uint32_t* vals, uint32_t* samples, int count) {
  stage<Kind, Words>(sk, sv, k, v, kChunk);
  // Each thread sorts its kItems pairs by their order bits in registers, then
  // gathers its keys and payloads in that order from its own slots.
  const int mine = threadIdx.x * kItems;
  uint32_t o[kItems], at[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    o[j] = order_of<Words>(sk[pad(mine) + j]);
    at[j] = j;
  }
  // Odd-even transposition sort; swapping only strictly greater pairs keeps it stable.
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
#pragma unroll
    for (int j = r & 1; j + 1 < kItems; j += 2) {
      const bool swap = o[j + 1] < o[j];
      const uint32_t lo = swap ? o[j + 1] : o[j], hi = swap ? o[j] : o[j + 1];
      const uint32_t first = swap ? at[j + 1] : at[j], second = swap ? at[j] : at[j + 1];
      o[j] = lo;
      o[j + 1] = hi;
      at[j] = first;
      at[j + 1] = second;
    }
  }
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    k[j] = sk[pad(mine) + at[j]];
    v[j] = sv[pad(mine) + at[j]];
  }
#pragma unroll
  for (int j = 0; j < kItems; ++j) {  // only this thread's slots: no barrier between
    sk[pad(mine) + j] = k[j];
    sv[pad(mine) + j] = v[j];
  }
  __syncthreads();
  merge_runs<Words, true>(sk, sv, nullptr, kThreads, kChunk, k, v);
  write_out<Kind, Words>(sk, sv, keys, vals, samples, count);
}

template <int Kind>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    block_sort_kernel(const uint32_t* __restrict__ keys_in, const uint32_t* __restrict__ vals_in,
                      uint32_t* __restrict__ keys_out, uint32_t* __restrict__ vals_out, uint32_t* __restrict__ samples,
                      int64_t n, int64_t chunks) {
  extern __shared__ uint32_t smem[];
  uint32_t* sk = smem;
  uint32_t* sv = smem + kSmemWords;
  const int64_t row = blockIdx.x / chunks;
  const int64_t begin = (blockIdx.x % chunks) * kChunk;
  const int count = (int)min((int64_t)kChunk, n - begin);
  const int64_t base = row * n + begin;
  uint32_t k[kItems], v[kItems];
  bool lossy_keys = false;
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int i = r * kThreads + threadIdx.x;
    k[r] = i < count ? keys_in[base + i] : kPadKey;
    v[r] = i < count ? vals_in[base + i] : 0u;
    lossy_keys |= i < count && lossy<Kind>(k[r]);
  }
  uint32_t* chunk_samples = samples + row * samples_of(n) + begin / kSample;
  if (Kind == ptt_sort::kFloat32 && __syncthreads_or(lossy_keys))
    sort_chunk<Kind, Kind>(sk, sv, k, v, keys_out + base, vals_out + base, chunk_samples, count);
  else
    sort_chunk<Kind, kOrderWords>(sk, sv, k, v, keys_out + base, vals_out + base, chunk_samples, count);
}

// The runs of a merge round: width `width`, merged `ways` at a time, so group
// g of a row holds its pairs [g * width * ways, (g + 1) * width * ways).
// Output tile t of a row is [t * kChunk, (t + 1) * kChunk); width is a
// multiple of kChunk, so every tile lies in one group.
struct Round {
  int64_t n, tiles, width;
  int ways;
  __device__ __forceinline__ int64_t group_begin(int64_t t) const {
    const int64_t group = width * ways;
    return t * kChunk / group * group;
  }
  // length of run `j` of the group that starts at g0 (0 past the row's end)
  __device__ __forceinline__ uint32_t run_length(int64_t g0, int j) const {
    const int64_t start = g0 + j * width;
    return j < ways && start < n ? (uint32_t)min(width, n - start) : 0u;
  }
};

// splits[(row * tiles + t) * ways + j]: how many elements of run j of tile t's
// group come before the tile's first output, in the order (key, run, position).
template <int Kind>
__global__ void __launch_bounds__(kPartitionThreads)
    partition_kernel(const uint32_t* __restrict__ keys, const uint32_t* __restrict__ samples, int64_t rows, Round round,
                     uint32_t* __restrict__ splits) {
  const int64_t w = (int64_t)blockIdx.x * (kPartitionThreads / 32) + threadIdx.x / 32;
  if (w >= rows * round.tiles) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  const int64_t row = w / round.tiles, t = w % round.tiles;
  const int64_t g0 = round.group_begin(t);
  const uint32_t d = (uint32_t)(t * kChunk - g0);  // the tile's first output, as a rank in its group
  const uint32_t len = round.run_length(g0, lane);
  const int64_t run_start = len ? g0 + lane * round.width : 0;  // a multiple of kChunk
  const uint32_t* run = keys + row * round.n + run_start;
  const uint32_t* splitters = samples + row * samples_of(round.n) + run_start / kSample;  // run[m * kSample]
  // Invariant: lo = lb(x) and hi = lb(y) in every run for some x < y (lb(c): the
  // elements below c), with sum(lo) <= d < sum(hi); first and last are the
  // order bits of run[lo] and run[hi - 1] while lo < hi.  Each step cuts [x, y)
  // at the highest bit in which the smallest and the largest key left in the
  // windows differ, so the windows shrink and that bit falls every step.
  uint32_t lo = 0, hi = len;
  uint32_t first = len ? splitters[0] : 0u, last = len ? order_bits<Kind>(run[len - 1]) : 0u;
  if (d != 0) {
    for (;;) {
      const uint32_t mn = __reduce_min_sync(kFull, lo < hi ? first : 0xffffffffu);
      const uint32_t mx = __reduce_max_sync(kFull, lo < hi ? last : 0u);
      if (mn == mx) break;  // every key left equals mn: lo = lb(mn), hi = lb(mn + 1)
      const int h = 31 - __clz(mn ^ mx);
      const uint32_t cut = (mn & ~((2u << h) - 1u)) | (1u << h);
      // a = lb(cut) in [lo, hi): over the splitters in the window, then over the
      // fewer than kSample keys between the two that bracket the cut.  `above`
      // and `below` keep the order bits of the keys at a and a - 1 as found.
      uint32_t above = 0u, below = 0u;
      const uint32_t m0 = (lo + kSample - 1) / kSample, m1 = (hi + kSample - 1) / kSample;
      uint32_t a = m0, b = m1;
      while (a < b) {
        const uint32_t mid = a + ((b - a) >> 1), key = splitters[mid];
        if (key < cut) {
          a = mid + 1;
          below = key;
        } else {
          b = mid;
          above = key;
        }
      }
      const uint32_t m = a;
      a = m > m0 ? (m - 1) * kSample + 1 : lo;
      b = m < m1 ? m * kSample : hi;
      while (a < b) {
        const uint32_t mid = a + ((b - a) >> 1), key = order_bits<Kind>(run[mid]);
        if (key < cut) {
          a = mid + 1;
          below = key;
        } else {
          b = mid;
          above = key;
        }
      }
      if (__reduce_add_sync(kFull, a) <= d) {
        lo = a;
        first = above;  // run[a]: found unless a = hi, and then the window is empty
      } else {
        hi = a;
        last = below;  // run[a - 1]: found unless a = lo, and then the window is empty
      }
    }
  }
  // The d - sum(lo) outputs left are ties of one key: the runs take them in run order.
  const uint32_t ties = hi - lo;
  uint32_t before = ties;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t up = __shfl_up_sync(kFull, before, o);
    if (lane >= o) before += up;
  }
  before -= ties;
  const uint32_t rest = d - __reduce_add_sync(kFull, lo);
  const uint32_t take = rest > before ? min(rest - before, ties) : 0u;
  if (lane < round.ways) splits[w * round.ways + lane] = lo + take;
}

template <int Kind>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    merge_kernel(const uint32_t* __restrict__ keys_in, const uint32_t* __restrict__ vals_in,
                 uint32_t* __restrict__ keys_out, uint32_t* __restrict__ vals_out, uint32_t* __restrict__ samples,
                 Round round, const uint32_t* __restrict__ splits) {
  extern __shared__ uint32_t smem[];
  uint32_t* sk = smem;
  uint32_t* sv = smem + kSmemWords;
  __shared__ uint32_t off[kMaxWays + 1];  // segment j of the tile is staged at [off[j], off[j + 1])
  __shared__ uint32_t start[kMaxWays];    // and read from the row at start[j]
  const int64_t row = blockIdx.x / round.tiles, t = blockIdx.x % round.tiles;
  const int64_t out_begin = t * kChunk;
  const int total = (int)min((int64_t)kChunk, round.n - out_begin);
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int64_t g0 = round.group_begin(t);
    const uint32_t len = round.run_length(g0, lane);
    const bool last_of_group = t + 1 == round.tiles || round.group_begin(t + 1) != g0;
    const uint32_t* mine = splits + (row * round.tiles + t) * round.ways + lane;
    const uint32_t s0 = lane < round.ways ? mine[0] : 0u;
    const uint32_t s1 = lane >= round.ways ? 0u : last_of_group ? len : mine[round.ways];
    uint32_t end = s1 - s0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t up = __shfl_up_sync(kFull, end, o);
      if (lane >= o) end += up;
    }
    if (lane < round.ways) {
      off[lane + 1] = end;
      start[lane] = (uint32_t)(g0 + lane * round.width) + s0;  // < n <= 2^32 - 1 when the segment is not empty
    }
    if (lane == 0) off[0] = 0;
  }
  __syncthreads();
  const uint32_t* ik = keys_in + row * round.n;
  const uint32_t* iv = vals_in + row * round.n;
  int seg = 0;  // the segment of position i: i rises, and so does seg
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int i = r * kThreads + threadIdx.x;
    if (i < total) {
      while ((int)off[seg + 1] <= i) ++seg;  // stops at a segment that is not empty
      const uint32_t src = start[seg] + (uint32_t)(i - (int)off[seg]);
      copy_async(sk + pad(i), ik + src);
      copy_async(sv + pad(i), iv + src);
    }
  }
  copies_commit();
  copies_wait();
  __syncthreads();
  uint32_t* ok = keys_out + row * round.n + out_begin;
  uint32_t* ov = vals_out + row * round.n + out_begin;
  uint32_t* tile_samples = samples + row * samples_of(round.n) + out_begin / kSample;
  uint32_t k[kItems], v[kItems];
  if (prepare<Kind>(sk, total, total)) {
    merge_runs<kOrderWords, false>(sk, sv, off, round.ways, total, k, v);
    write_out<Kind, kOrderWords>(sk, sv, ok, ov, tile_samples, total);
  } else {
    merge_runs<Kind, false>(sk, sv, off, round.ways, total, k, v);
    write_out<Kind, Kind>(sk, sv, ok, ov, tile_samples, total);
  }
}

// Lets both kernels take kSmemBytes of dynamic shared memory, more than the
// 48 KiB default, on `device` (the current one): once per device.
template <int Kind>
cudaError_t allow_smem(int device) {
  constexpr int kMaxDevices = 64;
  static std::atomic<bool> allowed[kMaxDevices];
  const bool known = device >= 0 && device < kMaxDevices;
  if (known && allowed[device].load(std::memory_order_acquire)) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(block_sort_kernel<Kind>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSmemBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(merge_kernel<Kind>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (known && err == cudaSuccess) allowed[device].store(true, std::memory_order_release);
  return err;
}

int64_t chunks_of(int64_t n) { return (n + kChunk - 1) / kChunk; }

// Merge rounds for `runs` sorted runs: the fewest with at most kMaxWays runs merged at once.
int rounds_for(int64_t runs) {
  int rounds = 0;
  for (int64_t reach = 1; reach < runs; reach *= kMaxWays) ++rounds;
  return rounds;
}

// Runs merged at once in the next of `rounds` rounds: the least power of two
// whose rounds-th power covers `runs`, so that no later round is wasted.
int ways_for(int64_t runs, int rounds) {
  for (int ways = 2;; ways *= 2) {
    int64_t reach = 1;
    for (int r = 0; r < rounds && reach < runs; ++r) reach *= ways;
    if (reach >= runs || ways == kMaxWays) return ways;
  }
}

template <int Kind>
cudaError_t run(int device, const uint32_t* keys, const uint32_t* vals, uint32_t* keys_out, uint32_t* vals_out,
                uint32_t* keys_tmp, uint32_t* vals_tmp, uint32_t* splits, uint32_t* samples, int64_t rows,
                int64_t n, cudaStream_t stream) {
  const int64_t chunks = chunks_of(n);
  const int64_t blocks = rows * chunks;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  cudaError_t err = allow_smem<Kind>(device);
  if (err != cudaSuccess) return err;
  const int rounds = rounds_for(chunks);
  // Ping-pong so that the last launch writes keys_out; the input is never written.
  uint32_t* dst_k = rounds % 2 == 0 ? keys_out : keys_tmp;
  uint32_t* dst_v = rounds % 2 == 0 ? vals_out : vals_tmp;
  block_sort_kernel<Kind><<<(unsigned)blocks, kThreads, kSmemBytes, stream>>>(keys, vals, dst_k, dst_v, samples, n,
                                                                                chunks);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const unsigned partition_blocks = (unsigned)((blocks + kPartitionThreads / 32 - 1) / (kPartitionThreads / 32));
  int64_t runs = chunks, width = kChunk;
  for (int r = 0; r < rounds; ++r) {
    const Round round{n, chunks, width, ways_for(runs, rounds - r)};
    const uint32_t* src_k = dst_k;
    const uint32_t* src_v = dst_v;
    dst_k = src_k == keys_out ? keys_tmp : keys_out;
    dst_v = src_v == vals_out ? vals_tmp : vals_out;
    partition_kernel<Kind><<<partition_blocks, kPartitionThreads, 0, stream>>>(src_k, samples, rows, round, splits);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    merge_kernel<Kind><<<(unsigned)blocks, kThreads, kSmemBytes, stream>>>(src_k, src_v, dst_k, dst_v, samples, round,
                                                                               splits);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    runs = (runs + round.ways - 1) / round.ways;
    width *= round.ways;
  }
  return cudaSuccess;
}

}  // namespace

// 4-byte words of scratch that ptt_merge_sort needs for [rows, n]: the
// ping-pong keys and payloads, the partition splits of one round, and the
// splitter table.
extern "C" long long ptt_merge_sort_workspace(long long rows, long long n) {
  if (rows <= 0 || n <= 0) return 0;
  return 2 * rows * n + rows * chunks_of(n) * kMaxWays + rows * samples_of(n);
}

// The design on `device`: info[0] pairs per chunk and per merge tile, info[1]
// threads per block, info[2] bytes of dynamic shared memory per block,
// info[3] / info[4] blocks resident per SM of the chunk sort / the merge,
// info[5] most runs merged at once.  Returns a cudaError_t.
extern "C" int ptt_merge_sort_info(int device, int* info) {
  const ptt::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  cudaError_t err = allow_smem<ptt_sort::kFloat32>(device);
  if (err != cudaSuccess) return (int)err;
  info[0] = kChunk;
  info[1] = kThreads;
  info[2] = kSmemBytes;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[3], block_sort_kernel<ptt_sort::kFloat32>, kThreads,
                                                      kSmemBytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[4], merge_kernel<ptt_sort::kFloat32>, kThreads,
                                                        kSmemBytes);
  info[5] = kMaxWays;
  return (int)err;
}

// keys: [rows, n] float32 (key_kind 0) or int32 (key_kind 1); vals: [rows, n]
// of any 4-byte type; workspace: ptt_merge_sort_workspace(rows, n) words.
extern "C" int ptt_merge_sort(int device, const void* keys, const void* vals, void* keys_out, void* vals_out,
                              void* workspace, int key_kind, long long rows, long long n, void* stream) {
  const ptt::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  if (rows <= 0 || n <= 0 || n > 0xffffffffLL) return (int)cudaErrorInvalidValue;
  const uint32_t* k = static_cast<const uint32_t*>(keys);
  const uint32_t* v = static_cast<const uint32_t*>(vals);
  uint32_t* ko = static_cast<uint32_t*>(keys_out);
  uint32_t* vo = static_cast<uint32_t*>(vals_out);
  uint32_t* kt = static_cast<uint32_t*>(workspace);
  uint32_t* vt = kt + rows * n;
  uint32_t* splits = vt + rows * n;
  uint32_t* samples = splits + rows * chunks_of(n) * kMaxWays;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (key_kind == ptt_sort::kFloat32)
    return (int)run<ptt_sort::kFloat32>(device, k, v, ko, vo, kt, vt, splits, samples, rows, n, s);
  if (key_kind == ptt_sort::kInt32)
    return (int)run<ptt_sort::kInt32>(device, k, v, ko, vo, kt, vt, splits, samples, rows, n, s);
  return (int)cudaErrorInvalidValue;
}
