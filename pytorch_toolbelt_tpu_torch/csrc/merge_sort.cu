// Row-wise key/payload sort by chunks: a block-local merge sort of each chunk
// in shared memory, then rounds of stable merge-path merges in device memory.
//
// Replaces the TPU kernel pytorch_toolbelt_tpu/ops/sort.py `split_sort`
// (`lax.sort` per chunk, then `_global_merge` through `_pallas_sweep`).  It
// keeps that kernel's contract and its shape -- sort each chunk, then merge
// the chunks across -- but not its bitonic network: each merge here is a
// stable merge of two sorted runs, so the result equals
// torch.sort(stable=True) bit for bit, ties included.  Any R >= 1, N >= 1.
// It is a different algorithm from radix_sort.cu, so the two check each other.
//
// What bounds it on the H100: memory bytes.  Phase 1 reads and writes each
// pair once; each of the ceil(log2(N / 4096)) merge rounds reads and writes
// each pair once more.  Design:
//   1. block sort: 256 threads hold a 4096-pair chunk; each thread sorts its
//      16 pairs in registers (odd-even transposition, stable), then 8 rounds
//      of merge-path merges in shared memory build the sorted chunk;
//   2. merge rounds (run width 4096, 8192, ...): each block makes 4096
//      consecutive outputs of one merged pair of runs.  Two lanes find the
//      block's two merge-path split points by binary search in device memory,
//      the block stages the two input segments in shared memory, and each
//      thread merges 16 outputs from there.
// Loads and stores of device memory are coalesced; shared-memory indices are
// padded by one word in 32 so the blocked per-thread accesses do not conflict.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"
#include "sort_keys.cuh"

namespace {

using ptt_sort::order_bits;

constexpr int kThreads = 256;
constexpr int kItems = 16;                 // per thread
constexpr int kChunk = kThreads * kItems;  // pairs sorted per block; outputs per merge block
constexpr int kSmem = kChunk + kChunk / 32;
// Padding beyond a row's end: a NaN as float32 and INT32_MAX as int32, so it
// orders last, and after every real key of that order because it comes later.
constexpr uint32_t kPadKey = 0x7fffffffu;

__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

// Merge path: how many of the first `diag` outputs of the stable merge of a and
// b come from a (a wins ties).  `a_at(i)` / `b_at(i)` give order keys.
template <typename A, typename B>
__device__ __forceinline__ int64_t merge_path(A a_at, B b_at, int64_t a_len, int64_t b_len, int64_t diag) {
  int64_t lo = diag > b_len ? diag - b_len : 0;
  int64_t hi = diag < a_len ? diag : a_len;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (a_at(mid) <= b_at(diag - 1 - mid))
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// Merge up to kItems outputs, starting at output `diag`, of the sorted runs
// sk[a_begin, a_begin + a_len) and sk[b_begin, b_begin + b_len) into registers.
template <int Kind>
__device__ __forceinline__ void merge_into_registers(const uint32_t* sk, const uint32_t* sv, int a_begin,
                                                     int a_len, int b_begin, int b_len, int diag,
                                                     uint32_t (&k)[kItems], uint32_t (&v)[kItems]) {
  const int take = (int)merge_path([&](int64_t i) { return order_bits<Kind>(sk[pad(a_begin + (int)i)]); },
                                   [&](int64_t i) { return order_bits<Kind>(sk[pad(b_begin + (int)i)]); },
                                   a_len, b_len, diag);
  int ia = a_begin + take, ib = b_begin + diag - take;
  const int a_end = a_begin + a_len, b_end = b_begin + b_len;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const bool take_a =
        ib >= b_end || (ia < a_end && order_bits<Kind>(sk[pad(ia)]) <= order_bits<Kind>(sk[pad(ib)]));
    const int src = take_a ? ia++ : ib++;
    if (src < kChunk) {  // past the last output when fewer than kItems remain
      k[j] = sk[pad(src)];
      v[j] = sv[pad(src)];
    }
  }
}

template <int Kind>
__global__ void __launch_bounds__(kThreads)
    block_sort_kernel(const uint32_t* __restrict__ keys_in, const uint32_t* __restrict__ vals_in,
                      uint32_t* __restrict__ keys_out, uint32_t* __restrict__ vals_out, int64_t n,
                      int64_t chunks) {
  __shared__ uint32_t sk[kSmem], sv[kSmem];
  const int64_t row = blockIdx.x / chunks;
  const int64_t begin = (blockIdx.x % chunks) * kChunk;
  const int count = (int)min((int64_t)kChunk, n - begin);
  const int64_t base = row * n + begin;
  for (int i = threadIdx.x; i < kChunk; i += kThreads) {
    sk[pad(i)] = i < count ? keys_in[base + i] : kPadKey;
    sv[pad(i)] = i < count ? vals_in[base + i] : 0u;
  }
  __syncthreads();

  const int mine = threadIdx.x * kItems;
  uint32_t k[kItems], v[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    k[j] = sk[pad(mine + j)];
    v[j] = sv[pad(mine + j)];
  }
  // Odd-even transposition sort; swapping only strictly greater pairs keeps it stable.
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
#pragma unroll
    for (int j = r & 1; j + 1 < kItems; j += 2) {
      if (order_bits<Kind>(k[j + 1]) < order_bits<Kind>(k[j])) {
        const uint32_t tk = k[j], tv = v[j];
        k[j] = k[j + 1];
        v[j] = v[j + 1];
        k[j + 1] = tk;
        v[j + 1] = tv;
      }
    }
  }
  for (int width = kItems; width < kChunk; width *= 2) {
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      sk[pad(mine + j)] = k[j];
      sv[pad(mine + j)] = v[j];
    }
    __syncthreads();
    const int start = mine & ~(2 * width - 1);
    merge_into_registers<Kind>(sk, sv, start, width, start + width, width, mine - start, k, v);
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    sk[pad(mine + j)] = k[j];
    sv[pad(mine + j)] = v[j];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < count; i += kThreads) {
    keys_out[base + i] = sk[pad(i)];
    vals_out[base + i] = sv[pad(i)];
  }
}

// One round: merge each pair of sorted runs [s, s + width), [s + width, s + 2 width)
// of every row.  Block b makes outputs [t * kChunk, (t + 1) * kChunk) of its row.
template <int Kind>
__global__ void __launch_bounds__(kThreads)
    merge_kernel(const uint32_t* __restrict__ keys_in, const uint32_t* __restrict__ vals_in,
                 uint32_t* __restrict__ keys_out, uint32_t* __restrict__ vals_out, int64_t n, int64_t tiles,
                 int64_t width) {
  __shared__ uint32_t sk[kSmem], sv[kSmem];
  __shared__ int64_t split[2];
  const int64_t row = blockIdx.x / tiles;
  const int64_t out_begin = (blockIdx.x % tiles) * kChunk;
  const int64_t s = out_begin / (2 * width) * (2 * width);
  const int64_t a_len = min(width, n - s);
  const int64_t b_len = max((int64_t)0, min(width, n - s - width));
  const int64_t k0 = out_begin - s;
  const int64_t k1 = min(k0 + kChunk, a_len + b_len);
  const uint32_t* ak = keys_in + row * n + s;
  const uint32_t* av = vals_in + row * n + s;
  const uint32_t* bk = ak + a_len;  // read only when b_len > 0, and then a_len == width
  const uint32_t* bv = av + a_len;
  if (threadIdx.x < 2) {
    split[threadIdx.x] = merge_path([&](int64_t i) { return order_bits<Kind>(ak[i]); },
                                    [&](int64_t i) { return order_bits<Kind>(bk[i]); }, a_len, b_len,
                                    threadIdx.x == 0 ? k0 : k1);
  }
  __syncthreads();
  const int64_t a0 = split[0], b0 = k0 - split[0];
  const int na = (int)(split[1] - a0), nb = (int)(k1 - split[1] - b0);
  for (int i = threadIdx.x; i < na; i += kThreads) {
    sk[pad(i)] = ak[a0 + i];
    sv[pad(i)] = av[a0 + i];
  }
  for (int i = threadIdx.x; i < nb; i += kThreads) {
    sk[pad(na + i)] = bk[b0 + i];
    sv[pad(na + i)] = bv[b0 + i];
  }
  __syncthreads();
  const int total = na + nb;
  const int mine = min((int)threadIdx.x * kItems, total);
  uint32_t k[kItems], v[kItems];
  merge_into_registers<Kind>(sk, sv, 0, na, na, nb, mine, k, v);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (mine + j < total) {
      sk[pad(mine + j)] = k[j];
      sv[pad(mine + j)] = v[j];
    }
  }
  __syncthreads();
  uint32_t* ok = keys_out + row * n + out_begin;
  uint32_t* ov = vals_out + row * n + out_begin;
  for (int i = threadIdx.x; i < total; i += kThreads) {
    ok[i] = sk[pad(i)];
    ov[i] = sv[pad(i)];
  }
}

template <int Kind>
cudaError_t run(const uint32_t* keys, const uint32_t* vals, uint32_t* keys_out, uint32_t* vals_out,
                uint32_t* keys_tmp, uint32_t* vals_tmp, int64_t rows, int64_t n, cudaStream_t stream) {
  const int64_t chunks = (n + kChunk - 1) / kChunk;
  const int64_t blocks = rows * chunks;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  int rounds = 0;
  for (int64_t width = kChunk; width < n; width *= 2) ++rounds;
  // Ping-pong so that the last round writes keys_out; the input is never written.
  uint32_t* dst_k = rounds % 2 == 0 ? keys_out : keys_tmp;
  uint32_t* dst_v = rounds % 2 == 0 ? vals_out : vals_tmp;
  block_sort_kernel<Kind><<<(unsigned)blocks, kThreads, 0, stream>>>(keys, vals, dst_k, dst_v, n, chunks);
  cudaError_t err = cudaGetLastError();
  for (int64_t width = kChunk; width < n && err == cudaSuccess; width *= 2) {
    const uint32_t* src_k = dst_k;
    const uint32_t* src_v = dst_v;
    dst_k = src_k == keys_out ? keys_tmp : keys_out;
    dst_v = src_v == vals_out ? vals_tmp : vals_out;
    merge_kernel<Kind><<<(unsigned)blocks, kThreads, 0, stream>>>(src_k, src_v, dst_k, dst_v, n, chunks, width);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace

// 4-byte words of scratch that ptt_merge_sort needs for [rows, n].
extern "C" long long ptt_merge_sort_workspace(long long rows, long long n) {
  if (rows <= 0 || n <= 0) return 0;
  return 2 * rows * n;
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (key_kind == ptt_sort::kFloat32) return (int)run<ptt_sort::kFloat32>(k, v, ko, vo, kt, vt, rows, n, s);
  if (key_kind == ptt_sort::kInt32) return (int)run<ptt_sort::kInt32>(k, v, ko, vo, kt, vt, rows, n, s);
  return (int)cudaErrorInvalidValue;
}
