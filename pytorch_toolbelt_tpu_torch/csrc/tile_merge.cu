// Grid merge: pyramid-weighted overlap-add of a complete row-major tile grid,
// fused with the normalisation and the margin crop.
//
// Replaces the TPU kernel pytorch_toolbelt_tpu/ops/tile_merge.py:374
// `pallas_grid_merge` (`pallas_call` at :358; `_make_gather_kernel` /
// `_pallas_grid_merge_nhwc`).
//
// What bounds it on the H100: memory bytes.  Every tile element inside the
// crop is read once and every output element is written once, with a
// handful of float operations per element, far below the card's
// operations-per-byte ridge.  At the main path's shape (361 fp32 tiles of
// 512^2 into a 5000^2 crop at (60, 60)) that is 470 MB with the weight,
// 0.140 ms at 3.35 TB/s.  A kernel this light is held back by
// anything it spends per element besides the bytes: index arithmetic,
// narrow accesses, and too few bytes in flight (~18 KB per SM to cover the
// memory latency at full rate).
//
// Design: the `cell` route.  The tile edges cut the canvas into a lattice of
// cells; where the steps divide the tile (sh | th, sw | tw) the cells are the
// sh x sw step cells, and inside one cell the covering tiles, kh x kw of
// them (kh = th / sh), and each one's local offset are fixed.  So a block
// owns one position inside a cell, a rectangle of BY x BX pixels, and walks
// that position through a share of the cells that meet the crop, with no
// per-element index arithmetic: the covering tiles and their offsets come
// from the cell's coordinates once.  The weights of a position are the same
// in every cell, so the block stages its kh * kw weight rectangles in shared
// memory once, for its whole life.  Each of 256 consumer threads owns 4
// consecutive pixels of the 8 x 128 rectangle: it sums the norm once per
// cell, then for each channel reads the covering tiles' 4-pixel vectors (16
// bytes fp32, 8 bf16) from shared memory, forms the sums in tile order with
// separately rounded products, divides, and writes 4 pixels with one 16-byte
// (fp32) or 8-byte (bf16) streaming store.  A producer warp keeps the
// covering tile rectangles of the next (cell, channel) in flight: one TMA
// box each into a ring of stages under mbarriers (at the main path 2 stages
// of 16 KB, 4 blocks per SM: 128 KB in flight per SM).  A warp holds one row
// of the rectangle; where the crop's x-offset or width puts that row's
// output off a 4-pixel boundary, the row passes through a staging row in
// shared memory and each lane writes the aligned vector of its last pixels
// and its right neighbour's first, so only the row's two ragged ends go
// pixel by pixel.  A vector that straddles the crop's edge writes only its
// pixels inside it.
//
// The `general` route takes every other geometry the wrapper accepts (a step
// that does not divide the tile, a row of tw not a multiple of 16 bytes, more
// than 16 covering tiles, tiles or a weight off a 16-byte boundary): one
// thread per output element gathers from the tiles that cover it.
// `ptt_grid_merge` picks the route and reports the one it took.
//
// Both routes own each output element in one thread (no atomics; the
// scatter form of the TPU merge would race on a GPU) and sum in tile order
// (a-major, b-minor) with separately rounded products from 0, then divide by
// max(norm, eps): fp32 output equals the slice-add reference bit for bit.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"
#include "tma.cuh"

namespace {

enum DType { kF32 = 0, kBF16 = 1 };
enum Route { kGeneral = 0, kCell = 1 };

template <int D>
struct Elem;
template <>
struct Elem<kF32> {
  using T = float;
};
template <>
struct Elem<kBF16> {
  using T = __nv_bfloat16;
};

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// ---------------------------------------------------------------------------
// The general route: one thread per output element
// ---------------------------------------------------------------------------

template <typename TIn, typename TOut>
__global__ void grid_merge_general_kernel(const TIn* __restrict__ tiles, const float* __restrict__ weight,
                                          TOut* __restrict__ out, float* __restrict__ norm_out, int channels,
                                          int th, int tw, int ty, int tx, int sh, int sw, int out_h, int out_w,
                                          int off_y, int off_x, int normalize, float eps) {
  const int64_t total = (int64_t)channels * out_h * out_w;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += stride) {
    const int x = (int)(i % out_w);
    const int64_t r = i / out_w;
    const int y = (int)(r % out_h);
    const int k = (int)(r / out_h);
    const int Y = y + off_y;
    const int X = x + off_x;
    // tile a covers canvas rows [a*sh, a*sh + th)
    const int a_lo = Y >= th ? (Y - th) / sh + 1 : 0;
    const int a_hi = min(Y / sh, ty - 1);
    const int b_lo = X >= tw ? (X - tw) / sw + 1 : 0;
    const int b_hi = min(X / sw, tx - 1);
    float acc = 0.0f;
    float nrm = 0.0f;
    for (int a = a_lo; a <= a_hi; ++a) {
      const int ly = Y - a * sh;
      for (int b = b_lo; b <= b_hi; ++b) {
        const int lx = X - b * sw;
        const float w = weight[ly * tw + lx];
        const int64_t t = (int64_t)a * tx + b;
        const float v = load_f32(tiles + ((t * channels + k) * th + ly) * (int64_t)tw + lx);
        acc = __fadd_rn(acc, __fmul_rn(v, w));
        nrm = __fadd_rn(nrm, w);
      }
    }
    if (normalize) {
      store_f32(out + i, __fdiv_rn(acc, fmaxf(nrm, eps)));
    } else {
      store_f32(out + i, acc);
      if (norm_out != nullptr && k == 0) norm_out[(int64_t)y * out_w + x] = nrm;
    }
  }
}

// ---------------------------------------------------------------------------
// The cell route
// ---------------------------------------------------------------------------

// The rectangle's shape and the ring's depth were chosen by timing variants at the main path's shape
// on the H100: rows of 512 bytes beat rows of 256, and 4 blocks of 2 stages per SM beat 2 of 4 and 1 of 6-8.
constexpr int BY = 8;                   // rows of a position's rectangle
constexpr int BX = 128;                 // columns: one TMA box row of 512 (fp32) or 256 (bf16) bytes
constexpr int GX = BX / 4;              // 4-pixel vectors per row
constexpr int CONSUMERS = BY * GX;      // 256 threads, one vector each
constexpr int MAX_TILES = 16;           // covering tiles of a cell: kh * kw
constexpr int MAX_STAGES = 4;
constexpr int SMEM_TARGET = 56 * 1024;  // a block's shared memory where the ring allows it

struct CellParams {
  const float* weight;
  void* out;
  float* norm_out;
  int channels, th, tw, ty, tx, sh, sw, kh, kw;
  int out_h, out_w, off_y, off_x, normalize;
  float eps;
  int ci0, cj0, ncx, ncells;  // the cells that meet the crop: ncells of them, ncx to a row, from (ci0, cj0)
  int npx;                    // positions (rectangles) per cell along x
  int stages;                 // ring stages
  uint32_t box_bytes;         // one tile rectangle: BY x BX elements
};

// A cell of the lattice as one position of it sees it: its coordinates and
// the range of the tiles that cover it.  False where the position's
// rectangle has no pixel inside the crop: the producer and the consumers
// skip the same cells.
struct CellView {
  int ci, cj, a_lo, a_hi, b_lo, b_hi;
};

__device__ __forceinline__ bool view_cell(const CellParams& p, int cell, int py, int px, CellView& v) {
  v.ci = p.ci0 + cell / p.ncx;
  v.cj = p.cj0 + cell % p.ncx;
  const int y0 = v.ci * p.sh + py * BY, x0 = v.cj * p.sw + px * BX;
  const int y1 = min(y0 + BY, (v.ci + 1) * p.sh), x1 = min(x0 + BX, (v.cj + 1) * p.sw);
  if (max(y0, p.off_y) >= min(y1, p.off_y + p.out_h) || max(x0, p.off_x) >= min(x1, p.off_x + p.out_w))
    return false;
  v.a_lo = max(0, v.ci - p.kh + 1);
  v.a_hi = min(v.ci, p.ty - 1);
  v.b_lo = max(0, v.cj - p.kw + 1);
  v.b_hi = min(v.cj, p.tx - 1);
  return true;
}

// 4 bf16 values as fp32, exactly: a bf16's bits are the top half of a float's
__device__ __forceinline__ float4 widen(uint2 u) {
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u), __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}
// 4 consecutive elements as fp32
__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) { return widen(*reinterpret_cast<const uint2*>(p)); }

// the output is written once: streaming stores, evicted first from L2
__device__ __forceinline__ void store4(float* p, float4 v) { __stcs(reinterpret_cast<float4*>(p), v); }
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  __stcs(reinterpret_cast<uint2*>(p), u);
}

__device__ __forceinline__ float at(const float4& v, int j) { return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w; }

// acc += v * w and nrm += w, each product and sum rounded on its own (no FMA), as the slice-adds do
__device__ __forceinline__ void madd4(float4& acc, const float4& v, const float4& w) {
  acc.x = __fadd_rn(acc.x, __fmul_rn(v.x, w.x));
  acc.y = __fadd_rn(acc.y, __fmul_rn(v.y, w.y));
  acc.z = __fadd_rn(acc.z, __fmul_rn(v.z, w.z));
  acc.w = __fadd_rn(acc.w, __fmul_rn(v.w, w.w));
}
__device__ __forceinline__ void add4(float4& acc, const float4& w) {
  acc.x = __fadd_rn(acc.x, w.x);
  acc.y = __fadd_rn(acc.y, w.y);
  acc.z = __fadd_rn(acc.z, w.z);
  acc.w = __fadd_rn(acc.w, w.w);
}

// TMA: one box of the 3-D tensor map [N * K, th, tw] (coordinates innermost first).
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int c0, int c1, int c2,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// Writes pixels p = 0..3 of v at p (mask bit j: pixel j lies inside the crop): one vector store where p is
// a vector's boundary and all 4 pixels are inside, else those pixels that are.
template <typename T>
__device__ __forceinline__ void put4(T* p, const float4& v, int mask) {
  if (mask == 0xf && (reinterpret_cast<uintptr_t>(p) / sizeof(T)) % 4 == 0) {
    store4(p, v);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (mask >> j & 1) store_f32(p + j, at(v, j));
  }
}

// Writes this lane's 4 pixels (of the output or the norm) at p.  The 32 lanes of the warp hold 128
// consecutive pixels of one row, 4 each.  Where p lies s pixels past a vector's boundary (the same s in
// every lane), the row goes through the warp's staging row in shared memory (BX + 4 floats): lane l writes
// the aligned vector at p + 4 - s, its own last s pixels and lane l + 1's first 4 - s, and lane 0 its
// first 4 - s pixels one by one, so only the row's two ends go pixel by pixel.  Every lane of the warp
// calls it.
template <typename T>
__device__ __forceinline__ void write4(T* p, const float4& v, int mask, float* row, int lane) {
  const int s = (int)((reinterpret_cast<uintptr_t>(p) / sizeof(T)) % 4);
  if (s == 0) {
    put4(p, v, mask);
    return;
  }
  const int right = __shfl_down_sync(0xffffffffu, mask, 1);
  reinterpret_cast<float4*>(row)[lane] = v;
  __syncwarp();
  const float* q = row + 4 * lane + 4 - s;  // lane 31 reads past the row's 128 pixels: masked off
  const int c_mask = (mask >> (4 - s) | (lane == 31 ? 0 : right) << s) & 0xf;
  put4(p + 4 - s, make_float4(q[0], q[1], q[2], q[3]), c_mask);
  if (lane == 0)
    for (int j = 0; j < 4 - s; ++j)
      if (mask >> j & 1) store_f32(p + j, row[j]);
  __syncwarp();  // the row is read before the next call writes it
}

// 4 blocks per SM (56 registers a thread): the ring's bytes in flight at the main path's shape
template <int IN, int OUT>
__global__ void __launch_bounds__(CONSUMERS + 32, 4)
    grid_merge_cell_kernel(const __grid_constant__ CUtensorMap map, const CellParams p) {
  using TIn = typename Elem<IN>::T;
  using TOut = typename Elem<OUT>::T;
  extern __shared__ unsigned char smem_raw[];
  // [weights: nt rectangles, fp32][ring: stages x nt rectangles][full, empty barriers][staging rows]
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const int nt = p.kh * p.kw;
  const float* wsm = reinterpret_cast<const float*>(smem);
  const uint32_t wbytes = (uint32_t)nt * BY * BX * 4;
  const uint32_t stage_bytes = (uint32_t)nt * p.box_bytes;
  const uint32_t ring = base + wbytes;
  const uint32_t full = ring + p.stages * stage_bytes, empty = full + 8 * MAX_STAGES;
  float* row = reinterpret_cast<float*>(smem + (empty + 8 * MAX_STAGES - base)) + threadIdx.x / 32 * (BX + 4);
  const int py = blockIdx.x / p.npx, px = blockIdx.x % p.npx;

  // This position's weights, once: rectangle (da, db) holds rows da*sh + py*BY + [0, BY) and columns
  // db*sw + px*BX + [0, BX) of the window (zeros past its edge: those pixels lie in no cell of this position).
  for (int i = threadIdx.x; i < nt * CONSUMERS; i += blockDim.x) {
    const int q = i / CONSUMERS, r = i % CONSUMERS / GX, g = i % GX;
    const int wy = q / p.kw * p.sh + py * BY + r, wx = q % p.kw * p.sw + px * BX + 4 * g;
    float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
    if (wy < p.th && wx < p.tw) w = *reinterpret_cast<const float4*>(p.weight + (int64_t)wy * p.tw + wx);
    reinterpret_cast<float4*>(smem)[i] = w;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full + 8 * s, 1);                    // the producer's expect_tx
      mbar_init(empty + 8 * s, CONSUMERS / 32);      // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // Producer: one lane issues the covering tiles' boxes of each (cell, channel), in the consumers' order.
    if (threadIdx.x != CONSUMERS) return;
    int stage = 0, uses = 0;
    for (int cell = blockIdx.y; cell < p.ncells; cell += gridDim.y) {
      CellView v;
      if (!view_cell(p, cell, py, px, v)) continue;
      const uint32_t bytes = (uint32_t)((v.a_hi - v.a_lo + 1) * (v.b_hi - v.b_lo + 1)) * p.box_bytes;
      for (int k = 0; k < p.channels; ++k) {
        if (uses > 0) mbar_wait(empty + 8 * stage, (uses - 1) & 1);
        mbar_expect_tx(full + 8 * stage, bytes);
        uint32_t dst = ring + stage * stage_bytes;
        for (int a = v.a_lo; a <= v.a_hi; ++a)
          for (int b = v.b_lo; b <= v.b_hi; ++b, dst += p.box_bytes)
            tma_load_3d(dst, &map, (v.cj - b) * p.sw + px * BX, (v.ci - a) * p.sh + py * BY,
                        (a * p.tx + b) * p.channels + k, full + 8 * stage);
        if (++stage == p.stages) {
          stage = 0;
          ++uses;
        }
      }
    }
    return;
  }

  // Consumers: thread (r, g) owns pixels [4g, 4g + 4) of row r of the rectangle; warp r holds row r.
  const int r = threadIdx.x / GX, c = 4 * (threadIdx.x % GX);
  const int lane = threadIdx.x % 32;
  const int ry = py * BY + r, rx = px * BX + c;  // offsets inside the cell
  int stage = 0, uses = 0;
  for (int cell = blockIdx.y; cell < p.ncells; cell += gridDim.y) {
    CellView v;
    if (!view_cell(p, cell, py, px, v)) continue;
    const int Y = v.ci * p.sh + ry, X = v.cj * p.sw + rx;
    const bool row_in = ry < p.sh && Y >= p.off_y && Y < p.off_y + p.out_h;
    int mask = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      mask |= (row_in && rx + j < p.sw && X + j >= p.off_x && X + j < p.off_x + p.out_w) << j;
    // channel k's pixels, advanced a plane per channel
    TOut* dst = static_cast<TOut*>(p.out) + ((int64_t)(Y - p.off_y) * p.out_w + (X - p.off_x));
    // the norm, floored at eps where the output is divided by it
    float4 nrm = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int a = v.a_lo; a <= v.a_hi; ++a)
      for (int b = v.b_lo; b <= v.b_hi; ++b)
        add4(nrm, load4(wsm + ((v.ci - a) * p.kw + (v.cj - b)) * (BY * BX) + r * BX + c));
    if (p.normalize)
      nrm = make_float4(fmaxf(nrm.x, p.eps), fmaxf(nrm.y, p.eps), fmaxf(nrm.z, p.eps), fmaxf(nrm.w, p.eps));

    for (int k = 0; k < p.channels; ++k) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      mbar_wait(full + 8 * stage, uses & 1);
      const TIn* box = reinterpret_cast<const TIn*>(smem + (ring - base) + stage * stage_bytes) + r * BX + c;
      for (int a = v.a_lo; a <= v.a_hi; ++a)
        for (int b = v.b_lo; b <= v.b_hi; ++b, box += BY * BX)
          madd4(acc, load4(box), load4(wsm + ((v.ci - a) * p.kw + (v.cj - b)) * (BY * BX) + r * BX + c));
      mbar_arrive_warp(empty + 8 * stage, lane);
      if (++stage == p.stages) {
        stage = 0;
        ++uses;
      }
      if (p.normalize) {
        const float4 q = make_float4(__fdiv_rn(acc.x, nrm.x), __fdiv_rn(acc.y, nrm.y), __fdiv_rn(acc.z, nrm.z),
                                     __fdiv_rn(acc.w, nrm.w));
        write4(dst, q, mask, row, lane);
      } else {
        write4(dst, acc, mask, row, lane);
        if (k == 0 && p.norm_out != nullptr)
          write4(p.norm_out + (dst - static_cast<TOut*>(p.out)), nrm, mask, row, lane);
      }
      dst += (int64_t)p.out_h * p.out_w;
    }
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

template <typename TIn, typename TOut>
cudaError_t launch_general(const void* tiles, const float* weight, void* out, float* norm_out, int channels, int th,
                           int tw, int ty, int tx, int sh, int sw, int out_h, int out_w, int off_y, int off_x,
                           int normalize, float eps, cudaStream_t stream) {
  const int64_t total = (int64_t)channels * out_h * out_w;
  const int threads = 256;
  const int64_t want = (total + threads - 1) / threads;
  const int blocks = (int)(want < 132 * 64 ? want : 132 * 64);
  grid_merge_general_kernel<TIn, TOut><<<blocks, threads, 0, stream>>>(
      static_cast<const TIn*>(tiles), weight, static_cast<TOut*>(out), norm_out, channels, th, tw, ty, tx, sh, sw,
      out_h, out_w, off_y, off_x, normalize, eps);
  return cudaGetLastError();
}

typedef void (*CellKernel)(CUtensorMap, CellParams);

CellKernel cell_kernel(int tiles_dtype, int out_dtype) {
  switch (tiles_dtype * 2 + out_dtype) {
    case 0: return grid_merge_cell_kernel<kF32, kF32>;
    case 1: return grid_merge_cell_kernel<kF32, kBF16>;
    case 2: return grid_merge_cell_kernel<kBF16, kF32>;
    default: return grid_merge_cell_kernel<kBF16, kBF16>;
  }
}

// A cell-route block: its threads, ring stages and dynamic shared memory, and
// how many of them an SM holds.
struct CellShape {
  CellKernel kernel;
  int threads, stages, smem, per_sm;
};

cudaError_t cell_shape(int tiles_dtype, int out_dtype, int kh, int kw, CellShape& c) {
  const int64_t es = tiles_dtype == kF32 ? 4 : 2;
  const int64_t wbytes = (int64_t)kh * kw * BY * BX * 4, stage_bytes = (int64_t)kh * kw * BY * BX * es;
  const int64_t stages = (SMEM_TARGET - 1024 - wbytes) / stage_bytes;
  c.stages = stages < 2 ? 2 : stages > MAX_STAGES ? MAX_STAGES : (int)stages;
  c.kernel = cell_kernel(tiles_dtype, out_dtype);
  c.threads = CONSUMERS + 32;
  c.smem = (int)(1024 + wbytes + c.stages * stage_bytes + 16 * MAX_STAGES + CONSUMERS / 32 * (BX + 4) * 4);
  cudaError_t err = cudaFuncSetAttribute(c.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, c.smem);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&c.per_sm, c.kernel, c.threads, c.smem);
  if (err == cudaSuccess && c.per_sm < 1) err = cudaErrorInvalidConfiguration;
  return err;
}

// The one rule for the route: the cell route takes a geometry whose steps divide the tile with at most
// MAX_TILES covering tiles, whose step is a whole number of 4-pixel vectors, whose tile rows are whole
// 16-byte units (the tensor map's strides), and whose tiles and weight start on 16-byte boundaries, with
// the tile planes and the cells meeting the crop each counted in an int.
bool cell_takes(const void* tiles, int tiles_dtype, const float* weight, int channels, int th, int tw, int ty,
                int tx, int sh, int sw, int out_h, int out_w, int off_y, int off_x) {
  const int es = tiles_dtype == kF32 ? 4 : 2;
  if (th % sh || tw % sw || sw % 4 || (tw * es) % 16 || (int64_t)(th / sh) * (tw / sw) > MAX_TILES ||
      (int64_t)ty * tx * channels > 0x7fffffffLL || (reinterpret_cast<uintptr_t>(tiles) & 15) ||
      (reinterpret_cast<uintptr_t>(weight) & 15))
    return false;
  const int64_t rows = (off_y + out_h - 1) / sh - off_y / sh + 1, cols = (off_x + out_w - 1) / sw - off_x / sw + 1;
  return rows * cols <= 0x7fffffffLL;
}

// The cell route's launch (on a geometry cell_takes): makes the tiles' tensor map and sizes the grid.
int grid_merge_cell(int device, const void* tiles, int tiles_dtype, const float* weight, void* out, int out_dtype,
                    float* norm_out, int channels, int th, int tw, int ty, int tx, int sh, int sw, int out_h,
                    int out_w, int off_y, int off_x, int normalize, float eps, cudaStream_t stream) {
  const int es = tiles_dtype == kF32 ? 4 : 2;
  const int kh = th / sh, kw = tw / sw;
  const int64_t planes = (int64_t)ty * tx * channels;
  CellParams p;
  p.weight = weight;
  p.out = out;
  p.norm_out = norm_out;
  p.channels = channels;
  p.th = th;
  p.tw = tw;
  p.ty = ty;
  p.tx = tx;
  p.sh = sh;
  p.sw = sw;
  p.kh = kh;
  p.kw = kw;
  p.out_h = out_h;
  p.out_w = out_w;
  p.off_y = off_y;
  p.off_x = off_x;
  p.normalize = normalize;
  p.eps = eps;
  p.ci0 = off_y / sh;
  p.cj0 = off_x / sw;
  p.ncx = (off_x + out_w - 1) / sw - p.cj0 + 1;
  p.ncells = (int)((int64_t)((off_y + out_h - 1) / sh - p.ci0 + 1) * p.ncx);
  p.npx = (sw + BX - 1) / BX;
  p.box_bytes = (uint32_t)(BY * BX * es);
  CellShape c;
  cudaError_t err = cell_shape(tiles_dtype, out_dtype, kh, kw, c);
  if (err != cudaSuccess) return (int)err;
  p.stages = c.stages;

  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  // the tile stack [N * K, th, tw], innermost first; a box is one position's rectangle of one tile plane
  CUtensorMap map = {};
  const cuuint64_t dims[3] = {(cuuint64_t)tw, (cuuint64_t)th, (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)tw * es, (cuuint64_t)th * tw * es};
  const cuuint32_t box[3] = {BX, BY, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  if (encode(&map, tiles_dtype == kF32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
             const_cast<void*>(tiles), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  // one block per position, times as many groups of cells as the card holds at once
  int sms = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) return (int)err;
  const int positions = ((sh + BY - 1) / BY) * p.npx;
  int groups = sms * c.per_sm / positions;
  groups = groups < 1 ? 1 : groups > p.ncells ? p.ncells : groups > 65535 ? 65535 : groups;
  void* args[2] = {&map, &p};
  err = cudaLaunchKernel(reinterpret_cast<const void*>(c.kernel), dim3(positions, groups), dim3(c.threads), args,
                         (size_t)c.smem, stream);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

// Picks the route (cell_takes) and writes the one it launched to *route: 0 general, 1 cell.
extern "C" int ptt_grid_merge(int device, const void* tiles, int tiles_dtype, const void* weight, void* out,
                              int out_dtype, void* norm_out, int channels, int th, int tw, int ty, int tx, int sh,
                              int sw, int out_h, int out_w, int off_y, int off_x, int normalize, float eps,
                              int* route, void* stream) {
  const ptt::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  if (channels <= 0 || th <= 0 || tw <= 0 || ty <= 0 || tx <= 0 || sh <= 0 || sw <= 0 || out_h <= 0 ||
      out_w <= 0 || off_y < 0 || off_x < 0 || (tiles_dtype != kF32 && tiles_dtype != kBF16) ||
      (out_dtype != kF32 && out_dtype != kBF16) || route == nullptr)
    return (int)cudaErrorInvalidValue;
  const float* w = static_cast<const float*>(weight);
  float* n = static_cast<float*>(norm_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  *route = cell_takes(tiles, tiles_dtype, w, channels, th, tw, ty, tx, sh, sw, out_h, out_w, off_y, off_x) ? kCell
                                                                                                            : kGeneral;
  if (*route == kCell)
    return grid_merge_cell(device, tiles, tiles_dtype, w, out, out_dtype, n, channels, th, tw, ty, tx, sh, sw,
                           out_h, out_w, off_y, off_x, normalize, eps, s);
  cudaError_t err;
  if (tiles_dtype == kF32 && out_dtype == kF32)
    err = launch_general<float, float>(tiles, w, out, n, channels, th, tw, ty, tx, sh, sw, out_h, out_w, off_y,
                                       off_x, normalize, eps, s);
  else if (tiles_dtype == kF32)
    err = launch_general<float, __nv_bfloat16>(tiles, w, out, n, channels, th, tw, ty, tx, sh, sw, out_h, out_w,
                                               off_y, off_x, normalize, eps, s);
  else if (out_dtype == kF32)
    err = launch_general<__nv_bfloat16, float>(tiles, w, out, n, channels, th, tw, ty, tx, sh, sw, out_h, out_w,
                                               off_y, off_x, normalize, eps, s);
  else
    err = launch_general<__nv_bfloat16, __nv_bfloat16>(tiles, w, out, n, channels, th, tw, ty, tx, sh, sw, out_h,
                                                       out_w, off_y, off_x, normalize, eps, s);
  return (int)err;
}

// The cell route's block at kh x kw covering tiles: info[0..5] = threads, ring stages, dynamic shared
// bytes, blocks resident per SM, rectangle rows, rectangle columns.
extern "C" int ptt_grid_merge_cell_info(int device, int tiles_dtype, int out_dtype, int kh, int kw, int* info) {
  const ptt::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  if ((tiles_dtype != kF32 && tiles_dtype != kBF16) || (out_dtype != kF32 && out_dtype != kBF16) || kh < 1 ||
      kw < 1 || kh * kw > MAX_TILES)
    return (int)cudaErrorInvalidValue;
  CellShape c;
  const cudaError_t err = cell_shape(tiles_dtype, out_dtype, kh, kw, c);
  const int values[6] = {c.threads, c.stages, c.smem, c.per_sm, BY, BX};
  for (int i = 0; i < 6 && err == cudaSuccess; ++i) info[i] = values[i];
  return (int)err;
}

extern "C" const char* ptt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }
