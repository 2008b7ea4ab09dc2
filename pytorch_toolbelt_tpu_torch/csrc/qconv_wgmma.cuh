// Device helpers shared by Q1's wgmma kernels (qconv_wgmma.cu: the 3x3
// stride-1 convs; qconv_gemm.cu: the 1x1 and grouped 3x3 convs): the s8
// wgmma instructions and their operand descriptors, TMA loads and stores, the
// swizzled staging of int8 rows, and the integer requant epilogue into a
// swizzled shared-memory output tile.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"

namespace {

constexpr int CK = 128;                         // input channels (bytes) per full K chunk
constexpr int CONSUMERS = 2;                    // consumer warpgroups
constexpr int THREADS = (CONSUMERS + 1) * 128;  // and the producer warpgroup
constexpr int MAX_HALO_STAGES = 8;
constexpr int MAX_W_SLOTS = 64;
constexpr int BAR_BYTES = 2048;     // (MAX_HALO_STAGES + MAX_W_SLOTS) full/empty pairs: 1152 bytes
constexpr int SMEM_LIMIT = 232448;  // the 227 KB a block may opt into
constexpr int MUL_SHIFT = 23;

// Registers per thread after setmaxnreg: 128 * P + 256 * C <= 384 * 168.
template <bool TMA>
struct Regs;
template <>
struct Regs<true> {
  static constexpr int producer = 40, consumer = 232;
};
template <>
struct Regs<false> {
  static constexpr int producer = 56, consumer = 224;
};

// The K chunks of C_in: `full` chunks of 128 channels, then at most two
// narrow ones (64 then 32 channels).
struct Chunks {
  int count, full, tail;  // all chunks; the 128-channel ones; the first narrow one's width (0: none)
  __host__ __device__ int width(int kc) const { return kc < full ? CK : kc == full ? tail : 32; }
  __host__ __device__ int first(int kc) const { return kc <= full ? kc * CK : full * CK + 64; }
};

Chunks chunks_of(int cin) {
  Chunks c;
  c.full = cin / CK;
  int r = cin % CK;
  if (r > 96) {
    c.full += 1;
    r = 0;
  }
  c.tail = r == 0 ? 0 : r > 32 ? 64 : 32;
  c.count = c.full + (r == 0 ? 0 : r > 64 ? 2 : 1);
  return c;
}

__device__ __forceinline__ int wrap_add(int a, int b) { return (int)((unsigned)a + (unsigned)b); }
__device__ __forceinline__ int wrap_mul(int a, int b) { return (int)((unsigned)a * (unsigned)b); }

// The int8 requant of one accumulator, as qconv.cu's: MODE 1 "shift", 2
// "mul", both compiled for each value of RELU, so that no value pays for the
// other mode's instructions.  PTX shr clamps a shift past 31 to 32, which
// leaves the sign, as the reference's >> does.
template <int MODE, bool RELU>
__device__ __forceinline__ int requant(int acc, int b, int q0, int q1) {
  int v = wrap_add(acc, b);
  if (RELU) v = max(v, 0);
  if (MODE == 1) {
    v = wrap_add(v, q0);
    asm("shr.s32 %0, %0, %1;" : "+r"(v) : "r"(q1));
  } else {
    v = max(-q1, min(q1, v));
    v = wrap_add(wrap_mul(v, q0), 1 << (MUL_SHIFT - 1)) >> MUL_SHIFT;
  }
  return max(-127, min(127, v));
}

// The same with the mode and ReLU read at run time: for the register-store
// epilogue (int32 output, C_out % 16 != 0) and the tile epilogue at N = 256.
__device__ __forceinline__ int requant_rt(int acc, int b, int q0, int q1, int mode, int relu) {
  int v = wrap_add(acc, b);
  if (relu) v = max(v, 0);
  if (mode == 1) {
    v = wrap_add(v, q0);
    asm("shr.s32 %0, %0, %1;" : "+r"(v) : "r"(q1));
  } else {
    v = max(-q1, min(q1, v));
    v = wrap_add(wrap_mul(v, q0), 1 << (MUL_SHIFT - 1)) >> MUL_SHIFT;
  }
  return max(-127, min(127, v));
}

// Two per-channel operands.  A volatile load stays where it is written, so
// the epilogue's loads are not all hoisted into registers at once.
__device__ __forceinline__ int2 ld_pair(const int* p) {
  int2 v;
  asm volatile("ld.global.nc.v2.s32 {%0, %1}, [%2];" : "=r"(v.x), "=r"(v.y) : "l"(p));
  return v;
}

// TMA: one box of the 4-D tensor map [B, H, W, C] (coordinates innermost first).
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, int c0, int c1, int c2, int c3,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], "
      "[%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// TMA bulk copy of contiguous bytes (a packed weight slab).
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(dst),
               "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ void st_shared_u16(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u16 [%0], %1;" ::"r"(addr), "h"((unsigned short)v) : "memory");
}

// TMA store of one box of the 4-D output map, issued (and committed as a bulk
// group) by the threads whose `pred` is set; the predicate stays in the asm.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0, int c1, int c2, int c3,
                                             bool pred) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.u32 p, %6, 0;\n"
      "@p cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n"
      "@p cp.async.bulk.commit_group;\n}\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"((uint32_t)pred)
      : "memory");
}

// Wait until this thread's TMA stores have read their shared memory.
__device__ __forceinline__ void tma_store_wait_read(bool pred) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.u32 p, %0, 0;\n"
      "@p cp.async.bulk.wait_group.read 0;\n}\n" ::"r"((uint32_t)pred)
      : "memory");
}

__device__ __forceinline__ void consumer_barrier() {
  asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS * 128) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the wgmma fences.
template <int N>
__device__ __forceinline__ void fence_operands(int* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// wgmma shared-memory descriptor of a K-major operand with the 128-byte swizzle:
// rows of 128 bytes, 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// wgmma m64nNk32, s32 += s8 x s8, A from registers, B K-major by descriptor.
template <int N>
struct Wgmma;

template <>
struct Wgmma<8> {
  __device__ __forceinline__ static void mma(int* d, const uint32_t* a, uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 "
        "{%0, %1, %2, %3},"
        " {%4, %5, %6, %7}, %8, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<16> {
  __device__ __forceinline__ static void mma(int* d, const uint32_t* a, uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7},"
        " {%8, %9, %10, %11}, %12, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<32> {
  __device__ __forceinline__ static void mma(int* d, const uint32_t* a, uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15},"
        " {%16, %17, %18, %19}, %20, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void mma(int* d, const uint32_t* a, uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
        " {%32, %33, %34, %35}, %36, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  __device__ __forceinline__ static void mma(int* d, const uint32_t* a, uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
        " {%64, %65, %66, %67}, %68, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<256> {
  __device__ __forceinline__ static void mma(int* d, const uint32_t* a, uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
        " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
        " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
        " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127},"
        " {%128, %129, %130, %131}, %132, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
          "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
          "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
          "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
          "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
          "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
          "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
          "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
          "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

// The byte offset of 16-byte group g of staged pixel q, in rows of RB bytes
// (128, 64 or 32) with the RB-byte swizzle, which is what TMA writes for a
// box of RB channels.
template <int RB>
__device__ __forceinline__ uint32_t staged(int q, int g) {
  if constexpr (RB == 128) return q * 128 + ((g ^ (q & 7)) << 4);
  if constexpr (RB == 64) return q * 64 + ((g ^ ((q >> 1) & 3)) << 4);
  return q * 32 + ((g ^ ((q >> 2) & 1)) << 4);
}

__device__ __forceinline__ uint32_t staged_rt(int rb, int q, int g) {
  return rb == CK ? staged<128>(q, g) : rb == 64 ? staged<64>(q, g) : staged<32>(q, g);
}

// The byte offset of channel c of tile pixel px in the staged output tile of
// P pixels: rows of RB = min(NT, 128) bytes with the RB-byte swizzle (none at
// 16 bytes), the channels from 128 on (NT = 256) in a second [P, 128] box.
// The swizzle spreads the rows a warp writes over the banks.
template <int NT, int P>
__device__ __forceinline__ uint32_t out_at(int px, int c) {
  constexpr int RB = NT > 128 ? 128 : NT;
  const uint32_t box = (uint32_t)(c / RB) * (P * RB);
  c %= RB;
  if constexpr (RB == 128) return box + px * 128 + (((c >> 4) ^ (px & 7)) << 4) + (c & 15);
  if constexpr (RB == 64) return box + px * 64 + (((c >> 4) ^ ((px >> 1) & 3)) << 4) + (c & 15);
  if constexpr (RB == 32) return box + px * 32 + (((c >> 4) ^ ((px >> 2) & 1)) << 4) + (c & 15);
  return box + px * RB + c;
}

// The requantized int8 tile into shared memory, two channels per store, the
// mode and ReLU compiled in (MODE 1, 2) or read at run time (MODE 0: at
// N = 256, whose 128 accumulator registers leave no room for four copies).
// The operands of the next 8-channel group are loaded while this one is
// stored, where the registers allow it.
template <int NT, int MW, int MODE, bool RELU, class Par>
__device__ __forceinline__ void tile_to_smem(const int (&acc)[MW][NT / 2], const Par& p, uint32_t obuf, int nb,
                                             int g, int wi, int lane) {
  constexpr bool PREFETCH = NT < 256;
  const int q4 = lane & 3;
  const int co0 = nb * NT + 2 * q4;
  int2 b2 = ld_pair(p.bias + min(co0, p.cout - 2)), x2 = ld_pair(p.p0 + min(co0, p.cout - 2)),
       y2 = ld_pair(p.p1 + min(co0, p.cout - 2));
#pragma unroll
  for (int j = 0; j < NT / 8; ++j) {
    int2 nb2 = b2, nx2 = x2, ny2 = y2;
    if (PREFETCH && j + 1 < NT / 8) {
      const int co = min(co0 + 8 * (j + 1), p.cout - 2);  // past C_out: not stored
      nb2 = ld_pair(p.bias + co), nx2 = ld_pair(p.p0 + co), ny2 = ld_pair(p.p1 + co);
    }
#pragma unroll
    for (int i = 0; i < MW; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int a0 = acc[i][4 * j + 2 * h], a1 = acc[i][4 * j + 2 * h + 1];
        int v0, v1;
        if constexpr (MODE == 0) {
          v0 = requant_rt(a0, b2.x, x2.x, y2.x, p.mode, p.relu);
          v1 = requant_rt(a1, b2.y, x2.y, y2.y, p.mode, p.relu);
        } else {
          v0 = requant<MODE, RELU>(a0, b2.x, x2.x, y2.x);
          v1 = requant<MODE, RELU>(a1, b2.y, x2.y, y2.y);
        }
        const int px = (g * MW + i) * 64 + 16 * wi + (lane >> 2) + 8 * h;  // pixel of the tile
        st_shared_u16(obuf + out_at<NT, CONSUMERS * MW * 64>(px, 8 * j + 2 * q4), __byte_perm(v0, v1, 0x0040));
      }
    }
    if (PREFETCH) {
      b2 = nb2, x2 = nx2, y2 = ny2;
    } else if (j + 1 < NT / 8) {
      const int co = min(co0 + 8 * (j + 1), p.cout - 2);
      b2 = ld_pair(p.bias + co), x2 = ld_pair(p.p0 + co), y2 = ld_pair(p.p1 + co);
    }
  }
}


// The requantized int8 tile into the staged output buffer: tile_to_smem with
// the mode and ReLU compiled in, but at N = 256 (read at run time there).
template <int NT, int MW, class Par>
__device__ __forceinline__ void requant_tile(const int (&acc)[MW][NT / 2], const Par& p, uint32_t obuf, int nb,
                                             int g, int wi, int lane) {
  if constexpr (NT == 256) {
    tile_to_smem<NT, MW, 0, false>(acc, p, obuf, nb, g, wi, lane);
  } else if (p.mode == 1) {
    if (p.relu)
      tile_to_smem<NT, MW, 1, true>(acc, p, obuf, nb, g, wi, lane);
    else
      tile_to_smem<NT, MW, 1, false>(acc, p, obuf, nb, g, wi, lane);
  } else {
    if (p.relu)
      tile_to_smem<NT, MW, 2, true>(acc, p, obuf, nb, g, wi, lane);
    else
      tile_to_smem<NT, MW, 2, false>(acc, p, obuf, nb, g, wi, lane);
  }
}

// The epilogue for int32 output ("acc") and for int8 rows that are not whole
// 16-byte units: two channels per store from registers.  pixel(i, h) gives
// the (row, column) in image b of [H, W] of accumulator row tile i, half h.
template <int NT, int MW, class Par, class Pixel>
__device__ __forceinline__ void store_from_registers(const int (&acc)[MW][NT / 2], const Par& p, int b, int nb, int H,
                                                     int W, int lane, Pixel pixel) {
  const int q4 = lane & 3;
#pragma unroll
  for (int j = 0; j < NT / 8; ++j) {
    const int co = nb * NT + 8 * j + 2 * q4;
    if (co >= p.cout) continue;
    const bool two = co + 1 < p.cout, pair = two && p.cout % 2 == 0;
    int b0 = 0, b1 = 0, x0 = 0, x1 = 0, y0 = 0, y1 = 0;
    if (p.mode != 0) {
      b0 = __ldg(p.bias + co), x0 = __ldg(p.p0 + co), y0 = __ldg(p.p1 + co);
      if (two) b1 = __ldg(p.bias + co + 1), x1 = __ldg(p.p0 + co + 1), y1 = __ldg(p.p1 + co + 1);
    }
#pragma unroll
    for (int i = 0; i < MW; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int2 px = pixel(i, h);
        if (px.x >= H || px.y >= W) continue;
        const size_t at = (((size_t)b * H + px.x) * W + px.y) * p.cout + co;
        const int a0 = acc[i][4 * j + 2 * h], a1 = acc[i][4 * j + 2 * h + 1];
        if (p.mode == 0) {
          int* out = static_cast<int*>(p.y) + at;
          if (pair) {
            *reinterpret_cast<int2*>(out) = make_int2(a0, a1);
          } else {
            out[0] = a0;
            if (two) out[1] = a1;
          }
        } else {
          int8_t* out = static_cast<int8_t*>(p.y) + at;
          const int v0 = requant_rt(a0, b0, x0, y0, p.mode, p.relu);
          const int v1 = two ? requant_rt(a1, b1, x1, y1, p.mode, p.relu) : 0;
          if (pair) {
            *reinterpret_cast<uint16_t*>(out) = (uint16_t)((v0 & 0xff) | ((v1 & 0xff) << 8));
          } else {
            out[0] = (int8_t)v0;
            if (two) out[1] = (int8_t)v1;
          }
        }
      }
    }
  }
}

}  // namespace
