// 3x3 convolution, stride 1, zero ("SAME") padding, with the folded
// BatchNorm / ReLU epilogue:  y = relu?(conv3x3(x, W) * scale + bias),
// as a wgmma implicit GEMM for Hopper (sm_90a).  Shared by the two routes:
// conv3x3_wgmma.cu (C_in % 8 == 0: TMA loads the input) and
// conv3x3_wgmma_ld.cu (any C_in: the producer warps load it; a tensor map
// needs 16-byte strides, so the 3-channel stem comes there).
//
// Replaces the TPU kernel pytorch_toolbelt_tpu/ops/conv_kernels.py
// `conv3x3_hcw` (`_conv_kernel`).
//
// Layout: x [B, H, W, C_in] and y [B, H, W, C_out] bf16 (PyTorch's
// channels_last storage of an NCHW tensor); scale and bias [C_out] fp32;
// weights packed by ops/conv_kernels.py as [NB, KC, 9, NT, 64] bf16: N block,
// 64-channel K chunk, tap (3 * dy + dx), output channel, input channel, each
// [NT, 64] slab K-major with the 128-byte swizzle already applied, so that one
// bulk copy puts it in shared memory in the layout a wgmma B descriptor reads.
//
// What bounds it on the H100.  Per output pixel a layer does 18 * C_in * C_out
// FLOP against 2 * (C_in + C_out) bytes of compulsory traffic.  The
// full-resolution and narrow UNet layers (C_in or C_out <= 64) are bound by
// bytes: they must read each input byte about once and compute all of C_out
// for a pixel tile without staging the input again.  The inner layers
// (C_in, C_out >= 128, and the concatenating decoder convs) are bound by
// operations: they need the tensor cores fed at wgmma rate.
//
// Design.  M = output pixels, N = C_out, K = 9 taps x C_in.  A block is
// persistent (one per SM) and walks output tiles of TH rows x 64 pixels x NT
// channels; NT covers all of C_out up to 256, so the input of a pixel tile is
// read once.  Warpgroup 2 is the producer.  For every 64-channel chunk it
// fills one stage of a ring (up to eight) with the (TH + 2) x 66 pixel x 64
// channel halo box in the 128-byte swizzled layout (a last chunk of at most
// 32 channels as 64-byte rows with the 64-byte swizzle, half the bytes): on
// the TMA route one lane issues one TMA load of a box starting at
// (y0 - 1, x0 - 1), and TMA's zero
// fill of out-of-bounds elements is the SAME padding (and the zero padding of
// a ragged last chunk), so the border needs no branch; on the load route its
// 128 threads gather the box with plain loads and write the zeros themselves.
// One lane also issues bulk copies of the weight slabs: where all 9 x KC
// slabs fit beside the halo ring they are loaded once and stay resident
// (C_in <= 64, C_out <= 64); otherwise they stream per tap through a ring of
// slots.  mbarriers carry the full / empty hand-offs.  Warpgroups 0 and 1 are
// the consumers, each owning MW rows of 64 pixels.  For every tap (dy, dx)
// the A operand is the halo tile shifted by dy rows and dx pixels: ldmatrix
// reads it at the shifted addresses, decoding the swizzle in the address,
// which yields exactly wgmma's register layout for A; B comes from the weight
// slab by descriptor.  A shifted swizzled tile cannot be described to wgmma
// directly, so A from registers is what lets one staged halo serve all nine
// taps.  The A fragments of the next tap are loaded while the current tap's
// wgmmas run, and one group stays in flight across taps.  The epilogue
// applies scale, bias and ReLU in fp32 on the accumulator registers.  On the
// byte-bound layers (N tiles of 32 and 64, C_out % 8 == 0) it writes the bf16
// tile to shared memory with stmatrix and one thread hands it to a TMA store,
// so the consumers start the next tile while the output drains; the other
// layers store 16-byte vectors from registers.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; tma.cuh fetches the driver entry point at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"
#include "tma.cuh"

namespace {

constexpr int TW = 64;                 // output pixels per tile row: one m64 wgmma tile
constexpr int HALO_W = TW + 2;         // pixels per staged halo row
constexpr int CK = 64;                 // input channels per K chunk
constexpr int ROW_BYTES = CK * 2;      // one pixel of a chunk: one 128-byte swizzle row
constexpr int CONSUMERS = 2;           // consumer warpgroups
constexpr int THREADS = (CONSUMERS + 1) * 128;  // and the producer warpgroup
constexpr int MAX_HALO_STAGES = 8;
constexpr int MAX_W_SLOTS = 64;
constexpr int BAR_BYTES = 2048;        // (MAX_HALO_STAGES + MAX_W_SLOTS) full/empty pairs: 1152 bytes
constexpr int SMEM_LIMIT = 232448;     // the 227 KB a block may opt into
constexpr int LD_UNROLL = 4;           // 16-byte groups each producer thread gathers at once (load route)

// Registers per thread after setmaxnreg.  The block starts at 65536 / 384 = 168
// each, and the totals may not exceed that: 128 * P + 256 * C <= 384 * 168.
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

// Rows of 64 pixels each consumer warpgroup owns: fewer as N, and with it
// the accumulator, grows.
__host__ __device__ constexpr int rows_per_warpgroup(int nt) { return nt <= 16 ? 4 : nt <= 128 ? 2 : 1; }

struct Params {
  const __nv_bfloat16* x;  // the load route reads x directly
  const __nv_bfloat16* w;
  const float* scale;
  const float* bias;
  __nv_bfloat16* y;
  int H, W, cin, cout, relu;
  int kc_count, nb_count, tiles_y, tiles_x, tiles;
  int halo_stages, w_slots, resident, tma_store;
  uint32_t halo_stage_bytes, halo_box_bytes, tail_box_bytes, out_bytes;
};

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

__device__ __forceinline__ void st_shared_v4(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};" ::"r"(addr), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
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

__device__ __forceinline__ void stmatrix_x4(uint32_t addr, uint32_t r0, uint32_t r1, uint32_t r2, uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};" ::"r"(addr), "r"(r0), "r"(r1),
               "r"(r2), "r"(r3)
               : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 pair = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&pair);
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
__device__ __forceinline__ void fence_operands(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma shared-memory descriptor of a K-major operand with the 128-byte swizzle:
// rows of 128 bytes, 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// wgmma m64nNk16, fp32 += bf16 x bf16, A from registers, B K-major by descriptor.
template <int N>
struct Wgmma;

template <>
struct Wgmma<8> {
  __device__ __forceinline__ static void mma(float* d, const uint32_t* a, uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3},"
        " {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<16> {
  __device__ __forceinline__ static void mma(float* d, const uint32_t* a, uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7},"
        " {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<32> {
  __device__ __forceinline__ static void mma(float* d, const uint32_t* a, uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15},"
        " {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void mma(float* d, const uint32_t* a, uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
        " {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  __device__ __forceinline__ static void mma(float* d, const uint32_t* a, uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
        " {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<256> {
  __device__ __forceinline__ static void mma(float* d, const uint32_t* a, uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
        " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
        " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
        " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127},"
        " {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};


// Within each quad of lanes, lane q holds w[k] = channels 8k + 2q, 8k + 2q + 1
// of one pixel; afterwards it holds channels 8q .. 8q + 7 (the 4 x 4
// transpose of 32-bit pairs).  Every lane of the warp must call it.
__device__ __forceinline__ uint4 quad_transpose(const uint32_t (&w)[4], int q) {
  uint32_t r0 = 0, r1 = 0, r2 = 0, r3 = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int send = (q + k) & 3, from = (q - k) & 3;  // lane `from` sends its pair of group q
    uint32_t v = send == 0 ? w[0] : send == 1 ? w[1] : send == 2 ? w[2] : w[3];
    v = __shfl_sync(0xffffffffu, v, from, 4);
    r0 = from == 0 ? v : r0;
    r1 = from == 1 ? v : r1;
    r2 = from == 2 ? v : r2;
    r3 = from == 3 ? v : r3;
  }
  return make_uint4(r0, r1, r2, r3);
}

// The byte offset of 16-byte group g of staged pixel q.  A full chunk stages
// 64 channels per pixel in 128-byte rows with the 128-byte swizzle; a chunk of
// at most 32 channels (a "narrow" last chunk) 32 in 64-byte rows with the
// 64-byte swizzle, which is what TMA writes for the two box widths.
template <bool NARROW>
__device__ __forceinline__ uint32_t staged(int q, int g) {
  return NARROW ? q * 64 + ((g ^ ((q >> 1) & 3)) << 4) : q * ROW_BYTES + ((g ^ (q & 7)) << 4);
}

// The A fragments of one tap for NK k16 steps and MW row tiles: ldmatrix at
// the tap's shifted pixel, decoding the swizzle in the address.  Two k16
// steps (NK == 2) come only from a narrow chunk.
template <int NK, int MW>
__device__ __forceinline__ void load_a(uint32_t (&a)[NK][MW][4], uint32_t halo, int row0, int a_px, int a_half,
                                       int tap) {
  const int dy = tap / 3, dx = tap % 3;
#pragma unroll
  for (int i = 0; i < MW; ++i) {
    const int q = (row0 + i + dy) * HALO_W + a_px + dx;  // pixel of the halo box
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) ldmatrix_x4(a[kk][i], halo + staged<NK == 2>(q, 2 * kk + a_half));
  }
}

// The nine taps of one K chunk of NK k16 steps.  Tap t's wgmmas are
// committed as one group; once tap t - 1's group has completed, its weight
// slot is released and its A registers take tap t + 1's fragments, so the
// tensor cores always have the next group queued.
template <int NT, int MW, int NK>
__device__ __forceinline__ void mma_chunk(float (&acc)[MW][NT / 2], const Params& p, uint32_t halo, uint32_t wbase,
                                          uint32_t w_full, uint32_t w_empty, int kc, uint32_t& wn, int row0,
                                          int a_px, int a_half, int lane) {
  constexpr uint32_t WB = NT * ROW_BYTES;
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
      for (int i = 0; i < MW; ++i) Wgmma<NT>::mma(acc[i], a[tap & 1][kk][i], desc + 2 * kk);  // +32 bytes per k16
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

// Load route: the producer warpgroup's 128 threads fill one halo stage of
// chunk kc with plain loads, in the swizzled layout TMA would give, zeros for
// pixels off the image and channels past C_in.
template <int TH, bool NARROW>
__device__ __forceinline__ void gather_halo(const Params& p, uint32_t stage, int ptid, int b, int ty, int tx, int kc) {
  constexpr int NPX = (TH + 2) * HALO_W;
  constexpr int total = (NARROW ? 4 : 8) * NPX;
  const unsigned short* x = reinterpret_cast<const unsigned short*>(p.x);
  for (int e0 = ptid; e0 < total; e0 += 128 * LD_UNROLL) {
    uint4 v[LD_UNROLL];
#pragma unroll
    for (int u = 0; u < LD_UNROLL; ++u) {
      const int e = e0 + 128 * u;
      const int g = e / NPX, q = e - g * NPX;  // consecutive threads take consecutive pixels
      const int y = ty * TH - 1 + q / HALO_W, xx = tx * TW - 1 + q % HALO_W, c = kc * CK + 8 * g;
      uint32_t h[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) h[k] = 0;
      if (e < total && y >= 0 && y < p.H && xx >= 0 && xx < p.W && c < p.cin) {
        const unsigned short* src = x + (((size_t)b * p.H + y) * p.W + xx) * p.cin + c;
        const int n = p.cin - c;
#pragma unroll
        for (int k = 0; k < 8; ++k) h[k] = k < n ? __ldg(src + k) : 0u;
      }
      v[u] = make_uint4(h[0] | (h[1] << 16), h[2] | (h[3] << 16), h[4] | (h[5] << 16), h[6] | (h[7] << 16));
    }
#pragma unroll
    for (int u = 0; u < LD_UNROLL; ++u) {
      const int e = e0 + 128 * u;
      const int g = e / NPX, q = e - g * NPX;
      if (e < total) st_shared_v4(stage + staged<NARROW>(q, g), v[u]);
    }
  }
}

// NKL: k16 steps of the last K chunk: 2 for a narrow chunk (at most 32
// channels, staged in the 64-byte layout), else 4, as every other chunk.
// TMA: the input comes by tensor map (C_in % 8 == 0) or by the load route;
// xmap_tail is the map of a narrow last chunk (32-channel boxes).
template <int NT, int NKL, bool TMA>
__global__ void __launch_bounds__(THREADS, 1)
conv3x3_wgmma_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap xmap_tail,
                     const __grid_constant__ CUtensorMap ymap, const Params p) {
  constexpr int MW = rows_per_warpgroup(NT);
  constexpr int TH = CONSUMERS * MW;         // output rows per tile
  constexpr uint32_t WB = NT * ROW_BYTES;    // one weight slab: [NT, 64] bf16
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
      for (int kc = 0; kc < p.kc_count; ++kc) {
        const int hs = hn % p.halo_stages;
        const uint32_t stage = base + hs * p.halo_stage_bytes;
        mbar_wait(halo_empty + 8 * hs, ((hn / p.halo_stages) & 1) ^ 1);
        const bool narrow = NKL == 2 && kc + 1 == p.kc_count;
        if (TMA) {
          mbar_expect_tx(halo_full + 8 * hs, narrow ? p.tail_box_bytes : p.halo_box_bytes);
          tma_load_4d(stage, narrow ? &xmap_tail : &xmap, kc * CK, tx * TW - 1, ty * TH - 1, b, halo_full + 8 * hs);
        } else {
          if (narrow)
            gather_halo<TH, true>(p, stage, ptid, b, ty, tx, kc);
          else
            gather_halo<TH, false>(p, stage, ptid, b, ty, tx, kc);
          mbar_arrive_warp(halo_full + 8 * hs, lane);
        }
        ++hn;
        if (ptid != 0 || (p.resident && loaded)) continue;
        for (int tap = 0; tap < 9; ++tap) {
          const int ws = p.resident ? kc * 9 + tap : wn % p.w_slots;
          mbar_wait(w_empty + 8 * ws, p.resident ? 1 : ((wn / p.w_slots) & 1) ^ 1);
          mbar_expect_tx(w_full + 8 * ws, WB);
          bulk_load(wbase + ws * WB, p.w + ((size_t)(nb * p.kc_count + kc) * 9 + tap) * NT * CK, WB,
                    w_full + 8 * ws);
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
  const int a_half = lane >> 4;            // and which 8-channel half of the k16 step
  uint32_t hn = 0, wn = 0;
  float acc[MW][NT / 2];
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
      for (int j = 0; j < NT / 2; ++j) acc[i][j] = 0.0f;
    }
    for (int kc = 0; kc < p.kc_count; ++kc) {
      const int hs = hn % p.halo_stages;
      mbar_wait(halo_full + 8 * hs, (hn / p.halo_stages) & 1);
      const uint32_t halo = base + hs * p.halo_stage_bytes;
      if (NKL == 4 || kc + 1 < p.kc_count)
        mma_chunk<NT, MW, 4>(acc, p, halo, wbase, w_full, w_empty, kc, wn, g * MW, a_px, a_half, lane);
      else
        mma_chunk<NT, MW, NKL>(acc, p, halo, wbase, w_full, w_empty, kc, wn, g * MW, a_px, a_half, lane);
      mbar_arrive_warp(halo_empty + 8 * hs, lane);
      ++hn;
    }

    // Epilogue.  Accumulator element 4j + 2h + e of this thread is output pixel
    // 16 wi + lane / 4 + 8 h of its row and channel 8j + 2 (lane % 4) + e:
    // for each (j, h), the fragment of one 8 x 8 matrix of bf16 pairs.
    if constexpr (NT == 32 || NT == 64) {
      if (p.tma_store) {
        // stmatrix into the output tile, in the swizzled layout of the output
        // map's box (64-byte rows for NT = 32, 128-byte for 64), then one TMA
        // store; the consumers go on to the next tile while it drains.
        tma_store_wait_read(threadIdx.x == 0);  // the last tile's store has left the buffer
        consumer_barrier();
        const int m = lane >> 3;  // the matrix whose row this lane addresses
#pragma unroll
        for (int j = 0; j < NT / 8; j += 2) {
          float sc[2][2], bi[2][2];
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const int co = min(nb * NT + 8 * (j + k) + 2 * (lane & 3), p.cout - 2);  // past C_out: not stored
            const float2 s2 = __ldg(reinterpret_cast<const float2*>(p.scale + co));
            const float2 b2 = __ldg(reinterpret_cast<const float2*>(p.bias + co));
            sc[k][0] = s2.x, sc[k][1] = s2.y, bi[k][0] = b2.x, bi[k][1] = b2.y;
          }
#pragma unroll
          for (int i = 0; i < MW; ++i) {
            uint32_t r[4];  // matrices (j, h0), (j, h1), (j + 1, h0), (j + 1, h1)
#pragma unroll
            for (int k = 0; k < 2; ++k) {
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                float v0 = acc[i][4 * (j + k) + 2 * h] * sc[k][0] + bi[k][0];
                float v1 = acc[i][4 * (j + k) + 2 * h + 1] * sc[k][1] + bi[k][1];
                if (p.relu) {
                  v0 = fmaxf(v0, 0.0f);
                  v1 = fmaxf(v1, 0.0f);
                }
                r[2 * k + h] = pack_bf16x2(v0, v1);
              }
            }
            const int q = (g * MW + i) * TW + 16 * wi + (lane & 7) + 8 * (m & 1);  // pixel of the tile
            stmatrix_x4(obuf + staged<NT == 32>(q, j + (m >> 1)), r[0], r[1], r[2], r[3]);
          }
        }
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // visible to the TMA unit
        consumer_barrier();
        tma_store_4d(&ymap, obuf, nb * NT, tx * TW, ty * TH, b, threadIdx.x == 0);
        continue;
      }
    }
    // Where C_out % 8 == 0, each 32-channel block goes out as 16-byte stores:
    // the four lanes of a quad trade pairs so that lane q holds all eight
    // channels of group 4J + q.  Scale and bias are loaded once per tile.
    const int q4 = lane & 3;
    const bool vec = p.cout % 8 == 0;
#pragma unroll
    for (int J = 0; J < NT / 8; J += 4) {
      const int cb = nb * NT + 8 * J;  // first channel of this block
      if constexpr (NT >= 32) {
        if (vec && cb + 32 <= p.cout) {
          float sc[4][2], bi[4][2];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float2 s2 = __ldg(reinterpret_cast<const float2*>(p.scale + cb + 8 * k + 2 * q4));
            const float2 b2 = __ldg(reinterpret_cast<const float2*>(p.bias + cb + 8 * k + 2 * q4));
            sc[k][0] = s2.x, sc[k][1] = s2.y, bi[k][0] = b2.x, bi[k][1] = b2.y;
          }
#pragma unroll
          for (int i = 0; i < MW; ++i) {
            const int oy = ty * TH + g * MW + i;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              uint32_t w[4];
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                float v0 = acc[i][4 * (J + k) + 2 * h] * sc[k][0] + bi[k][0];
                float v1 = acc[i][4 * (J + k) + 2 * h + 1] * sc[k][1] + bi[k][1];
                if (p.relu) {
                  v0 = fmaxf(v0, 0.0f);
                  v1 = fmaxf(v1, 0.0f);
                }
                w[k] = pack_bf16x2(v0, v1);
              }
              const uint4 v = quad_transpose(w, q4);  // every lane takes part
              const int ox = tx * TW + 16 * wi + (lane >> 2) + 8 * h;
              if (oy < p.H && ox < p.W)
                *reinterpret_cast<uint4*>(p.y + (((size_t)b * p.H + oy) * p.W + ox) * p.cout + cb + 8 * q4) = v;
            }
          }
          continue;
        }
      }
#pragma unroll
      for (int j = J; j < J + 4 && j < NT / 8; ++j) {
        const int co = nb * NT + 8 * j + 2 * q4;
        if (co >= p.cout) continue;
        const bool two = co + 1 < p.cout;
        const float s0 = __ldg(p.scale + co), b0 = __ldg(p.bias + co);
        const float s1 = two ? __ldg(p.scale + co + 1) : 0.0f, b1 = two ? __ldg(p.bias + co + 1) : 0.0f;
#pragma unroll
        for (int i = 0; i < MW; ++i) {
          const int oy = ty * TH + g * MW + i;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int ox = tx * TW + 16 * wi + (lane >> 2) + 8 * h;
            if (oy >= p.H || ox >= p.W) continue;
            __nv_bfloat16* out = p.y + (((size_t)b * p.H + oy) * p.W + ox) * p.cout + co;
            float v0 = acc[i][4 * j + 2 * h] * s0 + b0, v1 = acc[i][4 * j + 2 * h + 1] * s1 + b1;
            if (p.relu) {
              v0 = fmaxf(v0, 0.0f);
              v1 = fmaxf(v1, 0.0f);
            }
            if (two && p.cout % 2 == 0) {
              *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(v0, v1);
            } else {
              out[0] = __float2bfloat16(v0);
              if (two) out[1] = __float2bfloat16(v1);
            }
          }
        }
      }
    }
  }
  tma_store_wait_read(threadIdx.x == 0);  // shared memory must outlive the last store's reads
}

template <int NT, int NKL, bool TMA>
cudaError_t launch(const CUtensorMap* maps, const Params& p, int grid, int smem, cudaStream_t stream) {
  auto kernel = conv3x3_wgmma_kernel<NT, NKL, TMA>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, smem, stream>>>(maps[0], maps[1], maps[2], p);
  return cudaGetLastError();
}

// The C entry point of either route: nt is the N tile (8, 16, 32, 64, 128 or
// 256) the weights were packed with.  Returns the cudaError_t of the launch.
template <bool TMA>
int conv3x3_wgmma(int device, const void* x, const void* w, const void* scale, const void* bias, void* y, int B,
                  int H, int W, int cin, int cout, int nt, int relu, void* stream) {
  const ptt::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  if (B <= 0 || H <= 0 || W <= 0 || cin <= 0 || cout <= 0 || (TMA && cin % 8 != 0) ||
      (reinterpret_cast<uintptr_t>(x) & 15) != 0 || (reinterpret_cast<uintptr_t>(w) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  if (nt != 8 && nt != 16 && nt != 32 && nt != 64 && nt != 128 && nt != 256) return (int)cudaErrorInvalidValue;

  const int th = CONSUMERS * rows_per_warpgroup(nt);
  Params p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.w = static_cast<const __nv_bfloat16*>(w);
  p.scale = static_cast<const float*>(scale);
  p.bias = static_cast<const float*>(bias);
  p.y = static_cast<__nv_bfloat16*>(y);
  p.H = H;
  p.W = W;
  p.cin = cin;
  p.cout = cout;
  p.relu = relu;
  p.kc_count = (cin + CK - 1) / CK;
  p.nb_count = (cout + nt - 1) / nt;
  p.tiles_y = (H + th - 1) / th;
  p.tiles_x = (W + TW - 1) / TW;
  const int64_t tiles = (int64_t)B * p.tiles_y * p.tiles_x * p.nb_count;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  p.tiles = (int)tiles;
  // a last chunk of at most 32 channels is narrow: 32-channel boxes, 64-byte rows
  const bool short_tail = cin - (p.kc_count - 1) * CK <= 32;
  p.halo_box_bytes = (uint32_t)((th + 2) * HALO_W * ROW_BYTES);
  p.tail_box_bytes = short_tail ? p.halo_box_bytes / 2 : p.halo_box_bytes;
  p.halo_stage_bytes = ((p.kc_count > 1 ? p.halo_box_bytes : p.tail_box_bytes) + 1023u) & ~1023u;
  // the TMA-store epilogue: N tiles of 32 and 64 (the byte-bound layers), where the
  // output map's 16-byte strides allow it
  p.tma_store = (nt == 32 || nt == 64) && cout % 8 == 0 && (reinterpret_cast<uintptr_t>(y) & 15) == 0;
  p.out_bytes = p.tma_store ? (uint32_t)(th * TW * nt * 2) : 0u;
  const int wb = nt * ROW_BYTES, slabs = 9 * p.kc_count;
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

  CUtensorMap maps[3] = {};
  EncodeTiledFn encode = TMA || p.tma_store ? encode_tiled() : nullptr;
  if ((TMA || p.tma_store) && encode == nullptr) return (int)cudaErrorSymbolNotFound;
  if (TMA) {
    // [B, H, W, C_in] as 4-D tensor maps, innermost first; one box is the halo
    // of a tile for one chunk: 64 channels with the 128-byte swizzle, and 32
    // with the 64-byte swizzle for a narrow last chunk.
    const cuuint64_t dims[4] = {(cuuint64_t)cin, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)cin * 2, (cuuint64_t)W * cin * 2, (cuuint64_t)H * W * cin * 2};
    const cuuint32_t unit[4] = {1, 1, 1, 1};
    for (int m = 0; m < 2; ++m) {
      const cuuint32_t box[4] = {(cuuint32_t)(m ? CK / 2 : CK), (cuuint32_t)HALO_W, (cuuint32_t)(th + 2), 1};
      if (encode(&maps[m], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims, strides, box, unit,
                 CU_TENSOR_MAP_INTERLEAVE_NONE, m ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
                 CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
        return (int)cudaErrorInvalidValue;
    }
  }
  if (p.tma_store) {
    // [B, H, W, C_out]; one box is an output tile, in the layout stmatrix wrote
    const cuuint64_t dims[4] = {(cuuint64_t)cout, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)cout * 2, (cuuint64_t)W * cout * 2, (cuuint64_t)H * W * cout * 2};
    const cuuint32_t box[4] = {(cuuint32_t)nt, (cuuint32_t)TW, (cuuint32_t)th, 1};
    const cuuint32_t unit[4] = {1, 1, 1, 1};
    if (encode(&maps[2], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, y, dims, strides, box, unit,
               CU_TENSOR_MAP_INTERLEAVE_NONE, nt == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return (int)cudaErrorInvalidValue;
  }

  int sms = 0;
  const cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const int grid = p.tiles < sms ? p.tiles : sms;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // k16 steps in the last chunk: 2 for a narrow one (the step past C_in meets zeros), else 4
  switch (nt) {
    case 8: return (int)(short_tail ? launch<8, 2, TMA> : launch<8, 4, TMA>)(maps, p, grid, smem, s);
    case 16: return (int)(short_tail ? launch<16, 2, TMA> : launch<16, 4, TMA>)(maps, p, grid, smem, s);
    case 32: return (int)(short_tail ? launch<32, 2, TMA> : launch<32, 4, TMA>)(maps, p, grid, smem, s);
    case 64: return (int)(short_tail ? launch<64, 2, TMA> : launch<64, 4, TMA>)(maps, p, grid, smem, s);
    case 128: return (int)(short_tail ? launch<128, 2, TMA> : launch<128, 4, TMA>)(maps, p, grid, smem, s);
    default: return (int)(short_tail ? launch<256, 2, TMA> : launch<256, 4, TMA>)(maps, p, grid, smem, s);
  }
}

}  // namespace
