// The int8 encoder-decoder's residual and FPN adds, with the SE excitation
// fused in (kernel Q3).
//
// What it replaces.  No Pallas kernel: the JAX package runs the add and the
// excitation as XLA elementwise ops (pytorch_toolbelt_tpu/zoo/quantized_encdec.py,
// the "se" and "add" nodes of its integer forward):
//   s   = gate ? clip((a * g[b, c] + 2^13) >> 14, +-127) : a
//   acc = s * ma[c] + b * mb[c];  acc = max(acc, 0) where relu
//   out = clip((acc + 2^11) >> 12, +-127)
// with a, b and out int8, ma and mb int32 per channel, g the SE gate rounded
// to round(gate * 2^14), int32 per sample and channel.  Run eagerly in torch,
// that is some fifteen int32 passes over the map: each widens, multiplies,
// clamps, shifts or narrows, and moves 8-12 bytes an element.
//
// Bound: bytes.  Each add reads its two int8 addends once and writes its
// int8 sum once: 3 bytes an element over 3.35 TB/s.  The excitation reads
// what the add reads anyway (the block's conv output) and writes nothing: the
// excited map never reaches device memory.
//
// Design (`q_add_kernel`, route vec16).  A thread owns one 16-channel slice of
// C for its whole life: grid.y walks the samples, and the threads of a
// sample's blocks are a multiple of C / 16, so a thread's slice never changes
// while it walks pixels.  Its 16 ma, 16 mb and its sample's 16 gate values are
// loaded once and held in registers.  Per step a thread issues UNROLL 16-byte
// loads of each addend (read-only path, no L1 allocation) before it computes,
// then writes UNROLL 16-byte stores.  No int32 intermediate reaches device
// memory.  The arithmetic per element: one prmt per addend (a
// sign-extended byte), the excitation's multiply-add, shift and clip, two
// multiply-adds with the rounding constant folded into the first, one shift
// and the clip, whose floor (0 with ReLU, -127 without) also applies the ReLU:
//   max(acc, 0) + 2^11 >> 12 == max((acc + 2^11) >> 12, 0)
// for every acc with |acc| + 2^11 < 2^31 (the host clips ma and mb at 2^20, so
// |acc| < 2^28).  Four results pack into a word with three byte_perms.
//
// The scalar route (`q_add_scalar_kernel`): one thread per element, for C %
// 16 != 0 or a tensor off a 16-byte boundary (ops/quantized.py _add_route
// picks the route; the entry point refuses a call that does not fit it).

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;  // 16-byte loads of each addend in flight per thread
constexpr int VEC = 16;    // channels of a thread's slice
constexpr int ADD_SHIFT = 12, GATE_SHIFT = 14, QMAX = 127;
constexpr int MAX_DEVICES = 64;

enum Route { ROUTE_VEC16 = 0, ROUTE_SCALAR = 1 };

struct Add {
  const int8_t* a;
  const int8_t* b;
  const int* ma;
  const int* mb;
  const int* gate;  // [B, C] or null
  int8_t* y;
  long long hw;     // pixels of a sample
  int C, slices, B;
  int floor;        // 0 with ReLU, -QMAX without
};

__device__ __forceinline__ int4 load_stream(const int8_t* p) {
  int4 v;
  asm("ld.global.nc.L1::no_allocate.v4.s32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

__device__ __forceinline__ void load16(const int* p, int (&v)[VEC]) {
#pragma unroll
  for (int i = 0; i < VEC; i += 4) {
    const int4 q = *reinterpret_cast<const int4*>(p + i);
    v[i] = q.x, v[i + 1] = q.y, v[i + 2] = q.z, v[i + 3] = q.w;
  }
}

__device__ __forceinline__ int clip(int v, int lo) { return min(max(v, lo), QMAX); }

// byte i of w, sign-extended: PTX prmt, whose selector nibbles with the top
// bit set replicate the selected byte's sign (__byte_perm masks that bit off)
__device__ __forceinline__ int sbyte(uint32_t w, int i) {
  int r;
  asm("prmt.b32 %0, %1, 0, %2;" : "=r"(r) : "r"(w), "r"(i | (0x8 | i) << 4 | (0x8 | i) << 8 | (0x8 | i) << 12));
  return r;
}

template <bool GATED>
__device__ __forceinline__ int add_one(int a, int b, int ma, int mb, int g, int floor) {
  if (GATED) a = clip((a * g + (1 << (GATE_SHIFT - 1))) >> GATE_SHIFT, -QMAX);
  return clip((a * ma + (b * mb + (1 << (ADD_SHIFT - 1)))) >> ADD_SHIFT, floor);
}

// four channels (first: j) of a word of each addend
template <bool GATED>
__device__ __forceinline__ uint32_t add_word(uint32_t wa, uint32_t wb, int j, const int (&ma)[VEC],
                                             const int (&mb)[VEC], const int (&g)[VEC], int floor) {
  int v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = add_one<GATED>(sbyte(wa, i), sbyte(wb, i), ma[j + i], mb[j + i], g[j + i], floor);
  return __byte_perm(__byte_perm(v[0], v[1], 0x0040), __byte_perm(v[2], v[3], 0x0040), 0x5410);
}

template <bool GATED>
__device__ __forceinline__ int4 add_vec(int4 va, int4 vb, const int (&ma)[VEC], const int (&mb)[VEC],
                                        const int (&g)[VEC], int floor) {
  int4 r;
  r.x = (int)add_word<GATED>(va.x, vb.x, 0, ma, mb, g, floor);
  r.y = (int)add_word<GATED>(va.y, vb.y, 4, ma, mb, g, floor);
  r.z = (int)add_word<GATED>(va.z, vb.z, 8, ma, mb, g, floor);
  r.w = (int)add_word<GATED>(va.w, vb.w, 12, ma, mb, g, floor);
  return r;
}

// grid (blocks per sample, samples): a sample's THREADS * gridDim.x threads are
// a multiple of p.slices, so each thread keeps slice t % slices
template <bool GATED>
__global__ void __launch_bounds__(THREADS) q_add_kernel(Add p) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  const int k = (int)(t % p.slices);
  const long long lanes = (long long)gridDim.x * THREADS / p.slices;  // pixels walked at once
  int ma[VEC], mb[VEC], g[VEC];
  load16(p.ma + VEC * k, ma);
  load16(p.mb + VEC * k, mb);
#pragma unroll
  for (int i = 0; i < VEC; ++i) g[i] = 0;
  const long long row = (long long)p.C;  // bytes between pixels
  for (int s = blockIdx.y; s < p.B; s += gridDim.y) {
    if (GATED) load16(p.gate + (long long)s * p.C + VEC * k, g);
    const long long base = (long long)s * p.hw * row + VEC * k;
    const int8_t* a = p.a + base;
    const int8_t* b = p.b + base;
    int8_t* y = p.y + base;
    for (long long q = t / p.slices; q < p.hw; q += UNROLL * lanes) {
      int4 va[UNROLL], vb[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long r = q + u * lanes;
        if (r < p.hw) {
          va[u] = load_stream(a + r * row);
          vb[u] = load_stream(b + r * row);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long r = q + u * lanes;
        if (r < p.hw) *reinterpret_cast<int4*>(y + r * row) = add_vec<GATED>(va[u], vb[u], ma, mb, g, p.floor);
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS) q_add_scalar_kernel(Add p) {
  const long long total = (long long)p.B * p.hw * p.C;
  const long long per_sample = p.hw * p.C;
  for (long long e = (long long)blockIdx.x * THREADS + threadIdx.x; e < total; e += (long long)gridDim.x * THREADS) {
    const int c = (int)(e % p.C);
    int a = p.a[e];
    if (p.gate != nullptr)
      a = clip((a * p.gate[e / per_sample * p.C + c] + (1 << (GATE_SHIFT - 1))) >> GATE_SHIFT, -QMAX);
    p.y[e] = (int8_t)clip((a * p.ma[c] + (p.b[e] * p.mb[c] + (1 << (ADD_SHIFT - 1)))) >> ADD_SHIFT, p.floor);
  }
}

// (SMs, resident blocks per SM of each instance) per device, read once
struct Fill {
  int sms = 0, vec[2] = {0, 0}, scalar = 0;
};
Fill fills[MAX_DEVICES];

cudaError_t fill_of(int device, Fill& f) {
  if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  Fill& c = fills[device];
  if (c.sms == 0) {
    Fill n;
    cudaError_t err = cudaDeviceGetAttribute(&n.sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n.vec[0], q_add_kernel<false>, THREADS, 0);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n.vec[1], q_add_kernel<true>, THREADS, 0);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n.scalar, q_add_scalar_kernel, THREADS, 0);
    if (err != cudaSuccess) return err;
    c = n;  // a race writes the same values
  }
  f = c;
  return cudaSuccess;
}

long long gcd(long long x, long long y) {
  while (y) {
    const long long r = x % y;
    x = y, y = r;
  }
  return x;
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  a, b and y are
// [B, H, W, C] int8 (channels_last [B, C, H, W]), hw = H * W; ma and mb int32
// [C]; gate int32 [B, C] or null.  route: ROUTE_* (ops/quantized.py
// _ADD_ROUTES); the vector route needs C % 16 == 0 and every pointer 16-byte
// aligned.
extern "C" int ptt_q_add(int device, const void* a, const void* b, const void* ma, const void* mb, const void* gate,
                         void* y, int B, long long hw, int C, int relu, int route, void* stream) {
  const ptt::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  if (B <= 0 || hw <= 0 || C <= 0 || a == nullptr || b == nullptr || ma == nullptr || mb == nullptr || y == nullptr)
    return (int)cudaErrorInvalidValue;
  Fill f;
  const cudaError_t err = fill_of(device, f);
  if (err != cudaSuccess) return (int)err;
  Add p{static_cast<const int8_t*>(a), static_cast<const int8_t*>(b), static_cast<const int*>(ma),
        static_cast<const int*>(mb), static_cast<const int*>(gate), static_cast<int8_t*>(y), hw, C, C / VEC, B,
        relu ? 0 : -QMAX};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == ROUTE_VEC16) {
    const uintptr_t addr = (uintptr_t)a | (uintptr_t)b | (uintptr_t)ma | (uintptr_t)mb | (uintptr_t)y |
                           (gate != nullptr ? (uintptr_t)gate : 0);
    if (C % VEC || addr % 16) return (int)cudaErrorInvalidValue;
    const bool gated = gate != nullptr;
    // one wave of resident blocks over all samples, at least UNROLL vectors a
    // thread, in whole multiples of the blocks that hold a multiple of slices
    const long long unit = p.slices / gcd(p.slices, THREADS);
    const unsigned gy = B < 65535 ? (unsigned)B : 65535u;
    const long long wave = (long long)f.sms * f.vec[gated];
    const long long most = (hw * p.slices + (long long)THREADS * UNROLL - 1) / ((long long)THREADS * UNROLL);
    long long gx = (wave + gy - 1) / gy;
    if (gx > most) gx = most;
    gx = (gx + unit - 1) / unit * unit;
    if (gx > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)gx, gy);
    if (gated)
      q_add_kernel<true><<<grid, THREADS, 0, s>>>(p);
    else
      q_add_kernel<false><<<grid, THREADS, 0, s>>>(p);
    return (int)cudaGetLastError();
  }
  if (route != ROUTE_SCALAR) return (int)cudaErrorInvalidValue;
  const long long total = (long long)B * hw * C;
  long long blocks = (total + THREADS - 1) / THREADS;
  const long long wave = (long long)f.sms * f.scalar;
  if (blocks > wave) blocks = wave;
  q_add_scalar_kernel<<<(unsigned)blocks, THREADS, 0, s>>>(p);
  return (int)cudaGetLastError();
}
