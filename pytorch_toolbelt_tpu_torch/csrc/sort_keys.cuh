// The key order shared by the two sort kernels (radix_sort.cu, merge_sort.cu).
//
// A 4-byte key is mapped to an unsigned word whose unsigned order is the
// order of torch.sort: for float32, -0.0 ties +0.0 and every NaN ties every
// other NaN after +inf; for int32, the usual signed order.  Both kernels move
// the key's original bits and compute this word only to compare or to take a
// digit, so -0.0 and each NaN's payload bits come out as they went in.
#pragma once

#include <stdint.h>

namespace ptt_sort {

enum KeyKind { kFloat32 = 0, kInt32 = 1 };

template <int Kind>
__device__ __forceinline__ uint32_t order_bits(uint32_t b) {
  if (Kind == kInt32) return b ^ 0x80000000u;
  if ((b & 0x7fffffffu) > 0x7f800000u) return 0xffffffffu;  // NaN: last, all equal
  if (b == 0x80000000u) b = 0u;                               // -0.0 ties +0.0
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

}  // namespace ptt_sort
