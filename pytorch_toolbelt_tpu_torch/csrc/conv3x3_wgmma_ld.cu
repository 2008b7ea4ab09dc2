// K2's load route: the wgmma implicit GEMM of conv3x3_wgmma.cuh with the
// input halo gathered by the producer warpgroup's plain loads, for C_in the
// TMA route cannot take (C_in % 8 != 0: the UNet's 3-channel stem).
// Replaces the TPU kernel pytorch_toolbelt_tpu/ops/conv_kernels.py
// `conv3x3_hcw`; the design note is in conv3x3_wgmma.cuh.

#include "conv3x3_wgmma.cuh"

extern "C" int ptt_conv3x3_wgmma_ld_bf16(int device, const void* x, const void* w, const void* scale,
                                         const void* bias, void* y, int B, int H, int W, int cin, int cout, int nt,
                                         int relu, void* stream) {
  return conv3x3_wgmma<false>(device, x, w, scale, bias, y, B, H, W, cin, cout, nt, relu, stream);
}
