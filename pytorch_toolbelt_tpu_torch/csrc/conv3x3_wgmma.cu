// K2's TMA route: the wgmma implicit GEMM of conv3x3_wgmma.cuh with the input
// halo loaded by TMA, for C_in % 8 == 0 (a tensor map needs 16-byte strides).
// Replaces the TPU kernel pytorch_toolbelt_tpu/ops/conv_kernels.py
// `conv3x3_hcw`; the design note is in conv3x3_wgmma.cuh.

#include "conv3x3_wgmma.cuh"

extern "C" int ptt_conv3x3_wgmma_bf16(int device, const void* x, const void* w, const void* scale, const void* bias,
                                      void* y, int B, int H, int W, int cin, int cout, int nt, int relu,
                                      void* stream) {
  return conv3x3_wgmma<true>(device, x, w, scale, bias, y, B, H, W, cin, cout, nt, relu, stream);
}
