"""3x3 convolution with a folded BatchNorm / ReLU epilogue (kernel K2).

Counterpart of ``pytorch_toolbelt_tpu/ops/conv_kernels.py``.  The TPU
package runs the narrow UNet convs through the Pallas kernel
``conv3x3_hcw``; here they run through a CUDA implicit GEMM on the tensor
cores (``csrc/conv3x3.cu``), for every shape the UNet has: any C_in
(the 3-channel stem included), any C_out (the 1-class head included), any
H and W.

Activations are NCHW tensors in the ``torch.channels_last`` memory format
(their storage is NHWC), bf16.  Weights are packed once by
:func:`pack_conv3x3_weights`.

:func:`conv3x3` launches the kernel for CUDA tensors and runs
:func:`conv3x3_reference` (``F.conv2d`` in fp32) for CPU tensors; on any
other device it raises.
"""

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["conv3x3", "conv3x3_reference", "fold_batchnorm", "pack_conv3x3_weights"]

_CK = 16  # input channels per K step of the kernel


def _cout_block(c_out: int) -> int:
    return 32 if c_out <= 32 else 64


def fold_batchnorm(scale, bias, mean, var, eps: float = 1e-5):
    """Inference BatchNorm -> (scale', bias') for the conv epilogue:
    y = x * scale' + bias'."""
    inv = scale / torch.sqrt(var + eps)
    return inv, bias - mean * inv


def pack_conv3x3_weights(weight: torch.Tensor) -> torch.Tensor:
    """OIHW [C_out, C_in, 3, 3] -> bf16 [9, C_in_pad, C_out_pad], tap-major
    (tap = 3 * dy + dx), zero padded: C_in to a multiple of 16 and C_out to
    a multiple of the kernel's output-channel block (32 or 64)."""
    c_out, c_in, kh, kw = weight.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f"conv3x3 expects 3x3 weights, got {kh}x{kw}")
    block = _cout_block(c_out)
    c_in_pad = -(-c_in // _CK) * _CK
    c_out_pad = -(-c_out // block) * block
    packed = torch.zeros(9, c_in_pad, c_out_pad, dtype=torch.bfloat16, device=weight.device)
    packed[:, :c_in, :c_out] = weight.permute(2, 3, 1, 0).reshape(9, c_in, c_out).to(torch.bfloat16)
    return packed


def _unpack(packed: torch.Tensor, c_in: int, c_out: int) -> torch.Tensor:
    """Inverse of :func:`pack_conv3x3_weights` (as OIHW)."""
    return packed[:, :c_in, :c_out].reshape(3, 3, c_in, c_out).permute(3, 2, 0, 1)


def conv3x3_reference(x, weight, scale, bias, relu: bool) -> torch.Tensor:
    """Plain version of :func:`conv3x3`: fp32 ``F.conv2d`` (padding 1) of
    x [B, C_in, H, W] with OIHW weights, then scale, bias and ReLU.
    Returns fp32 NCHW."""
    y = F.conv2d(x.float(), weight.float(), padding=1)
    y = y * scale.float()[None, :, None, None] + bias.float()[None, :, None, None]
    return torch.relu(y) if relu else y


def conv3x3(x: torch.Tensor, w_packed: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
            relu: bool = True) -> torch.Tensor:
    """y = relu?(conv3x3(x, W) * scale + bias), stride 1, zero padding 1.

    Args:
        x: [B, C_in, H, W] bf16, ``torch.channels_last`` contiguous.
        w_packed: from :func:`pack_conv3x3_weights`.
        scale, bias: [C_out] fp32 (BatchNorm folded by :func:`fold_batchnorm`;
            ones and the conv bias for a plain conv).
    Returns:
        [B, C_out, H, W] bf16, ``torch.channels_last`` contiguous.

    CPU tensors take :func:`conv3x3_reference`; CUDA tensors launch the
    kernel (counted in ``conv3x3.launches``).
    """
    if x.ndim != 4 or x.dtype != torch.bfloat16 or not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"conv3x3: x must be a channels_last bf16 [B, C, H, W] tensor, got {x.dtype} {tuple(x.shape)}")
    b, c_in, h, w = x.shape
    c_out = scale.numel()
    block = _cout_block(c_out)
    expect = (9, -(-c_in // _CK) * _CK, -(-c_out // block) * block)
    if w_packed.dtype != torch.bfloat16 or tuple(w_packed.shape) != expect or not w_packed.is_contiguous():
        raise ValueError(f"conv3x3: w_packed must be contiguous bf16 {expect}, got {w_packed.dtype} {tuple(w_packed.shape)}")
    for name, t in (("scale", scale), ("bias", bias)):
        if t.dtype != torch.float32 or tuple(t.shape) != (c_out,) or not t.is_contiguous():
            raise ValueError(f"conv3x3: {name} must be contiguous fp32 [{c_out}]")
    if any(t.device != x.device for t in (w_packed, scale, bias)):
        raise ValueError("conv3x3: all operands must be on one device")

    if x.device.type == "cpu":
        y = conv3x3_reference(x, _unpack(w_packed, c_in, c_out), scale, bias, relu)
        return y.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3: unsupported device {x.device}")
    if x.data_ptr() % 16:
        raise ValueError("conv3x3: x must be 16-byte aligned")
    y = torch.empty(b, c_out, h, w, dtype=torch.bfloat16, device=x.device, memory_format=torch.channels_last)
    lib = _build.library()
    err = lib.ptt_conv3x3_bf16(
        x.device.index, x.data_ptr(), w_packed.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
        b, h, w, c_in, c_out, expect[1], expect[2], int(relu), _build.stream_of(x.device),
    )
    _build.check(err, "conv3x3")
    conv3x3.launches += 1
    return y


conv3x3.launches = 0
