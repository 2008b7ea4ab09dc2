"""3x3 convolution with a folded BatchNorm / ReLU epilogue (kernel K2).

Counterpart of ``pytorch_toolbelt_tpu/ops/conv_kernels.py``.  The TPU
package runs the narrow UNet convs through the Pallas kernel
``conv3x3_hcw``; here they run through hand-written CUDA implicit GEMMs on
the tensor cores, for every shape the UNet has: any C_in (the 3-channel stem
included), any C_out (the 1-class head included), any H and W.  One kernel
design (``csrc/conv3x3_wgmma.cuh``: ``wgmma`` on Hopper's tensor cores, all
of C_out up to 256 per pixel tile, weights by TMA bulk copies) with two
routes for the input:

- ``"tma_wgmma"`` (``csrc/conv3x3_wgmma.cu``), for C_in % 8 == 0: TMA loads
  the input's halo tiles;
- ``"ld_wgmma"`` (``csrc/conv3x3_wgmma_ld.cu``), for C_in % 8 != 0 (the
  3-channel stem): a tensor map takes only 16-byte strides, so the producer
  warps gather the halo with plain loads.

A third route, ``"wmma"`` (``csrc/conv3x3.cu``, the port's first K2 through
``mma.sync``), takes weights packed by the private ``_pack_wmma``: it is the
yardstick ``chip_smoke.py`` times the wgmma kernel against at every UNet
shape, and no model uses it.  The layout of the packed weights selects
between it and the wgmma routes, and C_in % 8 between those two.

Activations are NCHW tensors in the ``torch.channels_last`` memory format
(their storage is NHWC), bf16.

:func:`conv3x3` launches a kernel for CUDA tensors and runs
:func:`conv3x3_reference` (``F.conv2d`` in fp32) for CPU tensors; on any
other device it raises.
"""

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["conv3x3", "conv3x3_reference", "fold_batchnorm", "pack_conv3x3_weights"]

_ROUTES = ("tma_wgmma", "ld_wgmma", "wmma")
_WMMA_CK = 16  # input channels per K step of the WMMA kernel
_CK = 64  # input channels per K chunk of the wgmma kernel: one 128-byte swizzle row
_TILE_N = (8, 16, 32, 64, 128, 256)  # output channels per wgmma block


def _wmma_cout_block(c_out: int) -> int:
    return 32 if c_out <= 32 else 64


def _tile_n(c_out: int) -> int:
    """The wgmma kernel's N tile: all of C_out up to 256, else an even split."""
    blocks = -(-c_out // 256)
    return next(n for n in _TILE_N if n >= -(-c_out // blocks))


def _packed_shape(route: str, c_in: int, c_out: int) -> tuple:
    if route == "wmma":
        block = _wmma_cout_block(c_out)
        return 9, -(-c_in // _WMMA_CK) * _WMMA_CK, -(-c_out // block) * block
    nt = _tile_n(c_out)
    return -(-c_out // nt), -(-c_in // _CK), 9, nt, _CK


def fold_batchnorm(scale, bias, mean, var, eps: float = 1e-5):
    """Inference BatchNorm -> (scale', bias') for the conv epilogue:
    y = x * scale' + bias'."""
    inv = scale / torch.sqrt(var + eps)
    return inv, bias - mean * inv


def _swizzle128(w: torch.Tensor) -> torch.Tensor:
    """The 128-byte swizzle of rows of 64 bf16: the 16-byte group g of row n
    is stored at group g ^ (n % 8).  It is its own inverse."""
    *lead, rows, cols = w.shape
    v = w.reshape(*lead, rows // 8, 8, 8, 8)  # [..., row // 8, row % 8, group, element]
    lanes = torch.arange(8, device=w.device)
    index = (lanes[:, None] ^ lanes[None, :])[:, :, None].expand(v.shape)
    return torch.gather(v, -2, index).reshape(w.shape)


def _check_3x3(weight: torch.Tensor):
    c_out, c_in, kh, kw = weight.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f"conv3x3 expects 3x3 weights, got {kh}x{kw}")
    return c_out, c_in


def pack_conv3x3_weights(weight: torch.Tensor) -> torch.Tensor:
    """OIHW [C_out, C_in, 3, 3] -> bf16 [NB, KC, 9, NT, 64] for the wgmma
    routes: N block, 64-channel K chunk, tap (3 * dy + dx), output channel
    within the block, input channel within the chunk; zero padded, each
    [NT, 64] slab K-major with the 128-byte swizzle applied (what a wgmma B
    descriptor reads).  NT is the N tile (:func:`_tile_n`): all of C_out up
    to 256."""
    c_out, c_in = _check_3x3(weight)
    shape = _packed_shape("wgmma", c_in, c_out)
    nb, kc, _, nt, ck = shape
    w = torch.zeros(nb * nt, kc * ck, 3, 3, dtype=torch.bfloat16, device=weight.device)
    w[:c_out, :c_in] = weight.to(torch.bfloat16)
    w = w.reshape(nb, nt, kc, ck, 3, 3).permute(0, 2, 4, 5, 1, 3).reshape(shape)
    return _swizzle128(w).contiguous()


def _pack_wmma(weight: torch.Tensor) -> torch.Tensor:
    """OIHW -> bf16 [9, C_in_pad, C_out_pad] for the ``"wmma"`` route:
    tap-major, C_in padded to a multiple of 16 and C_out to the kernel's
    block (32 or 64)."""
    c_out, c_in = _check_3x3(weight)
    packed = torch.zeros(_packed_shape("wmma", c_in, c_out), dtype=torch.bfloat16, device=weight.device)
    packed[:, :c_in, :c_out] = weight.permute(2, 3, 1, 0).reshape(9, c_in, c_out).to(torch.bfloat16)
    return packed


def _route(packed: torch.Tensor, c_in: int) -> str:
    """The kernel that takes these weights: by their layout, then by C_in % 8."""
    if packed.ndim == 3:
        return "wmma"
    return "tma_wgmma" if c_in % 8 == 0 else "ld_wgmma"


def _unpack(packed: torch.Tensor, c_in: int, c_out: int) -> torch.Tensor:
    """Inverse of :func:`pack_conv3x3_weights` and :func:`_pack_wmma` (as OIHW)."""
    if packed.ndim == 3:
        return packed[:, :c_in, :c_out].reshape(3, 3, c_in, c_out).permute(3, 2, 0, 1)
    nb, kc, _, nt, ck = packed.shape
    w = _swizzle128(packed).reshape(nb, kc, 3, 3, nt, ck).permute(0, 4, 1, 5, 2, 3)
    return w.reshape(nb * nt, kc * ck, 3, 3)[:c_out, :c_in]


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
        w_packed: from :func:`pack_conv3x3_weights`; its layout picks the route.
        scale, bias: [C_out] fp32 (BatchNorm folded by :func:`fold_batchnorm`;
            ones and the conv bias for a plain conv).
    Returns:
        [B, C_out, H, W] bf16, ``torch.channels_last`` contiguous.

    CPU tensors take :func:`conv3x3_reference`; CUDA tensors launch the
    route's kernel, counted in ``conv3x3.launches`` and
    ``conv3x3.launches_by_route``.
    """
    if x.ndim != 4 or x.dtype != torch.bfloat16 or not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"conv3x3: x must be a channels_last bf16 [B, C, H, W] tensor, got {x.dtype} {tuple(x.shape)}")
    b, c_in, h, w = x.shape
    c_out = scale.numel()
    route = _route(w_packed, c_in)
    expect = _packed_shape("wmma" if route == "wmma" else "wgmma", c_in, c_out)
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
    if x.data_ptr() % 16 or w_packed.data_ptr() % 16:
        raise ValueError("conv3x3: x and w_packed must be 16-byte aligned")
    y = torch.empty(b, c_out, h, w, dtype=torch.bfloat16, device=x.device, memory_format=torch.channels_last)
    lib = _build.library()
    args = (x.device.index, x.data_ptr(), w_packed.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
            b, h, w, c_in, c_out)
    if route == "tma_wgmma":
        err = lib.ptt_conv3x3_wgmma_bf16(*args, expect[3], int(relu), _build.stream_of(x.device))
    elif route == "ld_wgmma":
        err = lib.ptt_conv3x3_wgmma_ld_bf16(*args, expect[3], int(relu), _build.stream_of(x.device))
    else:
        err = lib.ptt_conv3x3_wmma_bf16(*args, expect[1], expect[2], int(relu), _build.stream_of(x.device))
    _build.check(err, f"conv3x3 ({route})")
    conv3x3.launches += 1
    conv3x3.launches_by_route[route] += 1
    return y


conv3x3.launches = 0
conv3x3.launches_by_route = dict.fromkeys(_ROUTES, 0)
