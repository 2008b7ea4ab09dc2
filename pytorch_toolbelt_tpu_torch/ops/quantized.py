"""int8 convolution (kernel Q1), requantized int8 bilinear upsample (kernel
Q2) and the requantized int8 add with an optional SE excitation (kernel Q3)
for the integer inference paths of ``zoo/quantized_unet.py`` and
``zoo/quantized_encdec.py``.

The JAX package runs both as XLA ops: ``lax.conv_general_dilated(...,
preferred_element_type=int32)`` with an integer epilogue
(``pytorch_toolbelt_tpu/zoo/quantized_unet.py:140``) and two int8 einsums
against quantized interpolation matrices (``:175``), whose result the UNet's
decoder joins to its skip (``:354-355``).  torch has neither on CUDA, so the
port brings hand-written kernels: Q1 has three, ``csrc/qconv_wgmma.cu`` (a
TMA-fed ``wgmma`` s8 implicit GEMM for the 3x3 stride-1 pad-1 groups-1
convs, routes ``tma_wgmma`` and ``ld_wgmma``), ``csrc/qconv_gemm.cu`` (the
same machinery for the 1x1 convs, route ``gemm_wgmma``, and for the grouped
3x3 convs as bands of block-diagonal 32-channel tiles, ``grouped_wgmma``)
and ``csrc/qconv.cu`` (an ``mma.sync`` s8 implicit GEMM for every other
shape, routes ``mma_v16``, ``mma_v4``, ``mma_v1``), all with the epilogue
fused; Q2 is
``csrc/q_upsample.cu``: a banded kernel (route ``banded``: a block's tile of
output rows and columns, its input in shared memory, each row-pass value
computed once) and the per-pixel kernel for the other channel counts
(``v4``, ``v1``), which :func:`q_upsample` runs alone and
:func:`q_upsample_cat` runs writing the decoder input, upsample and skip, in
one launch.  Q3 is ``csrc/q_add.cu``: the encoder-decoder's residual and FPN
adds, each addend read once and the int8 sum written once, with the SE
excitation of the first addend applied in registers (route ``vec16``: 16
channels a thread, 16-byte accesses; ``scalar`` for the other channel counts
and alignments).  :func:`_conv_route`, :func:`_upsample_route` and
:func:`_add_route` pick the routes.

Activations are NCHW tensors in the ``torch.channels_last`` memory format
(their storage is NHWC), int8.  All integer arithmetic is int32 with two's
complement wraparound, as XLA's; ``>>`` is arithmetic and a shift of 32 or
more leaves the sign, as in XLA and torch.

:func:`qconv2d`, :func:`q_upsample`, :func:`q_upsample_cat` and :func:`q_add`
launch their kernel for CUDA tensors and run their plain version
(:func:`qconv2d_reference`, :func:`q_upsample_reference`,
:func:`q_upsample_cat_reference`, :func:`q_add_reference`) for CPU tensors;
on any other device they raise.
"""

import contextlib
import ctypes
import functools
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.profiling import span
from . import _build
from .conv_kernels import _swizzle128
from .conv_kernels import _tile_n as _wgmma_tile_n

__all__ = [
    "QConvWeight",
    "pack_qconv2d_weights",
    "q_add",
    "q_add_reference",
    "q_upsample",
    "q_upsample_cat",
    "q_upsample_cat_reference",
    "q_upsample_reference",
    "qconv2d",
    "qconv2d_reference",
    "upsample_taps",
]

_QMAX = 127
_MUL_SHIFT = 23
_EPILOGUES = ("acc", "shift", "mul")
_K_STEP = 32  # K bytes per mma.m16n8k32 step: the packed K is padded to it per group
# Q1's routes; the index is the code ptt_qconv2d takes
_CONV_ROUTES = ("mma_v16", "mma_v4", "mma_v1", "tma_wgmma", "ld_wgmma", "gemm_wgmma", "grouped_wgmma")
_WGMMA_CK = 128  # input channels per full K chunk of the wgmma routes: one 128-byte swizzle row
_GEMM_N_PAD = 128  # gemm_wgmma's packed output channels are padded to a multiple of its widest N tile
_BAND = 32  # channels of a band of grouped_wgmma: one k32 step, a whole number of groups
_GROUPED_PADS = {1: ((1, 1, 1, 1),), 2: ((1, 1, 1, 1), (0, 1, 0, 1))}  # flax SAME at each stride
# Q2's routes; the index is the code ptt_q_upsample takes
_UPSAMPLE_ROUTES = ("banded", "v4", "v1")
_BAND_ROWS = 8  # output rows per block of the banded route
_BAND_ROW_BYTES, _BAND_MIN_COLS, _BAND_MAX_COLS = 4096, 8, 64  # output channels x columns per band row
_BAND_SMEM = 232448  # shared memory a block may hold on the H100
# Q3's routes; the index is the code ptt_q_add takes
_ADD_ROUTES = ("vec16", "scalar")
_ADD_SHIFT = 12  # fixed-point bits of Q3's per-channel add multipliers
_GATE_SHIFT = 14  # fixed-point bits of Q3's SE gates
_CL = torch.channels_last


class QConvWeight(NamedTuple):
    """int8 conv weights as :func:`qconv2d` takes them."""

    weight: torch.Tensor  # [C_out, C_in / groups, kh, kw] int8 (OIHW), for the plain version
    packed: torch.Tensor  # [groups, N_pad, K_pad] int8, for the mma routes
    groups: int
    tile_n: int  # output channels per block of the mma routes
    wgmma: Optional[torch.Tensor] = None  # [NB, KC, 9, NT, 128] int8 for tma_wgmma / ld_wgmma (3x3, groups 1)
    gemm: Optional[torch.Tensor] = None  # [KC, N_pad, 128] int8 for gemm_wgmma (1x1, groups 1)
    banded: Optional[torch.Tensor] = None  # [C / 128, 9, 32, 128] int8 for grouped_wgmma


def _tile_n(co_pg: int) -> int:
    return next((n for n in (8, 16, 32) if co_pg <= n), 64)


def pack_qconv2d_weights(weight: torch.Tensor, groups: int = 1) -> QConvWeight:
    """OIHW int8 [C_out, C_in / groups, kh, kw] -> :class:`QConvWeight`.

    The packed tensor is [groups, N_pad, K_pad]: per group, output channel n
    and K index (dy * kw + dx) * ci_pg + c, zero padded to a multiple of 32 in
    K (so any channel count works, 3 and 4 included) and to the kernel's N
    tile in N.  Beside it, on the weights' device, the packing of the wgmma
    route the shape can take: 3x3 groups 1 (:func:`_pack_wgmma`), 1x1 groups
    1 (:func:`_pack_gemm`), grouped 3x3 in bands (:func:`_pack_banded`)."""
    if weight.dtype != torch.int8 or weight.ndim != 4:
        raise ValueError(f"pack_qconv2d_weights: weight must be int8 OIHW, got {weight.dtype} {tuple(weight.shape)}")
    c_out, ci_pg, kh, kw = weight.shape
    if groups <= 0 or c_out % groups:
        raise ValueError(f"pack_qconv2d_weights: {c_out} output channels do not split into {groups} groups")
    co_pg = c_out // groups
    tile_n = _tile_n(co_pg)
    k = kh * kw * ci_pg
    packed = torch.zeros(groups, -(-co_pg // tile_n) * tile_n, -(-k // _K_STEP) * _K_STEP, dtype=torch.int8,
                         device=weight.device)
    packed[:, :co_pg, :k] = weight.reshape(groups, co_pg, ci_pg, kh, kw).permute(0, 1, 3, 4, 2).reshape(groups, co_pg, k)
    wgmma = _pack_wgmma(weight) if (kh, kw, groups) == (3, 3, 1) else None
    gemm = _pack_gemm(weight) if (kh, kw, groups) == (1, 1, 1) else None
    banded = _pack_banded(weight, groups) if (kh, kw) == (3, 3) and _bands_fit(c_out, ci_pg, groups) else None
    return QConvWeight(weight.contiguous(), packed.contiguous(), int(groups), tile_n, wgmma, gemm, banded)


@functools.lru_cache(maxsize=None)
def _wgmma_chunks(c_in: int) -> tuple:
    """The K chunks of the wgmma routes as (first channel, width): 128
    channels each, then a remainder r as one 128-channel chunk (r > 96),
    64 + 32 (r > 64), 64 (r > 32) or 32, as ``csrc/qconv_wgmma.cu``
    ``chunks_of`` cuts it."""
    full, r = divmod(c_in, _WGMMA_CK)
    if r > 96:
        full, r = full + 1, 0
    chunks = [(_WGMMA_CK * k, _WGMMA_CK) for k in range(full)]
    c0 = _WGMMA_CK * full
    if r > 64:
        chunks += [(c0, 64), (c0 + 64, 32)]
    elif r:
        chunks.append((c0, 64 if r > 32 else 32))
    return tuple(chunks)


def _pack_wgmma(weight: torch.Tensor) -> torch.Tensor:
    """OIHW int8 [C_out, C_in, 3, 3] -> [NB, KC, 9, NT, 128] int8 for the
    wgmma routes: N block, K chunk (:func:`_wgmma_chunks`), tap (3 dy + dx),
    output channel in the block, the chunk's input channels in a 128-byte row
    (zero past the chunk's width and past C_in), each [NT, 128] slab with the
    128-byte swizzle applied (16-byte group g of row n stored at g ^ (n % 8)):
    what a wgmma B descriptor reads.  NT is K2's N tile: all of C_out up to
    256."""
    c_out, c_in = weight.shape[:2]
    nt = _wgmma_tile_n(c_out)
    nb, chunks = -(-c_out // nt), _wgmma_chunks(c_in)
    w = torch.zeros(nb * nt, len(chunks), _WGMMA_CK, 3, 3, dtype=torch.int8, device=weight.device)
    for k, (c0, width) in enumerate(chunks):
        n = min(width, c_in - c0)
        w[:c_out, k, :n] = weight[:, c0:c0 + n]
    w = w.reshape(nb, nt, len(chunks), _WGMMA_CK, 9).permute(0, 2, 4, 1, 3).contiguous()
    return _swizzle128(w.view(torch.int16)).view(torch.int8).contiguous()


def _unpack_wgmma(packed: torch.Tensor, c_in: int, c_out: int) -> torch.Tensor:
    """Inverse of :func:`_pack_wgmma`, as OIHW."""
    nb, kc, _, nt, _ = packed.shape
    w = _swizzle128(packed.view(torch.int16)).view(torch.int8)  # the swizzle is its own inverse
    w = w.permute(0, 3, 1, 4, 2).reshape(nb * nt, kc, _WGMMA_CK, 3, 3)
    return torch.cat([w[:c_out, k, :min(width, c_in - c0)] for k, (c0, width) in enumerate(_wgmma_chunks(c_in))],
                     dim=1)


def _pack_gemm(weight: torch.Tensor) -> torch.Tensor:
    """OIHW int8 [C_out, C_in, 1, 1] -> [KC, N_pad, 128] int8 for
    ``gemm_wgmma``: K chunk (:func:`_wgmma_chunks`), output channel (N_pad:
    C_out padded to a multiple of 128, so the slab of an N tile of 64 or 128
    channels is contiguous), the chunk's input channels in a 128-byte
    row (zero past the chunk's width and past C_in) with the 128-byte
    swizzle, as a wgmma B descriptor reads it."""
    c_out, c_in = weight.shape[:2]
    chunks = _wgmma_chunks(c_in)
    w = torch.zeros(len(chunks), -(-c_out // _GEMM_N_PAD) * _GEMM_N_PAD, _WGMMA_CK, dtype=torch.int8,
                    device=weight.device)
    for k, (c0, width) in enumerate(chunks):
        n = min(width, c_in - c0)
        w[k, :c_out, :n] = weight[:, c0:c0 + n, 0, 0]
    return _swizzle128(w.view(torch.int16)).view(torch.int8).contiguous()


def _unpack_gemm(packed: torch.Tensor, c_in: int, c_out: int) -> torch.Tensor:
    """Inverse of :func:`_pack_gemm`, as OIHW."""
    w = _swizzle128(packed.view(torch.int16)).view(torch.int8)
    return torch.cat([w[k, :c_out, :min(width, c_in - c0)] for k, (c0, width) in enumerate(_wgmma_chunks(c_in))],
                     dim=1)[:, :, None, None]


def _bands_fit(c_out: int, ci_pg: int, groups: int) -> bool:
    """Whether a grouped conv splits into ``grouped_wgmma``'s bands: as many
    output as input channels per group, a group width dividing 32, and C a
    multiple of 128 (one N block of four bands)."""
    return groups > 1 and c_out == ci_pg * groups and _BAND % ci_pg == 0 and c_out % _WGMMA_CK == 0


def _pack_banded(weight: torch.Tensor, groups: int) -> torch.Tensor:
    """OIHW int8 [C, C / groups, 3, 3] -> [C / 128, 9, 32, 128] int8 for
    ``grouped_wgmma``: 128-channel block, tap (3 dy + dx), output channel n of
    a 32-channel band, then the block's four bands' rows side by side: byte
    32 k + c of row n is the weight from input channel c to output channel n
    of band k (channels 128 block + 32 k + c and + n), zero where they lie in
    other groups: each band is one dense block-diagonal 32 x 32 conv.  The
    128-byte swizzle is applied per [32, 128] slab."""
    c, ci_pg = weight.shape[:2]
    dense = torch.zeros(c, _BAND, 3, 3, dtype=torch.int8, device=weight.device)  # [output, input in its band]
    first = (torch.arange(c, device=weight.device) // ci_pg * ci_pg) % _BAND  # the group's first input in the band
    for e in range(ci_pg):
        dense[torch.arange(c, device=weight.device), first + e] = weight[:, e]
    w = dense.reshape(c // _WGMMA_CK, _WGMMA_CK // _BAND, _BAND, _BAND, 9).permute(0, 4, 2, 1, 3)
    return _swizzle128(w.reshape(c // _WGMMA_CK, 9, _BAND, _WGMMA_CK).contiguous().view(torch.int16)).view(
        torch.int8).contiguous()


def _band_weights(packed: torch.Tensor) -> torch.Tensor:
    """The dense weights of each band of a :func:`_pack_banded` packing,
    [C / 32, 32 (output), 32 (input), 3, 3] int8: band j covers channels
    32 j .. 32 j + 31 on both sides."""
    nb = packed.shape[0]
    w = _swizzle128(packed.view(torch.int16)).view(torch.int8).reshape(nb, 3, 3, _BAND, _WGMMA_CK // _BAND, _BAND)
    return w.permute(0, 4, 3, 5, 1, 2).reshape(nb * _WGMMA_CK // _BAND, _BAND, _BAND, 3, 3)


def _unpack_banded(packed: torch.Tensor, groups: int) -> torch.Tensor:
    """Inverse of :func:`_pack_banded`, as OIHW [C, C / groups, 3, 3]."""
    bands = _band_weights(packed)
    c = bands.shape[0] * _BAND
    ci_pg = c // groups
    dense = bands.reshape(c, _BAND, 3, 3)
    first = (torch.arange(c, device=packed.device) // ci_pg * ci_pg) % _BAND
    return torch.stack([dense[torch.arange(c, device=packed.device), first + e] for e in range(ci_pg)], dim=1)


def _conv_route(c_in: int, c_out: int, kernel: Sequence[int], stride: int, padding: Sequence[int], groups: int,
                x_addr: int) -> str:
    """Q1's route for a call: the one place the rule lives.

    - ``tma_wgmma`` / ``ld_wgmma``: the 3x3 stride-1 convs with pads
      (1, 1, 1, 1) and groups 1, by TMA where C_in % 16 == 0 and x is 16-byte
      aligned (a tensor map needs 16-byte strides), else through the
      producer's loads (the 3-channel stem);
    - ``gemm_wgmma``: the 1x1 convs with groups 1, stride 1 or 2, no padding,
      C_in % 16 == 0 and x 16-byte aligned;
    - ``grouped_wgmma``: the grouped 3x3 convs whose weights split into bands
      (:func:`_bands_fit`: C_in = C_out a multiple of 128, a group width
      dividing 32), stride 1 with pads (1, 1, 1, 1) or stride 2 with
      (1, 1, 1, 1) or (0, 1, 0, 1) (flax ``SAME``), x 16-byte aligned;
    - every other conv (the 7x7 stem, dense strided 3x3 convs, other pads,
      widths or strides, unaligned x) takes the mma.sync kernel with the widest
      gather of x that C_in, C_in / groups and x's alignment allow:
      ``mma_v16``, ``mma_v4``, ``mma_v1``."""
    kernel, padding, ci_pg = tuple(kernel), tuple(padding), c_in // groups
    aligned = x_addr % 16 == 0
    if kernel == (3, 3) and stride == 1 and padding == (1, 1, 1, 1) and groups == 1:
        return "tma_wgmma" if c_in % 16 == 0 and aligned else "ld_wgmma"
    if kernel == (1, 1) and groups == 1 and stride in (1, 2) and padding == (0, 0, 0, 0) and c_in % 16 == 0 and aligned:
        return "gemm_wgmma"
    if (kernel == (3, 3) and padding in _GROUPED_PADS.get(stride, ()) and _bands_fit(c_out, ci_pg, groups)
            and aligned):
        return "grouped_wgmma"
    for width in (16, 4):
        if ci_pg % width == 0 and c_in % width == 0 and x_addr % width == 0:
            return f"mma_v{width}"
    return "mma_v1"


def _per_channel(t: torch.Tensor) -> torch.Tensor:
    return t.view(1, -1, 1, 1)


def _requant(acc: torch.Tensor, epilogue: str, bias, relu: bool, rnd, shift, mult, clamp) -> torch.Tensor:
    """The integer epilogue on an int32 accumulator, in int32 torch ops."""
    if epilogue == "acc":
        return acc
    v = acc + _per_channel(bias)
    if relu:
        v = torch.clamp_min(v, 0)
    return _to_int8(v, epilogue, rnd, shift, mult, clamp)


def _to_int8(v: torch.Tensor, epilogue: str, rnd, shift, mult, clamp) -> torch.Tensor:
    """The requant to int8 of a biased int32 accumulator: ``"shift"`` or ``"mul"``."""
    if epilogue == "shift":
        v = (v + _per_channel(rnd)) >> _per_channel(shift)
    else:
        c = _per_channel(clamp)
        v = torch.minimum(torch.maximum(v, -c), c) * _per_channel(mult)
        v = (v + (1 << (_MUL_SHIFT - 1))) >> _MUL_SHIFT
    return v.clamp(-_QMAX, _QMAX).to(torch.int8)


_EPILOGUE_OPERANDS = {"acc": (), "shift": ("bias", "rnd", "shift"), "mul": ("bias", "mult", "clamp")}


def _check_epilogue(epilogue, c_out, x: torch.Tensor, **params):
    """The epilogue's per-channel operands: contiguous int32 [C_out] tensors
    on x's device.  Devices are compared by index (``get_device``), which
    costs the host less than ``torch.device`` objects on every call."""
    if epilogue not in _EPILOGUE_OPERANDS:
        raise ValueError(f"epilogue must be one of {_EPILOGUES}, got {epilogue!r}")
    device = x.get_device()
    for name in _EPILOGUE_OPERANDS[epilogue]:
        t = params[name]
        if (not isinstance(t, torch.Tensor) or t.dtype != torch.int32 or t.shape != (c_out,)
                or not t.is_contiguous() or t.get_device() != device or t.is_cuda != x.is_cuda):
            raise ValueError(f"qconv2d: epilogue {epilogue!r} needs {name} as a contiguous int32 [{c_out}] "
                             f"tensor on {x.device}")


def qconv2d_reference(x: torch.Tensor, weight: torch.Tensor, stride: int = 1,
                      padding: Sequence[int] = (0, 0, 0, 0), groups: int = 1, epilogue: str = "acc",
                      bias: Optional[torch.Tensor] = None, relu: bool = False,
                      rnd: Optional[torch.Tensor] = None, shift: Optional[torch.Tensor] = None,
                      mult: Optional[torch.Tensor] = None, clamp: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of :func:`qconv2d`, with OIHW int8 ``weight``.

    The sum runs as ``F.conv2d`` in float64 on the int8 values, which is
    exact: at most 4608 terms of at most 127^2 stay under 2^53 (float32 is
    not: such sums pass 2^24).  It is cast to int32 and the epilogue runs in
    int32 torch ops.  ``padding`` is (top, bottom, left, right)."""
    top, bottom, left, right = padding
    xd = F.pad(x.double(), (left, right, top, bottom))
    acc = F.conv2d(xd, weight.double(), stride=stride, groups=groups).to(torch.int32)
    out = _requant(acc, epilogue, bias, relu, rnd, shift, mult, clamp)
    return out.contiguous(memory_format=_CL)


def qconv2d(x: torch.Tensor, weight: QConvWeight, stride: int = 1, padding: Sequence[int] = (0, 0, 0, 0),
            epilogue: str = "acc", bias: Optional[torch.Tensor] = None, relu: bool = False,
            rnd: Optional[torch.Tensor] = None, shift: Optional[torch.Tensor] = None,
            mult: Optional[torch.Tensor] = None, clamp: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int8 convolution with an int32 accumulator and a fused integer epilogue.

    Args:
        x: [B, C_in, H, W] int8, ``torch.channels_last`` contiguous.
        weight: from :func:`pack_qconv2d_weights` (carries ``groups``).
        stride: the stride of both axes.
        padding: explicit zero padding (top, bottom, left, right).
        epilogue: ``"acc"``: the raw int32 accumulator; ``"shift"``:
            ``clip((relu?(acc + bias) + rnd) >> shift, +-127)``; ``"mul"``:
            ``clip((clamp(relu?(acc + bias), +-clamp) * mult + 2^22) >> 23,
            +-127)``.  The per-channel operands are contiguous int32
            [C_out] tensors on x's device.
    Returns:
        [B, C_out, Ho, Wo], int8 (int32 for ``"acc"``), ``torch.channels_last``.

    CPU tensors take :func:`qconv2d_reference`; CUDA tensors launch Q1 on the
    route :func:`_conv_route` picks, counted in ``qconv2d.launches`` and
    ``qconv2d.launches_by_route``; under a profiler the host's whole path of
    a CUDA call is the span ``q1.call`` (``utils.profiling``).
    """
    with span("q1.call", device=False) if x.is_cuda else contextlib.nullcontext():
        return _qconv2d(x, weight, stride, padding, epilogue, bias, relu, rnd, shift, mult, clamp)


def _qconv2d(x, weight, stride, padding, epilogue, bias, relu, rnd, shift, mult, clamp) -> torch.Tensor:
    if x.ndim != 4 or x.dtype != torch.int8 or not x.is_contiguous(memory_format=_CL):
        raise ValueError(f"qconv2d: x must be a channels_last int8 [B, C, H, W] tensor, got {x.dtype} {tuple(x.shape)}")
    if not isinstance(weight, QConvWeight):
        raise ValueError("qconv2d: weight must come from pack_qconv2d_weights")
    b, c_in, h, w = x.shape
    c_out, ci_pg, kh, kw = weight.weight.shape
    groups = weight.groups
    if ci_pg * groups != c_in:
        raise ValueError(f"qconv2d: weights take {ci_pg * groups} input channels, x has {c_in}")
    top, bottom, left, right = (int(p) for p in padding)
    if min(top, bottom, left, right) < 0 or stride <= 0:
        raise ValueError(f"qconv2d: padding {tuple(padding)} and stride {stride} must be >= 0 and > 0")
    ho = (h + top + bottom - kh) // stride + 1
    wo = (w + left + right - kw) // stride + 1
    if ho <= 0 or wo <= 0:
        raise ValueError(f"qconv2d: a {kh}x{kw} kernel does not fit a padded {h}x{w} input")
    params = dict(bias=bias, rnd=rnd, shift=shift, mult=mult, clamp=clamp)
    _check_epilogue(epilogue, c_out, x, **params)
    index = x.get_device()  # -1 on the CPU
    if any(isinstance(t, torch.Tensor) and (t.get_device() != index or t.is_cuda != x.is_cuda) for t in weight):
        raise ValueError("qconv2d: x and the weights must be on one device")

    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"qconv2d: unsupported device {x.device}")
        return qconv2d_reference(x, weight.weight, stride, (top, bottom, left, right), groups, epilogue, relu=relu,
                                 **params)
    out_dtype = torch.int32 if epilogue == "acc" else torch.int8
    y = x.new_empty((b, ho, wo, c_out), dtype=out_dtype).permute(0, 3, 1, 2)  # channels_last
    mode = _EPILOGUES.index(epilogue)
    p0, p1 = (rnd, shift) if epilogue == "shift" else (mult, clamp)
    ptr = lambda t: 0 if t is None or mode == 0 else t.data_ptr()  # noqa: E731
    route = _conv_route(c_in, c_out, (kh, kw), stride, (top, bottom, left, right), groups, x.data_ptr())
    _, n_pad, k_pad = weight.packed.shape
    packed, tile_n = weight.packed, weight.tile_n
    if route.endswith("wgmma"):
        tile_n = _wgmma_tile_n(c_out)
        if route == "gemm_wgmma":
            packed, n_pad = weight.gemm, -(-c_out // _GEMM_N_PAD) * _GEMM_N_PAD
            expect = (len(_wgmma_chunks(c_in)), n_pad, _WGMMA_CK)
        elif route == "grouped_wgmma":
            packed, expect = weight.banded, (c_in // _WGMMA_CK, 9, _BAND, _WGMMA_CK)
        else:
            packed, expect = weight.wgmma, (-(-c_out // tile_n), len(_wgmma_chunks(c_in)), 9, tile_n, _WGMMA_CK)
        if packed is None or packed.dtype != torch.int8 or packed.shape != expect or not packed.is_contiguous():
            raise ValueError(f"qconv2d: the {route} route needs its packing of the weights, contiguous int8 {expect} "
                             "(pack_qconv2d_weights)")
    err = _build.library().ptt_qconv2d(
        index, x.data_ptr(), packed.data_ptr(), ptr(bias), ptr(p0), ptr(p1), y.data_ptr(),
        b, h, w, c_in, ho, wo, c_out, groups, kh, kw, stride, top, left, k_pad, n_pad, tile_n, mode,
        int(relu), _CONV_ROUTES.index(route), _build.stream_of(index))
    _build.check(err, f"qconv2d ({route})")
    qconv2d.launches += 1
    qconv2d.launches_by_route[route] += 1
    return y


qconv2d.launches = 0
qconv2d.launches_by_route = dict.fromkeys(_CONV_ROUTES, 0)


def _as_int8_matrix(m) -> np.ndarray:
    if isinstance(m, torch.Tensor):
        m = m.detach().cpu().numpy()
    m = np.asarray(m)
    if m.ndim != 2 or m.dtype != np.int8:
        raise ValueError(f"q_upsample: interpolation matrices must be 2-D int8, got {m.dtype} {m.shape}")
    return m


def upsample_taps(m, device) -> torch.Tensor:
    """[rows, 4] int32 (i0, i1, m0, m1) on ``device``: the two taps of each
    row of an int8 [rows, cols] interpolation matrix (m1 = 0 where it has
    one), as :func:`q_upsample` takes them."""
    m = _as_int8_matrix(m)
    taps = np.zeros((m.shape[0], 4), np.int32)
    for o in range(m.shape[0]):
        nz = np.flatnonzero(m[o])
        if nz.size > 2:
            raise ValueError(f"q_upsample: row {o} of an interpolation matrix has {nz.size} nonzero taps (at most 2)")
        if nz.size:
            taps[o, 0], taps[o, 1] = nz[0], nz[-1]
            taps[o, 2] = m[o, nz[0]]
            taps[o, 3] = m[o, nz[-1]] if nz.size == 2 else 0
    return torch.from_numpy(taps).to(device)


def _requant7(v: torch.Tensor) -> torch.Tensor:
    return ((v + 64) >> 7).clamp(-_QMAX, _QMAX).to(torch.int8)


def q_upsample_reference(x: torch.Tensor, mh, mw) -> torch.Tensor:
    """Plain version of :func:`q_upsample`: the two einsums against the int8
    matrices, in float64 (exact: at most H terms of 127^2 each), cast to
    int32, each followed by the int32 requant ``clip((v + 64) >> 7, +-127)``."""
    mh = torch.as_tensor(_as_int8_matrix(mh).astype(np.float64), device=x.device)
    mw = torch.as_tensor(_as_int8_matrix(mw).astype(np.float64), device=x.device)
    rows = _requant7(torch.einsum("nchw,oh->ncow", x.double(), mh).to(torch.int32))
    cols = _requant7(torch.einsum("nchw,ow->ncho", rows.double(), mw).to(torch.int32))
    return cols.contiguous(memory_format=_CL)


def q_upsample_cat_reference(x: torch.Tensor, skip: torch.Tensor, mh, mw) -> torch.Tensor:
    """Plain version of :func:`q_upsample_cat`: :func:`q_upsample_reference`,
    then ``torch.cat`` with the skip."""
    return torch.cat([q_upsample_reference(x, mh, mw), skip], dim=1).contiguous(memory_format=_CL)


def _tap_span(m: np.ndarray, n: int) -> int:
    """The most input rows that n consecutive output rows of an aligned block
    reach through the taps of ``m`` (the first and last nonzero of each row,
    column 0 for a row of zeros, as :func:`upsample_taps` takes them)."""
    nz = m != 0
    first, last = nz.argmax(axis=1), (nz * np.arange(m.shape[1])).max(axis=1)
    pad = -len(first) % n
    first = np.pad(first, (0, pad), mode="edge").reshape(-1, n)
    last = np.pad(last, (0, pad), mode="edge").reshape(-1, n)
    return int((last.max(axis=1) - first.min(axis=1)).max()) + 1


_BAND_TILES = {}  # (id(mh), id(mw), C) -> (mh, mw, tile) of read-only matrices, the int8 forwards' cached ones


def _band_tile(c: int, mh: np.ndarray, mw: np.ndarray):
    """(R, P, RW, WW) of the banded route: a block's output rows and columns
    and the most input rows and columns their taps reach; None where no tile
    fits in a block's shared memory (``band_smem`` in ``csrc/q_upsample.cu``).
    A band row holds about 4 KiB of output channels: 16 columns at 256
    channels, 64 at 64 and fewer.  Kept per pair of read-only matrices (each
    entry holds its matrices, so their ids stay theirs)."""
    key = (id(mh), id(mw), c)
    hit = _BAND_TILES.get(key)
    if hit is not None and hit[0] is mh and hit[1] is mw:
        return hit[2]
    rows = min(_BAND_ROWS, mh.shape[0])
    cols = min(mw.shape[0], _BAND_MAX_COLS, max(_BAND_MIN_COLS, _BAND_ROW_BYTES // c))
    while True:
        rw, ww = _tap_span(mh, rows), _tap_span(mw, cols)
        if 16 + 16 * (rows + cols) + (rw + rows) * ww * c <= _BAND_SMEM:
            tile = rows, cols, rw, ww
            break
        if cols > 1:
            cols //= 2
        elif rows > 1:
            rows //= 2
        else:
            tile = None
            break
    if not (mh.flags.writeable or mw.flags.writeable):
        if len(_BAND_TILES) >= 256:
            _BAND_TILES.clear()
        _BAND_TILES[key] = (mh, mw, tile)
    return tile


def _upsample_route(c: int, cs: int, addrs: Sequence[int], mh: np.ndarray, mw: np.ndarray):
    """Q2's route for a call, and the banded route's tile: the one place the
    rule lives.  ``banded`` takes every call whose channel counts (C, and Cs
    of the skip where there is one) are multiples of 16 on 16-byte aligned
    tensors, where a tile of the taps fits in shared memory (every bilinear
    resize); the per-pixel kernel takes the rest, 4 channels per thread
    (``v4``) where C, Cs and the addresses allow it, else one (``v1``)."""
    if c % 16 == 0 and cs % 16 == 0 and all(a % 16 == 0 for a in addrs):
        tile = _band_tile(c, mh, mw)
        if tile is not None and _BAND_ROWS * mw.shape[0] * (c + cs) < 2**31:
            return "banded", tile
    if c % 4 == 0 and cs % 4 == 0 and all(a % 4 == 0 for a in addrs):
        return "v4", None
    return "v1", None


def _check_upsample_input(x: torch.Tensor, mh, mw, name: str):
    if x.ndim != 4 or x.dtype != torch.int8 or not x.is_contiguous(memory_format=_CL):
        raise ValueError(f"{name}: x must be a channels_last int8 [B, C, H, W] tensor, got {x.dtype} {tuple(x.shape)}")
    mh, mw = _as_int8_matrix(mh), _as_int8_matrix(mw)
    if mh.shape[1] != x.shape[2] or mw.shape[1] != x.shape[3]:
        raise ValueError(f"{name}: matrices {mh.shape} and {mw.shape} do not fit a {x.shape[2]}x{x.shape[3]} input")
    return mh, mw


def _launch_upsample(x: torch.Tensor, skip: Optional[torch.Tensor], mh: np.ndarray, mw: np.ndarray, taps,
                     name: str):
    """Q2 on the card: [B, C (+ Cs), OH, OW] channels_last int8, and the route it took."""
    b, c, h, w = x.shape
    oh, ow = mh.shape[0], mw.shape[0]
    rows, cols = taps if taps is not None else (upsample_taps(mh, x.device), upsample_taps(mw, x.device))
    if any(t.shape != (n, 4) or t.dtype != torch.int32 or not t.is_contiguous() or t.device != x.device
           for t, n in ((rows, oh), (cols, ow))):
        raise ValueError(f"{name}: taps must be contiguous int32 [{oh}, 4] and [{ow}, 4] tensors on {x.device}")
    cs = 0 if skip is None else skip.shape[1]
    y = torch.empty(b, c + cs, oh, ow, dtype=torch.int8, device=x.device, memory_format=_CL)
    skip_ptr = skip.data_ptr() if cs else 0
    route, tile = _upsample_route(c, cs, (x.data_ptr(), y.data_ptr()) + ((skip_ptr,) if cs else ()), mh, mw)
    err = _build.library().ptt_q_upsample(
        x.device.index, x.data_ptr(), skip_ptr, y.data_ptr(), rows.data_ptr(), cols.data_ptr(), b, h, w, c, cs, oh,
        ow, _UPSAMPLE_ROUTES.index(route), (ctypes.c_int * 4)(*(tile or (0, 0, 0, 0))), _build.stream_of(x.device))
    _build.check(err, f"{name} ({route})")
    return y, route


def q_upsample(x: torch.Tensor, mh, mw, taps=None) -> torch.Tensor:
    """Requantized int8 bilinear resize with quantized interpolation matrices.

    Args:
        x: [B, C, H, W] int8, ``torch.channels_last`` contiguous.
        mh, mw: int8 [OH, H] and [OW, W] matrices (numpy arrays), at most two
            nonzero entries per row, as ``zoo/quantized_unet.py``
            ``_q_upsample_matrices`` builds them.
        taps: ``(upsample_taps(mh, x.device), upsample_taps(mw, x.device))``
            made once by the caller, or None to make them from the matrices
            in this call.
    Returns:
        [B, C, OH, OW] int8, ``torch.channels_last``:
        ``clip((mw @ clip((mh @ x + 64) >> 7) + 64) >> 7)`` per channel.

    CPU tensors take :func:`q_upsample_reference`; CUDA tensors launch Q2 on
    the route :func:`_upsample_route` picks, counted in
    ``q_upsample.launches`` and ``q_upsample.launches_by_route``.
    """
    mh, mw = _check_upsample_input(x, mh, mw, "q_upsample")
    if x.device.type == "cpu":
        return q_upsample_reference(x, mh, mw)
    if x.device.type != "cuda":
        raise ValueError(f"q_upsample: unsupported device {x.device}")
    y, route = _launch_upsample(x, None, mh, mw, taps, "q_upsample")
    q_upsample.launches += 1
    q_upsample.launches_by_route[route] += 1
    return y


q_upsample.launches = 0
q_upsample.launches_by_route = dict.fromkeys(_UPSAMPLE_ROUTES, 0)


def q_upsample_cat(x: torch.Tensor, skip: torch.Tensor, mh, mw, taps=None) -> torch.Tensor:
    """The int8 decoder input: :func:`q_upsample` of ``x`` joined to ``skip``
    along the channels, written at once.

    Args:
        x, mh, mw, taps: as :func:`q_upsample`.
        skip: [B, Cs, OH, OW] int8, ``torch.channels_last`` contiguous, on x's
            device.
    Returns:
        [B, C + Cs, OH, OW] int8, ``torch.channels_last``:
        ``torch.cat([q_upsample(x, mh, mw), skip], 1)``.

    CPU tensors take :func:`q_upsample_cat_reference`; CUDA tensors launch Q2
    with the skip on the route :func:`_upsample_route` picks, counted in
    ``q_upsample_cat.launches`` and ``q_upsample_cat.launches_by_route``.
    """
    mh, mw = _check_upsample_input(x, mh, mw, "q_upsample_cat")
    want = (x.shape[0], mh.shape[0], mw.shape[0])
    if (skip.ndim != 4 or skip.dtype != torch.int8 or not skip.is_contiguous(memory_format=_CL)
            or (skip.shape[0], *skip.shape[2:]) != want or skip.device != x.device):
        raise ValueError(f"q_upsample_cat: skip must be a channels_last int8 [{want[0]}, Cs, {want[1]}, {want[2]}] "
                         f"tensor on {x.device}, got {skip.dtype} {tuple(skip.shape)} on {skip.device}")
    if x.device.type == "cpu":
        return q_upsample_cat_reference(x, skip, mh, mw)
    if x.device.type != "cuda":
        raise ValueError(f"q_upsample_cat: unsupported device {x.device}")
    y, route = _launch_upsample(x, skip, mh, mw, taps, "q_upsample_cat")
    q_upsample_cat.launches += 1
    q_upsample_cat.launches_by_route[route] += 1
    return y


q_upsample_cat.launches = 0
q_upsample_cat.launches_by_route = dict.fromkeys(_UPSAMPLE_ROUTES, 0)


def _add_route(c: int, addrs: Sequence[int]) -> str:
    """Q3's route for a call: the one place the rule lives.  ``vec16`` (16
    channels a thread, 16-byte loads and stores) where C % 16 == 0 and every
    tensor it touches starts on a 16-byte boundary; ``scalar`` (one thread an
    element) otherwise."""
    return "vec16" if c % 16 == 0 and all(a % 16 == 0 for a in addrs) else "scalar"


def q_add_reference(a: torch.Tensor, b: torch.Tensor, ma: torch.Tensor, mb: torch.Tensor, relu: bool,
                    gate: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of :func:`q_add`, in int32 torch ops."""
    s = a.to(torch.int32)
    if gate is not None:
        s = ((s * gate[:, :, None, None] + (1 << (_GATE_SHIFT - 1))) >> _GATE_SHIFT).clamp(-_QMAX, _QMAX)
    acc = s * _per_channel(ma) + b.to(torch.int32) * _per_channel(mb)
    if relu:
        acc = torch.clamp_min(acc, 0)
    out = ((acc + (1 << (_ADD_SHIFT - 1))) >> _ADD_SHIFT).clamp(-_QMAX, _QMAX).to(torch.int8)
    return out.contiguous(memory_format=_CL)


def q_add(a: torch.Tensor, b: torch.Tensor, ma: torch.Tensor, mb: torch.Tensor, relu: bool,
          gate: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Requantized int8 add of two int8 maps, the first optionally SE-excited.

    Args:
        a, b: [B, C, H, W] int8, ``torch.channels_last`` contiguous, of one
            shape and on one device.
        ma, mb: contiguous int32 [C]: each addend's fixed-point multiplier
            onto the sum's scale (``2^12`` is 1).
        relu: floor the sum at 0.
        gate: None, or a contiguous int32 [B, C]: the SE gate of ``a`` as
            ``round(gate * 2^14)``.
    Returns:
        [B, C, H, W] int8, ``torch.channels_last``:
        ``s = clip((a * gate + 2^13) >> 14, +-127)`` (``s = a`` without a
        gate), ``acc = s * ma + b * mb``, ``max(acc, 0)`` with ``relu``, then
        ``clip((acc + 2^11) >> 12, +-127)``, per channel, in int32.  The kernel
        equals this bit for bit wherever ``|s * ma + b * mb| + 2^11 < 2^31``,
        which multipliers within [-2^22, 2^22] guarantee.

    CPU tensors take :func:`q_add_reference`; CUDA tensors launch Q3 on the
    route :func:`_add_route` picks, counted in ``q_add.launches``,
    ``q_add.launches_by_route`` and ``q_add.gated`` (launches with a gate).
    """
    index, cuda = a.get_device(), a.is_cuda  # devices compared by index: cheaper on the host than torch.device
    if (a.ndim != 4 or a.dtype != torch.int8 or not a.is_contiguous(memory_format=_CL) or b.dtype != torch.int8
            or b.shape != a.shape or not b.is_contiguous(memory_format=_CL) or b.get_device() != index
            or b.is_cuda != cuda):
        raise ValueError(f"q_add: a and b must be channels_last int8 [B, C, H, W] tensors of one shape on one "
                         f"device, got {a.dtype} {tuple(a.shape)} on {a.device} and {b.dtype} {tuple(b.shape)} on "
                         f"{b.device}")
    n, c, h, w = a.shape
    for name, t, shape in (("ma", ma, (c,)), ("mb", mb, (c,)), ("gate", gate, (n, c))):
        if t is None and name == "gate":
            continue
        if (not isinstance(t, torch.Tensor) or t.dtype != torch.int32 or t.shape != shape or not t.is_contiguous()
                or t.get_device() != index or t.is_cuda != cuda):
            raise ValueError(f"q_add: {name} must be a contiguous int32 {list(shape)} tensor on {a.device}")
    if not cuda:
        if a.device.type != "cpu":
            raise ValueError(f"q_add: unsupported device {a.device}")
        return q_add_reference(a, b, ma, mb, relu, gate)
    y = torch.empty_like(a, memory_format=_CL)
    ptrs = [t.data_ptr() for t in (a, b, ma, mb, y)] + ([] if gate is None else [gate.data_ptr()])
    route = _add_route(c, ptrs)
    err = _build.library().ptt_q_add(index, *ptrs[:4], 0 if gate is None else ptrs[5], ptrs[4], n, h * w, c,
                                     int(relu), _ADD_ROUTES.index(route), _build.stream_of(index))
    _build.check(err, f"q_add ({route})")
    q_add.launches += 1
    q_add.launches_by_route[route] += 1
    q_add.gated += gate is not None
    return y


q_add.launches = 0
q_add.launches_by_route = dict.fromkeys(_ADD_ROUTES, 0)
q_add.gated = 0
