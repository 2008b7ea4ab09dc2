"""Plain PyTorch and NumPy pieces that the references of every configuration
share: the integer conv and upsample, the requants, the calibration
arithmetic, the tile geometry, the d4 views and the merges.

Each is a frozen copy of the port's plain version, cited by file and line
(``pytorch_toolbelt_tpu_torch/...`` at the commit that added this file), so
that a change to the program cannot change what it is compared with.  This
module imports nothing of the program and nothing of JAX.

``qmax`` is the largest quantized magnitude: 127 for int8, the precision
the configurations state; 7 (int4) for the control, which must come out
not correct.
"""

import math
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

QMAX = 127
MUL_SHIFT = 23  # ops/quantized.py:62
NORM_EPS = float(np.finfo(np.float64).eps)  # ops/tile_merge.py:42
CL = torch.channels_last


# ---- the integer conv and upsample (ops/quantized.py) ---------------------


def per_channel(t: torch.Tensor) -> torch.Tensor:
    return t.view(1, -1, 1, 1)


def to_int8(v: torch.Tensor, epilogue: str, rnd, shift, mult, clamp, qmax: int = QMAX) -> torch.Tensor:
    """ops/quantized.py:282 ``_to_int8``: the requant of a biased int32 accumulator."""
    if epilogue == "shift":
        v = (v + per_channel(rnd)) >> per_channel(shift)
    else:
        c = per_channel(clamp)
        v = torch.minimum(torch.maximum(v, -c), c) * per_channel(mult)
        v = (v + (1 << (MUL_SHIFT - 1))) >> MUL_SHIFT
    return v.clamp(-qmax, qmax).to(torch.int8)


def requant(acc, epilogue, bias, relu, rnd, shift, mult, clamp, qmax: int = QMAX) -> torch.Tensor:
    """ops/quantized.py:272 ``_requant``: the integer epilogue in int32 torch ops."""
    if epilogue == "acc":
        return acc
    v = acc + per_channel(bias)
    if relu:
        v = torch.clamp_min(v, 0)
    return to_int8(v, epilogue, rnd, shift, mult, clamp, qmax)


def qconv2d(x: torch.Tensor, weight: torch.Tensor, stride: int = 1, padding: Sequence[int] = (0, 0, 0, 0),
            groups: int = 1, epilogue: str = "acc", bias=None, relu: bool = False, rnd=None, shift=None, mult=None,
            clamp=None, qmax: int = QMAX) -> torch.Tensor:
    """ops/quantized.py:311 ``qconv2d_reference``: the int8 conv as a float64
    ``F.conv2d`` on the int8 values (exact: at most 4608 terms of 127^2 stay
    under 2^53), cast to int32, then the int32 epilogue.  ``weight`` is OIHW
    int8, ``padding`` (top, bottom, left, right)."""
    top, bottom, left, right = padding
    xd = F.pad(x.double(), (left, right, top, bottom))
    acc = F.conv2d(xd, weight.double(), stride=stride, groups=groups).to(torch.int32)
    return requant(acc, epilogue, bias, relu, rnd, shift, mult, clamp, qmax).contiguous(memory_format=CL)


def _requant7(v: torch.Tensor, qmax: int) -> torch.Tensor:
    return ((v + 64) >> 7).clamp(-qmax, qmax).to(torch.int8)


def q_upsample(x: torch.Tensor, mh: np.ndarray, mw: np.ndarray, qmax: int = QMAX) -> torch.Tensor:
    """ops/quantized.py:443 ``q_upsample_reference``: two float64 einsums
    against the int8 interpolation matrices, each followed by the int32
    requant ``clip((v + 64) >> 7)``."""
    mh = torch.as_tensor(mh.astype(np.float64), device=x.device)
    mw = torch.as_tensor(mw.astype(np.float64), device=x.device)
    rows = _requant7(torch.einsum("nchw,oh->ncow", x.double(), mh).to(torch.int32), qmax)
    cols = _requant7(torch.einsum("nchw,ow->ncho", rows.double(), mw).to(torch.int32), qmax)
    return cols.contiguous(memory_format=CL)


def q_upsample_cat(x, skip, mh, mw, qmax: int = QMAX) -> torch.Tensor:
    """ops/quantized.py:454 ``q_upsample_cat_reference``."""
    return torch.cat([q_upsample(x, mh, mw, qmax), skip], dim=1).contiguous(memory_format=CL)


# ---- calibration arithmetic (zoo/quantized_unet.py) ------------------------


def linear_weights(in_size: int, out_size: int, align_corners: bool, dtype) -> np.ndarray:
    """nn/functional.py:31 ``_linear_weights``: one axis of a bilinear resize."""
    if out_size == in_size:
        return np.eye(in_size, dtype=dtype)
    if align_corners and out_size > 1:
        src = np.arange(out_size, dtype=np.float64) * ((in_size - 1) / (out_size - 1))
    elif align_corners:
        src = np.zeros((1,), dtype=np.float64)
    else:
        scale = in_size / out_size
        src = np.maximum((np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5, 0.0)
    i0 = np.clip(np.floor(src).astype(np.int32), 0, in_size - 1)
    i1 = np.minimum(i0 + 1, in_size - 1)
    frac = (src - i0).astype(np.float64)
    w = np.zeros((out_size, in_size), dtype=np.float64)
    rows = np.arange(out_size)
    np.add.at(w, (rows, i0), 1.0 - frac)
    np.add.at(w, (rows, i1), frac)
    return w.astype(dtype)


def resize_matmul(x: torch.Tensor, out_hw, align_corners: bool) -> torch.Tensor:
    """zoo/quantized_unet.py:236 ``_resize_matmul``: a separable bilinear
    resize as two products with the axes' float32 matrices."""
    wh = torch.as_tensor(linear_weights(x.shape[2], out_hw[0], align_corners, np.float32), device=x.device)
    ww = torch.as_tensor(linear_weights(x.shape[3], out_hw[1], align_corners, np.float32), device=x.device)
    return torch.matmul(torch.matmul(wh, x), ww.t())


def q_upsample_matrices(in_h: int, in_w: int, out_h: int, out_w: int):
    """zoo/quantized_unet.py:169 ``_q_upsample_matrices``: the int8
    align_corners bilinear matrices round(M * 127)."""
    mh = np.round(linear_weights(in_h, out_h, True, np.float64) * QMAX).astype(np.int8)
    mw = np.round(linear_weights(in_w, out_w, True, np.float64) * QMAX).astype(np.int8)
    return mh, mw


UP_MULT = (128.0 / QMAX) ** 2  # the two x127 passes and >>7 requants of an upsample scale sigma by this


def quantize_conv(w_eff, bias, amax_real, qmax: int = QMAX):
    """zoo/quantized_unet.py:62 ``_quantize_conv``: per-output-channel int8
    weights and the shift epilogue.  Returns (w_q HWIO int8, b_q, shift,
    rnd, sigma_out)."""
    w_eff, bias, amax_real = (np.asarray(a, np.float64) for a in (w_eff, bias, amax_real))
    sw = np.maximum(np.abs(w_eff).max(axis=(0, 1, 2)) / qmax, 1e-12)
    w_q = np.clip(np.round(w_eff / sw), -qmax, qmax).astype(np.int8)
    b_q = np.round(bias / sw).astype(np.int64).clip(-(2**31), 2**31 - 1).astype(np.int32)
    amax_int = amax_real / sw
    shift = np.ceil(np.log2(np.maximum(amax_int / qmax, 1.0))).astype(np.int32)
    rnd = np.where(shift > 0, (1 << np.maximum(shift - 1, 0)), 0).astype(np.int32)
    return w_q, b_q, shift, rnd, sw * np.exp2(shift)


def quantize_conv_mul(w_eff, bias, amax_real, qmax: int = QMAX):
    """zoo/quantized_unet.py:90 ``_quantize_conv_mul``: the multiply+shift
    epilogue.  Returns (w_q HWIO int8, b_q, mult, clamp, sigma_out)."""
    w_eff, bias, amax_real = (np.asarray(a, np.float64) for a in (w_eff, bias, amax_real))
    sw = np.maximum(np.abs(w_eff).max(axis=(0, 1, 2)) / qmax, 1e-12)
    w_q = np.clip(np.round(w_eff / sw), -qmax, qmax).astype(np.int8)
    b_q = np.round(bias / sw).astype(np.int64).clip(-(2**31), 2**31 - 1).astype(np.int32)
    amax_int = np.maximum(amax_real / sw, 1.0)
    mult = np.maximum(np.round(qmax / amax_int * (1 << MUL_SHIFT)), 1.0)
    clamp = np.floor((2.0**31 - 1 - (1 << (MUL_SHIFT - 1))) / mult)
    return w_q, b_q, mult.astype(np.int32), clamp.astype(np.int32), sw * float(1 << MUL_SHIFT) / mult


def int32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a, np.int32), device=device)


def oihw(w_q_hwio: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(np.asarray(w_q_hwio, np.int8).transpose(3, 2, 0, 1)), device=device)


def hwio(weight: torch.Tensor) -> np.ndarray:
    """zoo/quantized_unet.py:215 ``_hwio``."""
    return weight.detach().cpu().numpy().transpose(2, 3, 1, 0).astype(np.float64)


def same_padding(size: int, kernel: int, stride: int = 1) -> Tuple[int, int]:
    """nn/simple.py:21 ``_same_padding``: flax ``SAME`` of one axis."""
    total = max((math.ceil(size / stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class full_fp32:
    """zoo/quantized_unet.py:203 ``_full_fp32``: float32 convs and products
    without TF32 while the block runs."""

    def __enter__(self):
        self.saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = self.saved


# ---- tiles, views and merges (inference/, ops/tile_merge.py) ---------------


def pyramid_weight(width: int, height: int) -> np.ndarray:
    """inference/tiles.py:41 ``compute_pyramid_patch_weight_loss``: the
    centre-weighted window, float64."""
    xc, yc = width * 0.5, height * 0.5
    dcx = np.square(np.arange(width) - xc + 0.5)
    dcy = np.square(np.arange(height) - yc + 0.5)
    dc = np.sqrt(dcx[np.newaxis].transpose() + dcy)
    de_l = np.square(np.arange(width) + 0.5) + np.square(0.5)
    de_r = np.square(np.arange(width) - width + 0.5) + np.square(0.5)
    de_b = np.square(0.5) + np.square(np.arange(height) + 0.5)
    de_t = np.square(0.5) + np.square(np.arange(height) - height + 0.5)
    de_x = np.sqrt(np.minimum(de_l, de_r))
    de_y = np.sqrt(np.minimum(de_b, de_t))
    de = np.minimum(de_x[np.newaxis].transpose(), de_y)
    alpha = (width * height) / np.sum(np.divide(de, np.add(dc, de)))
    return alpha * np.divide(de, np.add(dc, de))


class TileGrid:
    """inference/tiles.py:65 ``ImageSlicer``'s geometry (``image_margin=0``):
    margins that centre a whole number of steps on the image, and each
    tile's top-left corner (row, col) on the padded canvas, in scan order."""

    def __init__(self, image_hw, tile: int, step: int):
        h, w = image_hw
        overlap = tile - step
        nw = max(1, math.ceil((w - overlap) / step))
        nh = max(1, math.ceil((h - overlap) / step))
        extra_w, extra_h = step * nw - (w - overlap), step * nh - (h - overlap)
        self.left, self.top = extra_w // 2, extra_h // 2
        self.right, self.bottom = extra_w - self.left, extra_h - self.top
        self.h, self.w, self.tile, self.step = h, w, tile, step
        self.canvas = (h + self.top + self.bottom, w + self.left + self.right)
        self.rows = (self.canvas[0] - tile) // step + 1
        self.cols = (self.canvas[1] - tile) // step + 1
        self.corners = [(y, x) for y in range(0, self.canvas[0] - tile + 1, step)
                        for x in range(0, self.canvas[1] - tile + 1, step)]

    def crop(self, canvas: torch.Tensor) -> torch.Tensor:
        return canvas[..., self.top:self.top + self.h, self.left:self.left + self.w]


def _rot(k):
    return lambda x: torch.rot90(x, k=k, dims=(2, 3))


def _t(x):
    return x.transpose(2, 3)


# inference/tta.py: d4 view v in index order (0 identity, 1 rot90 cw, 2 rot180, 3 rot90 ccw, 4-7 the same of the
# transpose) and its inverse
D4_AUG = (lambda x: x, _rot(-1), _rot(2), _rot(1), _t, lambda x: _rot(-1)(_t(x)), lambda x: _rot(2)(_t(x)),
          lambda x: _rot(1)(_t(x)))
D4_DEAUG = (lambda b: b, _rot(1), _rot(2), _rot(-1), _t, lambda b: _t(_rot(1)(b)), lambda b: _t(_rot(2)(b)),
            lambda b: _t(_rot(-1)(b)))
# inference/tiles.py:524 _D4_PARITY_VIEW_PAIRS: the d4 views of each grid-parity class in mode "distributed"
PARITY_VIEW_PAIRS = ((0, 2), (1, 3), (4, 6), (5, 7))


def d4_views(model, x: torch.Tensor, views) -> torch.Tensor:
    """inference/tta.py ``d4_image_augment_views`` -> model ->
    ``d4_image_deaugment_views`` with the mean over the views."""
    out = model(torch.cat([D4_AUG[v](x) for v in views], dim=0))
    chunks = torch.split(out, out.shape[0] // len(views), dim=0)
    return torch.stack([D4_DEAUG[v](c) for v, c in zip(views, chunks)]).mean(dim=0)


def grid_merge(tiles: torch.Tensor, weight: torch.Tensor, grid: TileGrid) -> torch.Tensor:
    """ops/tile_merge.py:102 ``grid_merge_reference``: fp32 slice-adds in tile
    order, the division by the summed window, the crop."""
    _, k, th, tw = tiles.shape
    w = weight.to(device=tiles.device, dtype=torch.float32)
    canvas = torch.zeros(k, *grid.canvas, dtype=torch.float32, device=tiles.device)
    norm = torch.zeros(1, *grid.canvas, dtype=torch.float32, device=tiles.device)
    for t, (y, x) in enumerate(grid.corners):
        canvas[:, y:y + th, x:x + tw] += tiles[t].to(torch.float32) * w
        norm[:, y:y + th, x:x + tw] += w
    return grid.crop(canvas) / grid.crop(norm).clamp_min(NORM_EPS)


def accumulate(canvas: torch.Tensor, norm: torch.Tensor, tiles: torch.Tensor, corners, weight: torch.Tensor):
    """ops/tile_merge.py:226 ``accumulate_tiles_reference``: fp32 slice-adds
    in tile order, the product rounded, then the sum."""
    th, tw = tiles.shape[2:]
    for tile, (y, x) in zip(tiles, corners):
        canvas[:, y:y + th, x:x + tw] += tile.to(torch.float32) * weight
        norm[:, y:y + th, x:x + tw] += weight
