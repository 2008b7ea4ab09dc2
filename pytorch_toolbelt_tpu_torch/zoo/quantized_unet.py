"""Post-training int8 quantized inference for ``UNetSegmentationModel``
(counterpart of ``pytorch_toolbelt_tpu/zoo/quantized_unet.py``).

The whole network stays in the integer domain, as in the JAX package:

* weights: per-output-channel symmetric int8;
* every real-valued scale (input scale, BatchNorm fold, weight scales,
  requant shifts) is absorbed into the next layer's weight quantization;
* conv epilogues are integer-only (int32 bias, ReLU, a rounding arithmetic
  shift, clip to int8), fused into the int8 conv kernel Q1
  (:func:`~pytorch_toolbelt_tpu_torch.ops.qconv2d`);
* the bilinear upsample (align_corners=True) runs on int8 interpolation
  matrices quantized to round(M * 127), both passes and their requants in
  the kernel Q2, which also writes the skip beside them: each decoder input
  in one launch (:func:`~pytorch_toolbelt_tpu_torch.ops.q_upsample_cat`);
* 2x2 max pooling and the channel concatenation are exact in int8;
* only the image input (one quantize) and the head logits (one dequant)
  touch float.

The quantization constants are built in numpy float64 with the JAX
package's arithmetic, on HWIO weights, so one calibration gives both
packages the same integer network.  Activation ranges come from one folded
float32 replay of the model over the calibration batch, on the device that
holds the model, with TF32 off.

The space-to-depth variant (``quantize_unet_inference_s2d``) works around
the TPU's 128-lane layout and is not ported.
"""

import contextlib
import functools
from typing import Callable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..nn.activations import ACT_RELU
from ..nn.functional import _linear_weights
from ..nn.normalization import _BATCH_ALIASES
from ..nn.simple import _same_padding
from ..ops.quantized import _to_int8, pack_qconv2d_weights, q_upsample, q_upsample_cat, qconv2d, upsample_taps
from ..utils.profiling import span
from .models import UNetSegmentationModel

__all__ = ["quantize_unet_inference"]

_QMAX = 127
_MUL_SHIFT = 23  # fixed-point bits of the multiplier requant (see _quantize_conv_mul)
_CL = torch.channels_last


class _QConv(NamedTuple):
    """One quantized conv+bias(+ReLU) with its shift epilogue's constants."""

    w_q: np.ndarray  # [kh, kw, ci, co] int8
    b_q: np.ndarray  # [co] int32
    shift: np.ndarray  # [co] int32
    rnd: np.ndarray  # [co] int32  (1 << (shift-1), 0 where shift == 0)
    sigma_out: np.ndarray  # [co] f64 — real scale of the int8 output


def _quantize_conv(w_eff, bias, amax_real, relu=True):
    """Quantize folded HWIO weights W_eff (input scales already absorbed) and
    derive the integer epilogue from the calibrated output range."""
    w_eff = np.asarray(w_eff, np.float64)
    bias = np.asarray(bias, np.float64)
    amax_real = np.asarray(amax_real, np.float64)
    sw = np.abs(w_eff).max(axis=(0, 1, 2)) / _QMAX
    sw = np.maximum(sw, 1e-12)
    w_q = np.clip(np.round(w_eff / sw), -_QMAX, _QMAX).astype(np.int8)
    b_q = np.round(bias / sw).astype(np.int64).clip(-(2**31), 2**31 - 1).astype(np.int32)
    amax_int = amax_real / sw
    shift = np.ceil(np.log2(np.maximum(amax_int / _QMAX, 1.0))).astype(np.int32)
    rnd = np.where(shift > 0, (1 << np.maximum(shift - 1, 0)), 0).astype(np.int32)
    sigma_out = sw * np.exp2(shift)
    return _QConv(w_q, b_q, shift, rnd, sigma_out), relu


class _QConvMul(NamedTuple):
    """Quantized conv whose epilogue is an int32 fixed-point multiply+shift
    requant: full int8 range at every layer."""

    w_q: np.ndarray  # [kh, kw, ci, co] int8
    b_q: np.ndarray  # [co] int32
    mult: np.ndarray  # [co] int32 — requant multiplier, scale = 2^_MUL_SHIFT/mult
    clamp: np.ndarray  # [co] int32 — pre-multiply accumulator clamp (overflow guard)
    sigma_out: np.ndarray  # [co] f64 — exact real scale of the int8 output


def _quantize_conv_mul(w_eff, bias, amax_real):
    """Like :func:`_quantize_conv` but with an exact-scale integer requant:
    f = QMAX / amax_int as mult / 2^23, the accumulator pre-clamped per
    channel to (2^31 - 1 - 2^22) / mult so the int32 product never overflows."""
    w_eff = np.asarray(w_eff, np.float64)
    bias = np.asarray(bias, np.float64)
    amax_real = np.asarray(amax_real, np.float64)
    sw = np.abs(w_eff).max(axis=(0, 1, 2)) / _QMAX
    sw = np.maximum(sw, 1e-12)
    w_q = np.clip(np.round(w_eff / sw), -_QMAX, _QMAX).astype(np.int8)
    b_q = np.round(bias / sw).astype(np.int64).clip(-(2**31), 2**31 - 1).astype(np.int32)
    amax_int = np.maximum(amax_real / sw, 1.0)
    mult = np.maximum(np.round(_QMAX / amax_int * (1 << _MUL_SHIFT)), 1.0)
    clamp = np.floor((2.0**31 - 1 - (1 << (_MUL_SHIFT - 1))) / mult)
    sigma_out = sw * float(1 << _MUL_SHIFT) / mult
    return _QConvMul(w_q, b_q, mult.astype(np.int32), clamp.astype(np.int32), sigma_out)


def _int32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a, np.int32), device=device)


def _requant_mul(acc: torch.Tensor, qc: "_DeviceQConv") -> torch.Tensor:
    """int32 accumulator [B, C, H, W] -> int8 via clamp, fixed-point multiply,
    shift: Q1's ``"mul"`` epilogue after its bias and ReLU."""
    return _to_int8(acc, "mul", None, None, qc.mult, qc.clamp)


class _DeviceQConv:
    """One integer conv on the device: Q1's packed weights, its geometry and
    its epilogue's int32 operands (``"shift"``: b_q, rnd, shift; ``"mul"``:
    b_q, mult, clamp; ``"acc"``: none)."""

    def __init__(self, w_q_hwio: np.ndarray, device, *, stride: int = 1, pad="SAME", groups: int = 1,
                 epilogue: str = "shift", relu: bool = True, qc=None):
        w = torch.as_tensor(np.ascontiguousarray(np.asarray(w_q_hwio, np.int8).transpose(3, 2, 0, 1)), device=device)
        self.weight = pack_qconv2d_weights(w, groups)
        self.kernel = w.shape[2:]
        self.stride, self.pad, self.epilogue, self.relu = stride, pad, epilogue, relu
        self.b_q = self.rnd = self.shift = self.mult = self.clamp = None
        if qc is not None:
            self.b_q = _int32(qc.b_q, device)
            if epilogue == "shift":
                self.rnd, self.shift = _int32(qc.rnd, device), _int32(qc.shift, device)
            else:
                self.mult, self.clamp = _int32(qc.mult, device), _int32(qc.clamp, device)

    def padding(self, h: int, w: int):
        """(top, bottom, left, right): flax ``SAME`` from the input's size, or the explicit pads."""
        if self.pad == "SAME":
            return (*_same_padding(h, self.kernel[0], self.stride), *_same_padding(w, self.kernel[1], self.stride))
        (top, bottom), (left, right) = self.pad
        return top, bottom, left, right

    def __call__(self, x_q: torch.Tensor, epilogue: Optional[str] = None) -> torch.Tensor:
        epilogue = epilogue or self.epilogue
        kwargs = {}
        if epilogue == "shift":
            kwargs = dict(bias=self.b_q, relu=self.relu, rnd=self.rnd, shift=self.shift)
        elif epilogue == "mul":
            kwargs = dict(bias=self.b_q, relu=self.relu, mult=self.mult, clamp=self.clamp)
        return qconv2d(x_q, self.weight, self.stride, self.padding(*x_q.shape[2:]), epilogue, **kwargs)


def _qconv_apply(x_q: torch.Tensor, qc: _DeviceQConv) -> torch.Tensor:
    return qc(x_q)


def _q_maxpool(x_q: torch.Tensor) -> torch.Tensor:
    """2x2 max pool of an int8 NCHW tensor: four strided slices (torch's
    ``max_pool2d`` takes no int8 on CUDA)."""
    with span("int8.pool", x_q):
        y = torch.maximum(
            torch.maximum(x_q[:, :, 0::2, 0::2], x_q[:, :, 0::2, 1::2]),
            torch.maximum(x_q[:, :, 1::2, 0::2], x_q[:, :, 1::2, 1::2]),
        )
        return y.contiguous(memory_format=_CL)


@functools.lru_cache(maxsize=64)
def _q_upsample_matrices(in_h, in_w, out_h, out_w):
    """Quantized bilinear (align_corners=True) interpolation matrices (int8
    numpy, read-only: one pair per shape) and the exact scale factor they
    introduce."""
    mh = np.round(_linear_weights(in_h, out_h, True, np.float64) * _QMAX).astype(np.int8)
    mw = np.round(_linear_weights(in_w, out_w, True, np.float64) * _QMAX).astype(np.int8)
    mh.flags.writeable = mw.flags.writeable = False
    # two passes x127 each, two >>7 requants: sigma multiplier (2^7/127)^2
    return mh, mw, (128.0 / _QMAX) ** 2


@functools.lru_cache(maxsize=64)
def _q_upsample_taps(in_h, in_w, out_h, out_w, device):
    """Q2's taps of one shape's matrices on ``device``, made once."""
    mh, mw, _ = _q_upsample_matrices(in_h, in_w, out_h, out_w)
    return upsample_taps(mh, device), upsample_taps(mw, device)


def _q_upsample(x_q: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """The int8 bilinear upsample of ``x_q`` to out_h x out_w on Q2."""
    shape = (*x_q.shape[2:], out_h, out_w)
    mh, mw, _ = _q_upsample_matrices(*shape)
    return q_upsample(x_q, mh, mw, taps=_q_upsample_taps(*shape, x_q.device))


def _q_upsample_cat(x_q: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
    """The int8 decoder input, ``x_q`` upsampled to the skip's size and
    joined to it, in one launch of Q2."""
    shape = (*x_q.shape[2:], *skip.shape[2:])
    mh, mw, _ = _q_upsample_matrices(*shape)
    return q_upsample_cat(x_q, skip, mh, mw, taps=_q_upsample_taps(*shape, x_q.device))


@contextlib.contextmanager
def _full_fp32():
    """float32 convolutions and matrix products in full precision on the
    card (cuDNN runs fp32 convs in TF32 by default), as the JAX package
    calibrates at ``Precision.HIGHEST``."""
    conv, matmul = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = conv, matmul


def _hwio(weight: torch.Tensor) -> np.ndarray:
    return weight.detach().cpu().numpy().transpose(2, 3, 1, 0).astype(np.float64)


def _fold_block(block) -> List[tuple]:
    """UnetBlock -> [(w_eff HWIO f64, bias f64)] for its two convs: the
    BatchNorm fold in float32, as the JAX package folds, then widened."""
    out = []
    for conv, norm in ((block.conv1, block.norm1), (block.conv2, block.norm2)):
        bn = norm.norm
        inv = bn.weight.detach().float() / torch.sqrt(bn.running_var.detach().float() + bn.eps)
        bias = bn.bias.detach().float() - bn.running_mean.detach().float() * inv
        out.append((_hwio(conv.weight) * inv.cpu().numpy().astype(np.float64)[None, None, None, :],
                    bias.cpu().numpy().astype(np.float64)))
    return out


@functools.lru_cache(maxsize=64)
def _linear_matrix(in_size, out_size, align_corners, device) -> torch.Tensor:
    """One axis's float32 interpolation matrix on ``device``, made once per
    shape (shared by every caller: read only), so that a resize copies
    nothing from the host and does not wait for the card."""
    return torch.as_tensor(_linear_weights(in_size, out_size, align_corners, np.float32), device=device)


def _resize_matmul(x: torch.Tensor, out_hw, align_corners: bool) -> torch.Tensor:
    """Separable bilinear resize of a float NCHW tensor as two products with
    the axes' interpolation matrices (the JAX package's einsums)."""
    wh = _linear_matrix(x.shape[2], out_hw[0], align_corners, x.device)
    ww = _linear_matrix(x.shape[3], out_hw[1], align_corners, x.device)
    return torch.matmul(torch.matmul(wh, x), ww.t())


class _UNetCalibration(NamedTuple):
    """Folded float64 HWIO weights and the calibrated ranges, as the JAX
    package's ``_calibrate_unet`` returns them."""

    enc: list  # per level: [(w_eff, bias)] of its two convs
    dec: list  # per stage, coarsest first: [(w_eff, bias)]
    head_w: np.ndarray
    head_b: np.ndarray
    amax: dict  # ("enc" | "dec", i, j) -> [co] f64
    input_amax: float


def _calibrate_unet(model: UNetSegmentationModel, calibration_images, margin: float) -> _UNetCalibration:
    """Fold BN into the weights (f64) and record per-channel post-activation
    absmax from one folded float32 replay over the calibration batch."""
    device = next(model.parameters()).device
    num_stages = model.num_layers - 1
    enc = [_fold_block(block) for block in model.encoder.blocks]
    dec = [[conv for block in stage for conv in _fold_block(block)] for stage in model.decoder.stages]
    head_w = _hwio(model.head.conv.weight)
    head_b = model.head.conv.bias.detach().cpu().numpy().astype(np.float64)

    x_cal = torch.as_tensor(calibration_images, dtype=torch.float32, device=device)
    amax = {}

    def cal_conv(x, w, b, key):
        w32 = torch.as_tensor(w.transpose(3, 2, 0, 1).astype(np.float32), device=device)
        y = F.conv2d(x, w32, padding=(w.shape[0] // 2, w.shape[1] // 2))
        y = torch.relu(y + torch.as_tensor(b.astype(np.float32), device=device).view(1, -1, 1, 1))
        amax[key] = y.abs().amax(dim=(0, 2, 3)).cpu().numpy().astype(np.float64) * margin
        return y

    with torch.no_grad(), _full_fp32():
        x = x_cal
        skips = []
        for layer in range(model.num_layers):
            if layer > 0:
                x = torch.maximum(torch.maximum(x[:, :, 0::2, 0::2], x[:, :, 0::2, 1::2]),
                                  torch.maximum(x[:, :, 1::2, 0::2], x[:, :, 1::2, 1::2]))
            for j, (w, b) in enumerate(enc[layer]):
                x = cal_conv(x, w, b, ("enc", layer, j))
            skips.append(x)
        for i in range(num_stages - 1, -1, -1):
            skip = skips[i]
            x = torch.cat([_resize_matmul(x, skip.shape[2:], True), skip], dim=1)
            for j, (w, b) in enumerate(dec[num_stages - 1 - i]):
                x = cal_conv(x, w, b, ("dec", i, j))
        input_amax = float(x_cal.abs().max()) * margin
    return _UNetCalibration(enc, dec, head_w, head_b, amax, input_amax)


def _build_int8_unet(cal: _UNetCalibration, in_channels: int, output_name: Optional[str], device) -> Callable:
    """The integer forward from a calibration (the JAX package's build)."""
    num_layers = len(cal.enc)
    num_stages = num_layers - 1
    sigma_in = np.full(in_channels, max(cal.input_amax, 1e-12) / _QMAX)

    def build_conv(w_eff, b, key, sigma):
        w_abs = w_eff * sigma[None, None, :, None]  # absorb input scales
        qc, _ = _quantize_conv(w_abs, b, cal.amax[key])
        return _DeviceQConv(qc.w_q, device, qc=qc), qc.sigma_out

    q_enc: List[List[_DeviceQConv]] = []
    sig = sigma_in
    sig_skips = []
    for layer in range(num_layers):
        row = []
        for j, (w, b) in enumerate(cal.enc[layer]):
            qc, sig = build_conv(w, b, ("enc", layer, j), sig)
            row.append(qc)
        q_enc.append(row)
        sig_skips.append(sig)
    q_dec: List[List[_DeviceQConv]] = []
    # the int8 interpolation matrices scale by the shape-independent (2^7/127)^2
    up_mult = (128.0 / _QMAX) ** 2
    for i in range(num_stages - 1, -1, -1):
        sig = np.concatenate([sig * up_mult, sig_skips[i]])
        row = []
        for j, (w, b) in enumerate(cal.dec[num_stages - 1 - i]):
            qc, sig = build_conv(w, b, ("dec", i, j), sig)
            row.append(qc)
        q_dec.append(row)
    # head: dequant directly from the int32 accumulator
    head_eff = cal.head_w * sig[None, None, :, None]
    sw_head = np.maximum(np.abs(head_eff).max(axis=(0, 1, 2)) / _QMAX, 1e-12)
    head = _DeviceQConv(np.clip(np.round(head_eff / sw_head), -_QMAX, _QMAX).astype(np.int8), device,
                        epilogue="acc")
    head_sw = torch.as_tensor(sw_head, dtype=torch.float32, device=device).view(1, -1, 1, 1)
    head_bias = torch.as_tensor(cal.head_b, dtype=torch.float32, device=device).view(1, -1, 1, 1)
    inv_sigma_in = torch.as_tensor(1.0 / sigma_in, dtype=torch.float32, device=device).view(1, -1, 1, 1)

    @torch.no_grad()
    def forward(x: torch.Tensor):
        with span("int8.forward", device=False):
            x_q = torch.round(x.float() * inv_sigma_in).clamp(-_QMAX, _QMAX).to(torch.int8)
            x_q = x_q.contiguous(memory_format=_CL)
            skips = []
            for layer in range(num_layers):
                if layer > 0:
                    x_q = _q_maxpool(x_q)
                for qc in q_enc[layer]:
                    x_q = _qconv_apply(x_q, qc)
                skips.append(x_q)
            for idx, i in enumerate(range(num_stages - 1, -1, -1)):
                x_q = _q_upsample_cat(x_q, skips[i])
                for qc in q_dec[idx]:
                    x_q = _qconv_apply(x_q, qc)
            with span("int8.head", x_q):
                y = (head(x_q).float() * head_sw + head_bias).contiguous()
        if output_name is not None:
            return {output_name: y}
        return y

    return forward


def quantize_unet_inference(
    model: UNetSegmentationModel, calibration_images: Sequence, *, margin: float = 1.0
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Build a fully-integer inference forward for a trained ``UNetSegmentationModel``.

    Args:
        model: the trained model (relu + batch norm only).
        calibration_images: [N, C, H, W] float images (a tensor or array) of
            representative inputs; per-channel activation ranges are read
            from one folded float32 forward over this batch on the model's
            device.  H and W need not match the inference size: the
            quantized upsample matrices are built from each call's shapes.
        margin: multiplier on calibrated ranges (>1 guards against
            calibration undershoot at the cost of range utilisation).

    Returns:
        ``forward(x: [B, C, H, W] float) -> [B, num_classes, H, W]`` float32
        logits (or ``{output_name: logits}``) approximating
        ``model.eval()(x)`` at int8 post-training-quantization fidelity, on
        the device that holds ``model``.  H and W must be multiples of
        2^(num_layers - 1).
    """
    if model.activation.lower() != ACT_RELU:
        raise NotImplementedError("quantize_unet_inference supports activation='relu' only")
    if model.normalization.lower() not in _BATCH_ALIASES:
        raise NotImplementedError("quantize_unet_inference supports batch normalization only")
    if model.encoder.pool != "max":
        raise NotImplementedError("quantize_unet_inference supports max pooling only")
    cal = _calibrate_unet(model, calibration_images, margin)
    device = next(model.parameters()).device
    return _build_int8_unet(cal, np.shape(calibration_images)[1], model.output_name, device)
