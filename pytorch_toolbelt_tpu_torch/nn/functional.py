"""Resize helpers for NCHW feature maps (counterpart of
``pytorch_toolbelt_tpu/nn/functional.py``, which was written to match
``torch.nn.functional.interpolate``).

* bilinear, align_corners=False: half-pixel centres;
* bilinear, align_corners=True: corner-aligned grid;
* nearest: torch's legacy rule src = floor(dst * in / out);
* bicubic: ``jax.image.resize(..., "cubic")``, which the JAX package calls:
  Keys' cubic with a = -0.5 at half-pixel centres, widened by in / out when
  it shrinks (antialiasing), taps outside the image dropped and each output
  sample's weights normalised to sum to 1.  torch's bicubic (a = -0.75,
  clamped taps, no antialiasing) is another function.

A resize to the input's own size returns the input.
"""

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["resize_2d", "resize_bilinear", "resize_nearest"]

# torch's channels_last bilinear kernel on CUDA indexes its output with 32-bit
# ints; a larger output (e.g. 128 tiles x 64 channels x 512^2) is resized in
# batch chunks.
_MAX_OUTPUT_NUMEL = 2**31 - 1


def _linear_weights(in_size: int, out_size: int, align_corners: bool, dtype) -> np.ndarray:
    """[out_size, in_size] interpolation matrix of one axis of a bilinear
    resize (two nonzeros per row), in numpy; a copy of the JAX package's
    ``pytorch_toolbelt_tpu/nn/functional.py:24``."""
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


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int], align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize of an NCHW tensor to (rows, cols)."""
    size = (int(size[0]), int(size[1]))
    if size == tuple(x.shape[-2:]):
        return x
    if not x.is_floating_point():
        x = x.float()
    chunk = max(1, _MAX_OUTPUT_NUMEL // (x.shape[1] * size[0] * size[1]))
    if x.shape[0] <= chunk:
        return F.interpolate(x, size=size, mode="bilinear", align_corners=align_corners)
    return torch.cat([F.interpolate(part, size=size, mode="bilinear", align_corners=align_corners)
                      for part in x.split(chunk)])


def resize_nearest(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Nearest-neighbour resize (torch legacy rule)."""
    size = (int(size[0]), int(size[1]))
    if size == tuple(x.shape[-2:]):
        return x
    return F.interpolate(x, size=size, mode="nearest")


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel with a = -0.5 at |x|."""
    near = ((1.5 * x - 2.5) * x) * x + 1.0
    far = ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0
    return np.where(x >= 2.0, 0.0, np.where(x >= 1.0, far, near))


def _cubic_weights(in_size: int, out_size: int) -> np.ndarray:
    """[out_size, in_size] matrix of ``jax.image.resize``'s cubic resampling
    along one axis."""
    inv_scale = in_size / out_size
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(out_size, dtype=np.float64) + 0.5) * inv_scale - 0.5
    w = _keys_cubic(np.abs(sample[:, None] - np.arange(in_size, dtype=np.float64)[None, :]) / kernel_scale)
    total = w.sum(axis=1, keepdims=True)
    return np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps, w / np.where(total != 0, total, 1), 0.0)


def _resize_bicubic(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bicubic resize of an NCHW tensor as ``jax.image.resize(.., "cubic")``:
    two contractions with the axes' weight matrices."""
    size = (int(size[0]), int(size[1]))
    if not x.is_floating_point():
        x = x.float()
    if size[0] != x.shape[2]:
        x = torch.matmul(torch.as_tensor(_cubic_weights(x.shape[2], size[0]), dtype=x.dtype, device=x.device), x)
    if size[1] != x.shape[3]:
        x = torch.matmul(x, torch.as_tensor(_cubic_weights(x.shape[3], size[1]).T, dtype=x.dtype, device=x.device))
    return x


def resize_2d(
    x: torch.Tensor, size: Tuple[int, int], mode: str = "bilinear", align_corners: bool = False
) -> torch.Tensor:
    """Resize an NCHW tensor to ``size`` as the JAX package's ``resize_2d``."""
    if mode == "nearest":
        return resize_nearest(x, size)
    if mode in ("bilinear", "linear"):
        return resize_bilinear(x, size, align_corners=align_corners)
    if mode == "bicubic":
        return _resize_bicubic(x, size)
    raise ValueError(f"Unsupported interpolation mode {mode}")
