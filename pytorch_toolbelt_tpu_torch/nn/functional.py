"""Resize helpers for NCHW feature maps (counterpart of
``pytorch_toolbelt_tpu/nn/functional.py``, which was written to match
``torch.nn.functional.interpolate``).

* bilinear, align_corners=False: half-pixel centres;
* bilinear, align_corners=True: corner-aligned grid;
* nearest: torch's legacy rule src = floor(dst * in / out).

A resize to the input's own size returns the input.
"""

from typing import Tuple

import torch
import torch.nn.functional as F

__all__ = ["resize_2d", "resize_bilinear", "resize_nearest"]

# torch's channels_last bilinear kernel on CUDA indexes its output with 32-bit
# ints; a larger output (e.g. 128 tiles x 64 channels x 512^2) is resized in
# batch chunks.
_MAX_OUTPUT_NUMEL = 2**31 - 1


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


def resize_2d(
    x: torch.Tensor, size: Tuple[int, int], mode: str = "bilinear", align_corners: bool = False
) -> torch.Tensor:
    """``F.interpolate`` for the modes the JAX package matches to torch."""
    if mode == "nearest":
        return resize_nearest(x, size)
    if mode in ("bilinear", "linear"):
        return resize_bilinear(x, size, align_corners=align_corners)
    raise ValueError(f"Unsupported interpolation mode {mode}")
