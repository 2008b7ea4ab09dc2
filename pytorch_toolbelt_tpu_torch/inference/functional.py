"""D4 geometric primitives, padding helpers and probability means for NCHW
tensors (counterpart of ``pytorch_toolbelt_tpu/inference/functional.py``,
whose tensors are NHWC).  The spatial dims are (2, 3), or 2 onwards."""

from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F

__all__ = [
    "geometric_mean",
    "harmonic1p_mean",
    "harmonic_mean",
    "image_fliplr",
    "image_flipud",
    "image_none",
    "image_rot180",
    "image_rot180_transpose",
    "image_rot90_ccw",
    "image_rot90_ccw_transpose",
    "image_rot90_cw",
    "image_rot90_cw_transpose",
    "image_transpose",
    "image_transpose_rot180",
    "image_transpose_rot90_ccw",
    "image_transpose_rot90_cw",
    "log1p_mean",
    "logodd_mean",
    "pad_image_tensor",
    "pad_tensor_to_size",
    "unpad_image_tensor",
    "unpad_xyxy_bboxes",
]


def image_none(x: torch.Tensor) -> torch.Tensor:
    return x


def image_rot90_ccw(x: torch.Tensor) -> torch.Tensor:
    """Counter-clockwise 90 degrees: torch rot90 k=1 over (H, W)."""
    return torch.rot90(x, k=1, dims=(2, 3))


def image_rot90_cw(x: torch.Tensor) -> torch.Tensor:
    return torch.rot90(x, k=-1, dims=(2, 3))


def image_rot180(x: torch.Tensor) -> torch.Tensor:
    return torch.rot90(x, k=2, dims=(2, 3))


def image_fliplr(x: torch.Tensor) -> torch.Tensor:
    """Flip along width."""
    return torch.flip(x, dims=(3,))


def image_flipud(x: torch.Tensor) -> torch.Tensor:
    """Flip along height."""
    return torch.flip(x, dims=(2,))


def image_transpose(x: torch.Tensor) -> torch.Tensor:
    """Transpose over the main image diagonal."""
    return x.transpose(2, 3)


def image_rot90_ccw_transpose(x: torch.Tensor) -> torch.Tensor:
    return image_transpose(image_rot90_ccw(x))


def image_rot90_cw_transpose(x: torch.Tensor) -> torch.Tensor:
    return image_transpose(image_rot90_cw(x))


def image_rot180_transpose(x: torch.Tensor) -> torch.Tensor:
    return image_transpose(image_rot180(x))


def image_transpose_rot90_ccw(x: torch.Tensor) -> torch.Tensor:
    return image_rot90_ccw(image_transpose(x))


def image_transpose_rot90_cw(x: torch.Tensor) -> torch.Tensor:
    return image_rot90_cw(image_transpose(x))


def image_transpose_rot180(x: torch.Tensor) -> torch.Tensor:
    return image_rot180(image_transpose(x))


def pad_tensor_to_size(
    x: torch.Tensor, size: Sequence[int], mode: str = "constant", value: float = 0
) -> Tuple[torch.Tensor, Tuple[slice, ...]]:
    """Pad a [B, C, *spatial] tensor to the spatial ``size``, centred (the
    odd pixel after).  Returns (padded, crop) where ``padded[crop]`` is
    ``x``.  ``mode``: 'constant' (with ``value``), 'reflect' or
    'replicate' (numpy's 'edge')."""
    if mode not in ("constant", "reflect", "replicate"):
        raise KeyError(f"Unsupported pad mode {mode!r}")
    num_spatial = len(size)
    if num_spatial != x.ndim - 2:
        raise ValueError(f"Expected {num_spatial} spatial dimensions, got {x.ndim - 2}")
    pads, crop = [], [slice(None), slice(None)]
    for target, current in zip(size, x.shape[2:]):
        before = (target - current) // 2
        pads.append((before, target - current - before))
        crop.append(slice(before, before + current))
    flat = [p for pair in reversed(pads) for p in pair]  # F.pad: the last dim first
    return F.pad(x, flat, mode=mode, value=value if mode == "constant" else None), tuple(crop)


def pad_image_tensor(
    image_tensor: torch.Tensor, pad_size: Union[int, Tuple[int, int]] = 32
) -> Tuple[torch.Tensor, Tuple[int, int, int, int]]:
    """Zero-pad an NCHW tensor so that H and W divide by ``pad_size`` (an
    image smaller than it grows to it), centred.  Returns (padded,
    (pad_left, pad_right, pad_top, pad_btm))."""
    if image_tensor.ndim != 4:
        raise ValueError("Tensor must have rank 4 ([B,C,H,W])")
    rows, cols = image_tensor.shape[2], image_tensor.shape[3]
    if isinstance(pad_size, (tuple, list)):
        pad_height, pad_width = int(pad_size[0]), int(pad_size[1])
    elif isinstance(pad_size, int):
        pad_height = pad_width = pad_size
    else:
        raise ValueError(f"Unsupported pad_size: {pad_size}")

    def missing(size, multiple):
        return (-size) % multiple if size > multiple else multiple - size

    pad_rows, pad_cols = missing(rows, pad_height), missing(cols, pad_width)
    if pad_rows == 0 and pad_cols == 0:
        return image_tensor, (0, 0, 0, 0)
    pad_top, pad_left = pad_rows // 2, pad_cols // 2
    pad = (pad_left, pad_cols - pad_left, pad_top, pad_rows - pad_top)
    return F.pad(image_tensor, pad), pad


def unpad_image_tensor(image_tensor: torch.Tensor, pad: Tuple[int, int, int, int]) -> torch.Tensor:
    """Undo :func:`pad_image_tensor` given its (pad_left, pad_right, pad_top, pad_btm)."""
    if image_tensor.ndim != 4:
        raise ValueError("Tensor must have rank 4 ([B,C,H,W])")
    pad_left, pad_right, pad_top, pad_btm = pad
    rows, cols = image_tensor.shape[2], image_tensor.shape[3]
    return image_tensor[:, :, pad_top : rows - pad_btm, pad_left : cols - pad_right]


def unpad_xyxy_bboxes(bboxes_tensor: torch.Tensor, pad: Tuple[int, int, int, int], dim: int = -1) -> torch.Tensor:
    """Shift xyxy boxes (along ``dim``) from the padded image to the original."""
    pad_left, _, pad_top, _ = pad
    shape = [1] * bboxes_tensor.ndim
    shape[dim] = 4
    offsets = torch.tensor([pad_left, pad_top, pad_left, pad_top], dtype=bboxes_tensor.dtype,
                           device=bboxes_tensor.device)
    return bboxes_tensor - offsets.reshape(shape)


def geometric_mean(x: torch.Tensor, dim: int) -> torch.Tensor:
    """exp(mean(log(x))); assumes probabilities in (0, 1)."""
    return torch.exp(torch.mean(torch.log(x), dim=dim))


def harmonic_mean(x: torch.Tensor, dim: int, eps: float = 1e-6) -> torch.Tensor:
    x = torch.mean(1.0 / torch.clamp_min(x, eps), dim=dim)
    return 1.0 / torch.clamp_min(x, eps)


def harmonic1p_mean(x: torch.Tensor, dim: int) -> torch.Tensor:
    x = torch.mean(1.0 / (x + 1), dim=dim)
    return 1.0 / x - 1


def logodd_mean(x: torch.Tensor, dim: int, eps: float = 1e-6) -> torch.Tensor:
    x = torch.clamp(x, eps, 1.0 - eps)
    x = torch.mean(torch.log(x / (1 - x)), dim=dim)
    return torch.exp(x) / (1 + torch.exp(x))


def log1p_mean(x: torch.Tensor, dim: int) -> torch.Tensor:
    x = torch.mean(torch.log1p(x), dim=dim)
    return torch.exp(x) - 1
