"""Test-time augmentation (counterpart of the d4 and multiscale families of
``pytorch_toolbelt_tpu/inference/tta.py``).

d4: all views stack along the batch axis so the model runs one batched
forward; the views need square images.  Multiscale: the model runs once per
size offset, and the outputs are resized back and reduced.  Tensors are NCHW.
"""

from typing import Callable, Dict, List, Optional, Tuple, Union

import torch

from ..nn.functional import resize_2d
from . import functional as F

__all__ = [
    "MultiscaleTTA",
    "d4_image2mask",
    "d4_image_augment",
    "d4_image_augment_views",
    "d4_image_deaugment",
    "d4_image_deaugment_views",
    "ms_image_augment",
    "ms_image_deaugment",
    "ms_labels_augment",
    "ms_labels_deaugment",
    "split_into_chunks",
]

MaybeStrOrCallable = Optional[Union[str, Callable]]


def split_into_chunks(input: torch.Tensor, num_chunks: int) -> Tuple[torch.Tensor, ...]:
    if input.shape[0] % num_chunks != 0:
        raise RuntimeError(f"Cannot split batch of {input.shape[0]} into {num_chunks} equal TTA chunks.")
    return torch.split(input, input.shape[0] // num_chunks, dim=0)


def _deaugment_averaging(x: torch.Tensor, reduction: MaybeStrOrCallable) -> torch.Tensor:
    """Reduce the TTA axis 0 of [T, B, ...]."""
    if reduction == "mean":
        return x.mean(dim=0)
    if reduction == "sum":
        return x.sum(dim=0)
    if reduction in {"gmean", "geometric_mean"}:
        return F.geometric_mean(x, dim=0)
    if reduction in {"hmean", "harmonic_mean"}:
        return F.harmonic_mean(x, dim=0)
    if reduction == "harmonic1p":
        return F.harmonic1p_mean(x, dim=0)
    if reduction == "logodd":
        return F.logodd_mean(x, dim=0)
    if reduction == "log1p":
        return F.log1p_mean(x, dim=0)
    if callable(reduction):
        return reduction(x, dim=0)
    if reduction in {None, "None", "none"}:
        return x
    raise KeyError(f"Unsupported reduction mode {reduction}")


def _check_square(image: torch.Tensor) -> None:
    if image.shape[2] != image.shape[3]:
        raise ValueError(f"d4 TTA needs square spatial dims (H == W); got shape {tuple(image.shape)}")


# d4 view v of an image, in d4 index order: 0 identity, 1 rot90 cw,
# 2 rot180, 3 rot90 ccw, 4..7 the same of the transpose.
_D4_AUG = (
    lambda x: x,
    F.image_rot90_cw,
    F.image_rot180,
    F.image_rot90_ccw,
    F.image_transpose,
    F.image_transpose_rot90_cw,
    F.image_transpose_rot180,
    F.image_transpose_rot90_ccw,
)

_D4_DEAUG = (
    lambda b: b,
    F.image_rot90_ccw,
    F.image_rot180,
    F.image_rot90_cw,
    F.image_transpose,
    F.image_rot90_ccw_transpose,
    F.image_rot180_transpose,
    F.image_rot90_cw_transpose,
)


def d4_image_augment_views(image: torch.Tensor, views: Tuple[int, ...]) -> torch.Tensor:
    """[B] -> [len(views) * B]: a subset of the 8 d4 views, in the given order."""
    _check_square(image)
    return torch.cat([_D4_AUG[v](image) for v in views], dim=0)


def d4_image_deaugment_views(
    image: torch.Tensor, views: Tuple[int, ...], reduction: MaybeStrOrCallable = "mean"
) -> torch.Tensor:
    """Inverse of :func:`d4_image_augment_views` + reduction over the views."""
    chunks = split_into_chunks(image, len(views))
    return _deaugment_averaging(torch.stack([_D4_DEAUG[v](c) for v, c in zip(views, chunks)]), reduction)


def d4_image_augment(image: torch.Tensor) -> torch.Tensor:
    """[B] -> [8B]: rotations of the image and of its transpose."""
    return d4_image_augment_views(image, tuple(range(8)))


def d4_image_deaugment(image: torch.Tensor, reduction: MaybeStrOrCallable = "mean") -> torch.Tensor:
    return d4_image_deaugment_views(image, tuple(range(8)), reduction)


def d4_image2mask(model_fn: Callable, image: torch.Tensor) -> torch.Tensor:
    return d4_image_deaugment(model_fn(d4_image_augment(image)))


# ---------------------------------------------------------------------------
# Multi-scale family
# ---------------------------------------------------------------------------


def _offset_pair(offset) -> Tuple[int, int]:
    return tuple(offset) if isinstance(offset, (tuple, list)) else (offset, offset)


def ms_labels_augment(labels: torch.Tensor, size_offsets: List) -> List[torch.Tensor]:
    return [labels] * len(size_offsets)


def ms_image_augment(
    image: torch.Tensor,
    size_offsets: List[Union[int, Tuple[int, int]]],
    mode: str = "bilinear",
    align_corners: bool = False,
) -> List[torch.Tensor]:
    """One resized tensor per size offset (rows + r_off, cols + c_off); an
    offset of 0 passes the image through."""
    rows, cols = image.shape[2], image.shape[3]
    augmented = []
    for offset in size_offsets:
        r_off, c_off = _offset_pair(offset)
        if r_off == 0 and c_off == 0:
            augmented.append(image)
        else:
            augmented.append(resize_2d(image, (rows + r_off, cols + c_off), mode=mode, align_corners=align_corners))
    return augmented


def ms_labels_deaugment(
    logits: List[torch.Tensor], size_offsets: List, reduction: MaybeStrOrCallable = "mean"
) -> torch.Tensor:
    if len(logits) != len(size_offsets):
        raise ValueError("Got a different number of images than size offsets")
    return _deaugment_averaging(torch.stack(logits), reduction)


def ms_image_deaugment(
    images: List[torch.Tensor],
    size_offsets: List[Union[int, Tuple[int, int]]],
    reduction: MaybeStrOrCallable = "mean",
    mode: str = "bilinear",
    align_corners: bool = True,
    stride: int = 1,
) -> torch.Tensor:
    """Resize each scale's output back to the original size, (rows -
    r_off // stride, cols - c_off // stride) for an output at ``stride``,
    and reduce.  Note the default ``align_corners=True``, where augment
    defaults to False, as in the JAX package."""
    if len(images) != len(size_offsets):
        raise ValueError("Got a different number of images than size offsets")
    deaugmented = []
    for feature_map, offset in zip(images, size_offsets):
        r_off, c_off = _offset_pair(offset)
        if r_off == 0 and c_off == 0:
            deaugmented.append(feature_map)
        else:
            rows, cols = feature_map.shape[2], feature_map.shape[3]
            original = (rows - r_off // stride, cols - c_off // stride)
            deaugmented.append(resize_2d(feature_map, original, mode=mode, align_corners=align_corners))
    return _deaugment_averaging(torch.stack(deaugmented), reduction)


class MultiscaleTTA:
    """Run the model at several scales and reduce the de-scaled outputs.
    ``deaugment_fn`` may be a dict keyed like the model's dict outputs."""

    def __init__(
        self,
        model_fn: Callable,
        size_offsets: List[int],
        mode: str = "bilinear",
        align_corners: bool = False,
        augment_fn: Callable = ms_image_augment,
        deaugment_fn: Union[Callable, Dict[str, Callable]] = ms_image_deaugment,
    ):
        self.model_fn = model_fn
        self.size_offsets = size_offsets
        self.mode = mode
        self.align_corners = align_corners
        self.augment_fn = augment_fn
        self.deaugment_fn = deaugment_fn
        self.keys = set(deaugment_fn.keys()) if isinstance(deaugment_fn, dict) else None

    def __call__(self, x: torch.Tensor):
        ms_inputs = self.augment_fn(x, size_offsets=self.size_offsets, mode=self.mode,
                                    align_corners=self.align_corners)
        ms_outputs = [self.model_fn(xi) for xi in ms_inputs]
        if self.keys is None:
            return self.deaugment_fn(ms_outputs, self.size_offsets)
        return {key: self.deaugment_fn[key]([out[key] for out in ms_outputs], size_offsets=self.size_offsets)
                for key in self.keys}
