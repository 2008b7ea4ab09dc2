"""Batched d4 test-time augmentation (counterpart of the d4 family of
``pytorch_toolbelt_tpu/inference/tta.py``).

All views stack along the batch axis so the model runs one batched forward.
Tensors are NCHW; the d4 views need square images.
"""

from typing import Callable, Optional, Tuple, Union

import torch

from . import functional as F

__all__ = [
    "d4_image2mask",
    "d4_image_augment",
    "d4_image_augment_views",
    "d4_image_deaugment",
    "d4_image_deaugment_views",
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
