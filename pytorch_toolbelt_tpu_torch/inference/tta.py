"""Test-time augmentation (counterpart of ``pytorch_toolbelt_tpu/inference/tta.py``).

Crops, flips, d2 and d4: all views stack along the batch axis so the model
runs one batched forward; the d4 views need square images.  Multiscale: the
model runs once per size offset, and the outputs are resized back and
reduced.  The model wrappers take a plain callable ``model_fn(x)``.
Tensors are NCHW.
"""

import warnings
from functools import partial
from typing import Callable, Dict, List, Optional, Tuple, Union

import torch

from ..nn.functional import resize_2d
from ..utils.profiling import span
from . import functional as F

__all__ = [
    "GeneralizedTTA",
    "MultiscaleTTA",
    "TTAWrapper",
    "d2_image_augment",
    "d2_image_deaugment",
    "d2_labels_augment",
    "d2_labels_deaugment",
    "d4_image2label",
    "d4_image2mask",
    "d4_image_augment",
    "d4_image_augment_views",
    "d4_image_deaugment",
    "d4_image_deaugment_views",
    "d4_labels_augment",
    "d4_labels_deaugment",
    "fivecrop_image2label",
    "fivecrop_image_augment",
    "fivecrop_label_deaugment",
    "fliplr_image2label",
    "fliplr_image2mask",
    "fliplr_image_augment",
    "fliplr_image_deaugment",
    "fliplr_labels_augment",
    "fliplr_labels_deaugment",
    "flips_image_augment",
    "flips_image_deaugment",
    "flips_labels_augment",
    "flips_labels_deaugment",
    "flipud_image_augment",
    "flipud_image_deaugment",
    "flipud_labels_deaugment",
    "ms_image_augment",
    "ms_image_deaugment",
    "ms_labels_augment",
    "ms_labels_deaugment",
    "split_into_chunks",
    "tencrop_image2label",
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


def _reduce_chunks(x: torch.Tensor, num_chunks: int, reduction: MaybeStrOrCallable) -> torch.Tensor:
    return _deaugment_averaging(torch.stack(split_into_chunks(x, num_chunks)), reduction)


# ---------------------------------------------------------------------------
# Crops (classification)
# ---------------------------------------------------------------------------


def fivecrop_image_augment(image: torch.Tensor, crop_size: Tuple[int, int]) -> torch.Tensor:
    """[B] -> [5B]: the four corner crops and the centre crop."""
    image_height, image_width = image.shape[2], image.shape[3]
    crop_height, crop_width = crop_size
    if crop_height > image_height:
        raise ValueError(f"Crop height {crop_height} exceeds the image height {image_height}")
    if crop_width > image_width:
        raise ValueError(f"Crop width {crop_width} exceeds the image width {image_width}")
    bottom, right = image_height - crop_height, image_width - crop_width
    cy, cx = bottom // 2, right // 2
    return torch.cat([
        image[:, :, :crop_height, :crop_width],
        image[:, :, :crop_height, right:],
        image[:, :, bottom:, :crop_width],
        image[:, :, bottom:, right:],
        image[:, :, cy : cy + crop_height, cx : cx + crop_width],
    ], dim=0)


def fivecrop_label_deaugment(logits: torch.Tensor, reduction: MaybeStrOrCallable = "mean") -> torch.Tensor:
    return _reduce_chunks(logits, 5, reduction)


def fivecrop_image2label(model_fn: Callable, image: torch.Tensor, crop_size: Tuple[int, int]) -> torch.Tensor:
    return fivecrop_label_deaugment(model_fn(fivecrop_image_augment(image, crop_size)))


def tencrop_image2label(model_fn: Callable, image: torch.Tensor, crop_size: Tuple[int, int]) -> torch.Tensor:
    """The five crops and their horizontal flips in one batched forward, averaged."""
    crops5 = fivecrop_image_augment(image, crop_size)
    return _reduce_chunks(model_fn(torch.cat([crops5, F.image_fliplr(crops5)], dim=0)), 10, "mean")


# ---------------------------------------------------------------------------
# Flips and d2
# ---------------------------------------------------------------------------


def fliplr_image_augment(image: torch.Tensor) -> torch.Tensor:
    return torch.cat([image, F.image_fliplr(image)], dim=0)


def flipud_image_augment(image: torch.Tensor) -> torch.Tensor:
    return torch.cat([image, F.image_flipud(image)], dim=0)


def fliplr_image_deaugment(image: torch.Tensor, reduction: MaybeStrOrCallable = "mean") -> torch.Tensor:
    b1, b2 = split_into_chunks(image, 2)
    return _deaugment_averaging(torch.stack([b1, F.image_fliplr(b2)]), reduction)


def flipud_image_deaugment(image: torch.Tensor, reduction: MaybeStrOrCallable = "mean") -> torch.Tensor:
    b1, b2 = split_into_chunks(image, 2)
    return _deaugment_averaging(torch.stack([b1, F.image_flipud(b2)]), reduction)


def flips_image_augment(image: torch.Tensor) -> torch.Tensor:
    return torch.cat([image, F.image_fliplr(image), F.image_flipud(image)], dim=0)


def flips_image_deaugment(image: torch.Tensor, reduction: MaybeStrOrCallable = "mean") -> torch.Tensor:
    orig, lr, ud = split_into_chunks(image, 3)
    return _deaugment_averaging(torch.stack([orig, F.image_fliplr(lr), F.image_flipud(ud)]), reduction)


def fliplr_labels_augment(labels: torch.Tensor) -> torch.Tensor:
    return torch.cat([labels] * 2, dim=0)


def flips_labels_augment(labels: torch.Tensor) -> torch.Tensor:
    return torch.cat([labels] * 3, dim=0)


def fliplr_labels_deaugment(logits: torch.Tensor, reduction: MaybeStrOrCallable = "mean") -> torch.Tensor:
    return _reduce_chunks(logits, 2, reduction)


def flipud_labels_deaugment(logits: torch.Tensor, reduction: MaybeStrOrCallable = "mean") -> torch.Tensor:
    return _reduce_chunks(logits, 2, reduction)


def flips_labels_deaugment(logits: torch.Tensor, reduction: MaybeStrOrCallable = "mean") -> torch.Tensor:
    return _reduce_chunks(logits, 3, reduction)


def fliplr_image2label(model_fn: Callable, image: torch.Tensor) -> torch.Tensor:
    return fliplr_labels_deaugment(model_fn(fliplr_image_augment(image)))


def fliplr_image2mask(model_fn: Callable, image: torch.Tensor) -> torch.Tensor:
    return fliplr_image_deaugment(model_fn(fliplr_image_augment(image)))


def d2_image_augment(image: torch.Tensor) -> torch.Tensor:
    """[B] -> [4B]: identity, fliplr, flipud, fliplr of flipud."""
    return torch.cat([image, F.image_fliplr(image), F.image_flipud(image), F.image_fliplr(F.image_flipud(image))],
                     dim=0)


def d2_image_deaugment(image: torch.Tensor, reduction: MaybeStrOrCallable = "mean") -> torch.Tensor:
    b1, b2, b3, b4 = split_into_chunks(image, 4)
    return _deaugment_averaging(
        torch.stack([b1, F.image_fliplr(b2), F.image_flipud(b3), F.image_flipud(F.image_fliplr(b4))]), reduction
    )


def d2_labels_augment(labels: torch.Tensor) -> torch.Tensor:
    return torch.cat([labels] * 4, dim=0)


def d2_labels_deaugment(logits: torch.Tensor, reduction: MaybeStrOrCallable = "mean") -> torch.Tensor:
    return _reduce_chunks(logits, 4, reduction)


# ---------------------------------------------------------------------------
# D4 family
# ---------------------------------------------------------------------------


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
    with span("tta.augment", image):
        return torch.cat([_D4_AUG[v](image) for v in views], dim=0)


def d4_image_deaugment_views(
    image: torch.Tensor, views: Tuple[int, ...], reduction: MaybeStrOrCallable = "mean"
) -> torch.Tensor:
    """Inverse of :func:`d4_image_augment_views` + reduction over the views."""
    chunks = split_into_chunks(image, len(views))
    with span("tta.deaugment", image):
        return _deaugment_averaging(torch.stack([_D4_DEAUG[v](c) for v, c in zip(views, chunks)]), reduction)


def d4_image_augment(image: torch.Tensor) -> torch.Tensor:
    """[B] -> [8B]: rotations of the image and of its transpose."""
    return d4_image_augment_views(image, tuple(range(8)))


def d4_image_deaugment(image: torch.Tensor, reduction: MaybeStrOrCallable = "mean") -> torch.Tensor:
    return d4_image_deaugment_views(image, tuple(range(8)), reduction)


def d4_labels_augment(labels: torch.Tensor) -> torch.Tensor:
    return torch.cat([labels] * 8, dim=0)


def d4_labels_deaugment(logits: torch.Tensor, reduction: MaybeStrOrCallable = "mean") -> torch.Tensor:
    return _reduce_chunks(logits, 8, reduction)


def d4_image2label(model_fn: Callable, image: torch.Tensor) -> torch.Tensor:
    return d4_labels_deaugment(model_fn(d4_image_augment(image)))


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
    with span("tta.augment", image):
        for offset in size_offsets:
            r_off, c_off = _offset_pair(offset)
            if r_off == 0 and c_off == 0:
                augmented.append(image)
            else:
                augmented.append(resize_2d(image, (rows + r_off, cols + c_off), mode=mode,
                                           align_corners=align_corners))
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
    with span("tta.deaugment", images[0]):
        for feature_map, offset in zip(images, size_offsets):
            r_off, c_off = _offset_pair(offset)
            if r_off == 0 and c_off == 0:
                deaugmented.append(feature_map)
            else:
                rows, cols = feature_map.shape[2], feature_map.shape[3]
                original = (rows - r_off // stride, cols - c_off // stride)
                deaugmented.append(resize_2d(feature_map, original, mode=mode, align_corners=align_corners))
        return _deaugment_averaging(torch.stack(deaugmented), reduction)


# ---------------------------------------------------------------------------
# Model wrappers
# ---------------------------------------------------------------------------


class GeneralizedTTA:
    """Wrap a model callable with augment / deaugment functions.  Each may be
    a callable (one input, one output), a dict (keyword inputs; the model's
    dict outputs by key) or a list (positional inputs; the model's outputs
    in order)."""

    def __init__(
        self,
        model_fn: Callable,
        augment_fn: Union[Callable, Dict[str, Callable], List[Callable]],
        deaugment_fn: Union[Callable, Dict[str, Callable], List[Callable]],
    ):
        self.model_fn = model_fn
        self.augment_fn = augment_fn
        self.deaugment_fn = deaugment_fn

    def __call__(self, *input, **kwargs):
        if isinstance(self.augment_fn, dict):
            if len(input) != 0:
                raise ValueError("GeneralizedTTA with a dict augment_fn takes keyword inputs only")
            outputs = self.model_fn(**{key: augment(kwargs[key]) for key, augment in self.augment_fn.items()})
        elif isinstance(self.augment_fn, (list, tuple)):
            if len(kwargs) != 0:
                raise ValueError("GeneralizedTTA expects a single tensor input here")
            outputs = self.model_fn(*[augment(x) for x, augment in zip(input, self.augment_fn)])
        else:
            if len(input) != 1 or len(kwargs) != 0:
                raise ValueError("GeneralizedTTA expects a single tensor input here")
            outputs = self.model_fn(self.augment_fn(input[0]))

        if isinstance(self.deaugment_fn, dict):
            if not isinstance(outputs, dict):
                raise ValueError("A dict deaugment_fn needs the model to return a dict")
            return {key: fn(outputs[key]) for key, fn in self.deaugment_fn.items()}
        if isinstance(self.deaugment_fn, (list, tuple)):
            if not isinstance(outputs, (dict, tuple, list)):
                raise ValueError("A list deaugment_fn needs the model to return a dict/list/tuple")
            return [fn(value) for value, fn in zip(outputs, self.deaugment_fn)]
        return self.deaugment_fn(outputs)


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
        with span("tta.multiscale", device=False):
            ms_inputs = self.augment_fn(x, size_offsets=self.size_offsets, mode=self.mode,
                                        align_corners=self.align_corners)
            ms_outputs = [self.model_fn(xi) for xi in ms_inputs]
            if self.keys is None:
                return self.deaugment_fn(ms_outputs, self.size_offsets)
            return {key: self.deaugment_fn[key]([out[key] for out in ms_outputs], size_offsets=self.size_offsets)
                    for key in self.keys}


class TTAWrapper:
    """Deprecated partial application of a TTA function such as
    ``d4_image2mask``; use ``GeneralizedTTA``."""

    def __init__(self, model_fn: Callable, tta_function: Callable, **kwargs):
        warnings.warn("TTAWrapper is deprecated. Please use GeneralizedTTA instead", DeprecationWarning, stacklevel=2)
        self.model_fn = model_fn
        self.tta = partial(tta_function, **kwargs)

    def __call__(self, *input):
        return self.tta(self.model_fn, *input)
