"""Tensor and module helpers (counterpart of ``pytorch_toolbelt_tpu/utils/tensor.py``).

Where the JAX package walks a params pytree, these walk an ``nn.Module``'s
``named_parameters`` or a ``state_dict``; images are CHW tensors, where the
JAX package keeps HWC arrays.
"""

from typing import Any, Dict, List, Mapping, Optional, Union

import numpy as np
import torch
from torch import nn

__all__ = [
    "argmax_over",
    "count_parameters",
    "to_numpy",
    "to_tensor",
    "image_to_tensor",
    "tensor_from_rgb_image",
    "rgb_image_from_tensor",
    "mask_from_tensor",
    "transfer_weights",
    "describe_outputs",
    "resize_like",
    "logit",
    "sigmoid_with_threshold",
    "move_to_device",
    "container_to_tensor",
    "int_to_string_human_friendly",
    "softmax_over",
]


def count_parameters(
    model: nn.Module, keys: Optional[List[str]] = None, human_friendly: bool = False
) -> Dict[str, Union[int, str]]:
    """Count a module's parameters: the total, and per top-level child
    (``keys`` picks which; default: all of them)."""

    def _count(module: nn.Module) -> int:
        return sum(p.numel() for p in module.parameters())

    def _fmt(n: int):
        if not human_friendly:
            return n
        for divisor, unit in [(1e9, "G"), (1e6, "M"), (1e3, "K")]:
            if n >= divisor:
                return f"{n / divisor:.2f}{unit}"
        return str(n)

    total = {"total": _fmt(_count(model))}
    children = dict(model.named_children())
    for key in keys if keys is not None else list(children):
        if key in children:
            total[key] = _fmt(_count(children[key]))
    return total


def to_numpy(x) -> np.ndarray:
    """Convert a tensor (any device), numpy array, list or scalar to numpy."""
    if isinstance(x, np.ndarray):
        return x
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, (list, tuple, int, float)):
        return np.array(x)
    raise ValueError("Unsupported type")


def to_tensor(x, dtype=None) -> torch.Tensor:
    """Convert numpy / list / scalar to a CPU tensor."""
    t = torch.as_tensor(np.asarray(x))
    return t if dtype is None else t.to(dtype)


def image_to_tensor(image: np.ndarray, dummy_channels_dim: bool = True) -> torch.Tensor:
    """HWC numpy image -> CHW tensor; a 2D mask becomes [1, H, W] if
    ``dummy_channels_dim``, else stays [H, W]."""
    if image.ndim == 2:
        if not dummy_channels_dim:
            return torch.from_numpy(np.ascontiguousarray(image))
        image = np.expand_dims(image, -1)
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(image, -1, 0)))


tensor_from_rgb_image = image_to_tensor


def rgb_image_from_tensor(
    image: torch.Tensor, mean=0.0, std=1.0, max_pixel_value: float = 255.0, dtype=np.uint8
) -> np.ndarray:
    """Denormalize a [C, H, W] tensor back to an HWC numpy image."""
    image = np.moveaxis(to_numpy(image), 0, -1)
    rgb = (image * np.asarray(std) + np.asarray(mean)) * max_pixel_value
    return rgb.clip(0, max_pixel_value).astype(dtype)


def mask_from_tensor(mask: torch.Tensor, squeeze_single_channel: bool = False, dtype=None) -> np.ndarray:
    """[C, H, W] (or [H, W]) tensor -> numpy; [1, H, W] -> [H, W] if asked."""
    mask = to_numpy(mask)
    if squeeze_single_channel and mask.ndim == 3 and mask.shape[0] == 1:
        mask = mask[0]
    if dtype is not None:
        mask = mask.astype(dtype)
    return mask


def transfer_weights(model: nn.Module, source: Mapping[str, torch.Tensor], verbose: bool = False):
    """Shape-tolerant weight transfer: copy every entry of the ``source``
    state dict whose name is in ``model``'s state dict with the same shape.

    Returns (model, transferred names, skipped names of the model).
    """
    target = model.state_dict()
    transferred, skipped, update = [], [], {}
    for name, value in target.items():
        if name in source and tuple(source[name].shape) == tuple(value.shape):
            update[name] = source[name].to(dtype=value.dtype)
            transferred.append(name)
        else:
            skipped.append(name)
    model.load_state_dict(update, strict=False)
    if verbose:
        print(f"Transferred {len(transferred)} tensors, skipped {len(skipped)}")
    return model, transferred, skipped


def describe_outputs(outputs) -> Union[Dict, List, Any]:
    """Shape / dtype / min / max / mean summary of nested outputs."""
    if isinstance(outputs, (torch.Tensor, np.ndarray)):
        x = to_numpy(outputs)
        return {
            "shape": tuple(x.shape),
            "dtype": str(x.dtype),
            "min": float(x.min()) if x.size else None,
            "max": float(x.max()) if x.size else None,
            "mean": float(x.mean()) if x.size and np.issubdtype(x.dtype, np.floating) else None,
        }
    if isinstance(outputs, dict):
        return {k: describe_outputs(v) for k, v in outputs.items()}
    if isinstance(outputs, (list, tuple)):
        return [describe_outputs(v) for v in outputs]
    return repr(outputs)


def resize_like(x: torch.Tensor, target: torch.Tensor, mode: str = "bilinear", align_corners: bool = False):
    """Resize NCHW ``x`` to ``target``'s spatial size."""
    from ..nn.functional import resize_2d

    return resize_2d(x, tuple(target.shape[2:4]), mode=mode, align_corners=align_corners)


def logit(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x = x.clamp(eps, 1.0 - eps)
    return torch.log(x / (1.0 - x))


def sigmoid_with_threshold(x: torch.Tensor, threshold: float = 0.5, dtype=torch.float32) -> torch.Tensor:
    return (torch.sigmoid(x) > threshold).to(dtype)


def move_to_device(x, device, non_blocking: bool = False):
    """Recursively move the tensors (and numeric numpy arrays) of nested
    dicts, lists and tuples to ``device``; other leaves pass through."""
    if isinstance(x, torch.Tensor):
        return x.to(device, non_blocking=non_blocking)
    if isinstance(x, np.ndarray) and x.dtype.kind not in {"O", "M", "U", "S"}:
        return torch.from_numpy(x).to(device, non_blocking=non_blocking)
    if isinstance(x, dict):
        return {k: move_to_device(v, device, non_blocking) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(move_to_device(v, device, non_blocking) for v in x)
    return x


def container_to_tensor(value):
    """Recursively convert numeric numpy arrays inside lists / tuples /
    mappings to tensors; non-numeric leaves (strings, objects) pass through."""
    if isinstance(value, torch.Tensor):
        return value
    if isinstance(value, np.ndarray) and value.dtype.kind not in {"O", "M", "U", "S"}:
        return torch.from_numpy(value)
    if isinstance(value, list):
        return [container_to_tensor(item) for item in value]
    if isinstance(value, tuple):
        return tuple(container_to_tensor(item) for item in value)
    if isinstance(value, dict):
        return {key: container_to_tensor(item) for key, item in value.items()}
    return value


def int_to_string_human_friendly(value: int) -> str:
    """1234 -> '1.23K', 2_500_000 -> '2.50M', ..."""
    if value < 1_000:
        return str(value)
    if value < 1_000_000:
        return f"{value / 1e3:.2f}K"
    if value < 10_000_000:
        return f"{value / 1e6:.2f}M"
    if value < 1_000_000_000:
        return f"{value / 1e6:.1f}M"
    return f"{value / 1e9:.2f}B"


def softmax_over(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Softmax over ``dim`` (NCHW: the channels)."""
    return torch.softmax(x, dim=dim)


def argmax_over(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Argmax over ``dim`` (NCHW: the channels)."""
    return torch.argmax(x, dim=dim)
