"""D4 geometric primitives and probability means for NCHW tensors
(counterpart of ``pytorch_toolbelt_tpu/inference/functional.py``, whose
tensors are NHWC).  The spatial dims are (2, 3)."""

import torch

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
