"""Activation registry (counterpart of ``pytorch_toolbelt_tpu/nn/activations.py``).

Activations are plain tensor functions, named as in the JAX package, and
``PReLU``, ``ABN`` and ``AGN`` are modules.  ``gelu`` is the tanh
approximation, the default of ``jax.nn.gelu``.  ``glu`` and ``softmax`` act
on the channel dim 1 of NCHW tensors, where JAX's act on the last axis of
NHWC ones.

``instantiate_activation_block("prelu")`` returns a new ``PReLU`` module: a
block that applies one activation twice registers it once, so both uses
share its weight, as flax's do.
"""

from functools import partial
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from .normalization import BatchNorm2d

__all__ = [
    "ABN",
    "AGN",
    "ACT_CELU",
    "ACT_ELU",
    "ACT_GELU",
    "ACT_GLU",
    "ACT_HARD_SIGMOID",
    "ACT_HARD_SWISH",
    "ACT_LEAKY_RELU",
    "ACT_MISH",
    "ACT_MISH_NAIVE",
    "ACT_NONE",
    "ACT_PRELU",
    "ACT_RELU",
    "ACT_RELU6",
    "ACT_SELU",
    "ACT_SIGMOID",
    "ACT_SILU",
    "ACT_SOFTMAX",
    "ACT_SOFTPLUS",
    "ACT_SWISH",
    "ACT_SWISH_NAIVE",
    "PReLU",
    "get_activation_block",
    "get_activation_fn",
    "hard_sigmoid",
    "hard_swish",
    "identity",
    "instantiate_activation_block",
    "mish",
    "mish_naive",
    "relu6",
    "sanitize_activation_name",
    "swish",
    "swish_naive",
]

ACT_CELU = "celu"
ACT_ELU = "elu"
ACT_GELU = "gelu"
ACT_GLU = "glu"
ACT_HARD_SIGMOID = "hard_sigmoid"
ACT_HARD_SWISH = "hard_swish"
ACT_LEAKY_RELU = "leaky_relu"
ACT_MISH = "mish"
ACT_MISH_NAIVE = "mish_naive"
ACT_NONE = "none"
ACT_PRELU = "prelu"
ACT_RELU = "relu"
ACT_RELU6 = "relu6"
ACT_SELU = "selu"
ACT_SIGMOID = "sigmoid"
ACT_SILU = "silu"
ACT_SOFTMAX = "softmax"
ACT_SOFTPLUS = "softplus"
ACT_SWISH = "swish"
ACT_SWISH_NAIVE = "swish_naive"

swish = F.silu
mish = F.mish
# JAX keeps the reference's "naive" spellings, which differ there only in autograd memory
mish_naive = mish
swish_naive = swish
hard_sigmoid = F.hardsigmoid  # relu6(x + 3) / 6
relu6 = F.relu6


def hard_swish(x: torch.Tensor) -> torch.Tensor:
    """``x * hard_sigmoid(x)``, rounded as the JAX package rounds it;
    ``F.hardswish`` rounds ``(x * relu6(x + 3)) / 6``, which differs in the
    last bit for ~1 input in 5."""
    return x * hard_sigmoid(x)


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


_ACTIVATIONS = {
    ACT_CELU: F.celu,
    ACT_ELU: F.elu,
    ACT_GELU: partial(F.gelu, approximate="tanh"),
    ACT_GLU: partial(F.glu, dim=1),
    ACT_HARD_SIGMOID: hard_sigmoid,
    ACT_HARD_SWISH: hard_swish,
    ACT_LEAKY_RELU: F.leaky_relu,
    ACT_MISH: mish,
    ACT_MISH_NAIVE: mish,
    ACT_NONE: identity,
    ACT_RELU: F.relu,
    ACT_RELU6: relu6,
    ACT_SELU: F.selu,
    ACT_SIGMOID: torch.sigmoid,
    ACT_SILU: F.silu,
    ACT_SOFTMAX: partial(F.softmax, dim=1),
    ACT_SOFTPLUS: F.softplus,
    ACT_SWISH: swish,
    ACT_SWISH_NAIVE: swish,
}


def get_activation_fn(activation_name: str) -> Callable:
    """String -> activation function."""
    name = activation_name.lower()
    if name == ACT_PRELU:
        raise ValueError("prelu is parametric; use instantiate_activation_block or PReLU")
    return _ACTIVATIONS[name]


get_activation_block = get_activation_fn


def instantiate_activation_block(activation_name: str, **kwargs) -> Callable:
    """Return the activation callable, taking the kwargs the JAX factory
    takes for it: ``slope`` (leaky_relu), ``dim`` (softmax, here an NCHW dim,
    default 1) and ``num_parameters`` (prelu, a new module); ``inplace`` is
    ignored."""
    name = activation_name.lower()
    if name == ACT_LEAKY_RELU and kwargs.get("slope") is not None:
        return partial(F.leaky_relu, negative_slope=kwargs["slope"])
    if name == ACT_SOFTMAX:
        return partial(F.softmax, dim=kwargs.get("dim", 1))
    if name == ACT_PRELU:
        return PReLU(num_parameters=kwargs.get("num_parameters", 1))
    return get_activation_fn(name)


def sanitize_activation_name(activation_name: str) -> str:
    """Map swish and mish to leaky_relu, for a kaiming-style init gain."""
    if activation_name in {ACT_MISH, ACT_SWISH, ACT_SWISH_NAIVE, ACT_MISH_NAIVE}:
        return ACT_LEAKY_RELU
    return activation_name


class PReLU(nn.PReLU):
    """Parametric ReLU: one slope, or one per channel (dim 1).  flax's
    ``alpha`` is torch's ``weight``."""

    def __init__(self, num_parameters: int = 1, init_value: float = 0.25):
        super().__init__(num_parameters, init_value)


class ABN(nn.Module):
    """BatchNorm + activation.  ``momentum`` is torch's: 0.1 is flax's 0.9."""

    def __init__(self, num_features: int, activation: str = ACT_RELU, slope: float = 0.01, eps: float = 1e-5,
                 momentum: float = 0.1):
        super().__init__()
        self.norm = BatchNorm2d(num_features, eps=eps, momentum=momentum)
        self.act = instantiate_activation_block(activation, slope=slope)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.norm(x))


class AGN(nn.Module):
    """GroupNorm + activation."""

    def __init__(self, num_channels: int, num_groups: int = 32, activation: str = ACT_RELU, slope: float = 0.01,
                 eps: float = 1e-5):
        super().__init__()
        self.norm = nn.GroupNorm(num_groups, num_channels, eps=eps)
        self.act = instantiate_activation_block(activation, slope=slope)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.norm(x))
