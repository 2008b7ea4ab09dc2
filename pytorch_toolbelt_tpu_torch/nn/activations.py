"""Activation registry (counterpart of ``pytorch_toolbelt_tpu/nn/activations.py``).

Activations are plain tensor functions, named as in the JAX package.  Only
the elementwise activations a UNet block can name are ported; the parametric
and normalising module classes (``PReLU``, ``ABN``, ``AGN``) and the
shape-changing ``glu``/``softmax`` come later.  ``gelu`` is the tanh
approximation, the default of ``jax.nn.gelu``.
"""

from functools import partial
from typing import Callable

import torch
import torch.nn.functional as F

__all__ = [
    "ACT_CELU",
    "ACT_ELU",
    "ACT_GELU",
    "ACT_HARD_SIGMOID",
    "ACT_HARD_SWISH",
    "ACT_LEAKY_RELU",
    "ACT_MISH",
    "ACT_MISH_NAIVE",
    "ACT_NONE",
    "ACT_RELU",
    "ACT_RELU6",
    "ACT_SELU",
    "ACT_SIGMOID",
    "ACT_SILU",
    "ACT_SOFTPLUS",
    "ACT_SWISH",
    "ACT_SWISH_NAIVE",
    "get_activation_fn",
    "instantiate_activation_block",
]

ACT_CELU = "celu"
ACT_ELU = "elu"
ACT_GELU = "gelu"
ACT_HARD_SIGMOID = "hard_sigmoid"
ACT_HARD_SWISH = "hard_swish"
ACT_LEAKY_RELU = "leaky_relu"
ACT_MISH = "mish"
ACT_MISH_NAIVE = "mish_naive"
ACT_NONE = "none"
ACT_RELU = "relu"
ACT_RELU6 = "relu6"
ACT_SELU = "selu"
ACT_SIGMOID = "sigmoid"
ACT_SILU = "silu"
ACT_SOFTPLUS = "softplus"
ACT_SWISH = "swish"
ACT_SWISH_NAIVE = "swish_naive"


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


_ACTIVATIONS = {
    ACT_CELU: F.celu,
    ACT_ELU: F.elu,
    ACT_GELU: partial(F.gelu, approximate="tanh"),
    ACT_HARD_SIGMOID: F.hardsigmoid,
    ACT_HARD_SWISH: F.hardswish,
    ACT_LEAKY_RELU: F.leaky_relu,
    ACT_MISH: F.mish,
    ACT_MISH_NAIVE: F.mish,
    ACT_NONE: _identity,
    ACT_RELU: F.relu,
    ACT_RELU6: F.relu6,
    ACT_SELU: F.selu,
    ACT_SIGMOID: torch.sigmoid,
    ACT_SILU: F.silu,
    ACT_SOFTPLUS: F.softplus,
    ACT_SWISH: F.silu,
    ACT_SWISH_NAIVE: F.silu,
}


def get_activation_fn(activation_name: str) -> Callable:
    """String -> elementwise activation function."""
    name = activation_name.lower()
    if name not in _ACTIVATIONS:
        raise KeyError(f"Activation {activation_name!r} is not ported; known: {sorted(_ACTIVATIONS)}")
    return _ACTIVATIONS[name]


def instantiate_activation_block(activation_name: str, **kwargs) -> Callable:
    """Return the activation callable, taking the kwargs the JAX factory
    takes for it (``slope`` for leaky_relu); ``inplace`` is ignored."""
    name = activation_name.lower()
    if name == ACT_LEAKY_RELU and kwargs.get("slope") is not None:
        return partial(F.leaky_relu, negative_slope=kwargs["slope"])
    return get_activation_fn(name)
