"""Encoder base and stem surgery (counterpart of
``pytorch_toolbelt_tpu/zoo/encoders/common.py``).

An encoder's ``forward`` returns a list of NCHW feature maps ordered fine ->
coarse, and ``get_output_spec()`` describes them without a forward pass.

The stem surgery acts on an OIHW weight, a ``state_dict`` and a module,
where JAX's acts on an HWIO kernel and a flax variables tree: the input
channels are dim 1 here, axis 2 there.
"""

from typing import Any, List, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...core.interfaces import FeatureMapsSpec
from ...nn.normalization import BN_MOMENTUM, BatchNorm2d

__all__ = [
    "EncoderBase",
    "GenericEncoder",
    "_take",
    "change_stem_input_channels",
    "find_stem_kernel_path",
    "make_n_channel_input_kernel",
]


def _bn(channels: int) -> BatchNorm2d:
    return BatchNorm2d(channels, momentum=BN_MOMENTUM)


def _take(elements: Sequence[Any], indexes: Sequence[int]) -> List[Any]:
    return [elements[i] for i in indexes]


def _remat(block: nn.Module, generator: Optional[torch.Generator], *args) -> Any:
    """``block(*args)`` with its activations recomputed on the backward pass
    (``torch.utils.checkpoint``), as flax's ``nn.remat`` does.  The
    recomputation replays the drop-path masks that the forward drew from
    ``generator`` (checkpoint itself restores only torch's default
    generators) and leaves ``generator`` where the forward left it; it
    leaves the block's buffers (BatchNorm's running statistics) as the
    forward left them, so they are updated once, as flax updates them."""
    start = None if generator is None else generator.get_state()
    calls = []

    def run(*inputs):
        if not calls:
            calls.append(True)
            return block(*inputs)
        buffers = [(b, b.clone()) for b in block.buffers()]
        now = None if generator is None else generator.get_state()
        if generator is not None:
            generator.set_state(start)
        try:
            return block(*inputs)
        finally:
            if generator is not None:
                generator.set_state(now)
            with torch.no_grad():
                for b, kept in buffers:
                    b.copy_(kept)

    return checkpoint(run, *args, use_reentrant=False)


class EncoderBase(nn.Module):
    """Base class for encoders: list-of-feature-maps contract."""

    def get_output_spec(self) -> FeatureMapsSpec:
        raise NotImplementedError

    @property
    def channels(self) -> Tuple[int, ...]:
        return self.get_output_spec().channels

    @property
    def strides(self) -> Tuple[int, ...]:
        return self.get_output_spec().strides


def make_n_channel_input_kernel(kernel: torch.Tensor, in_channels: int) -> torch.Tensor:
    """Tile (then cut) an OIHW conv weight along its input channels so that
    it takes ``in_channels`` inputs."""
    i = kernel.shape[1]
    if i == in_channels:
        return kernel
    if in_channels > i:
        kernel = torch.cat([kernel] * -(-in_channels // i), dim=1)
    return kernel[:, :in_channels]


def find_stem_kernel_path(state_dict: Mapping[str, torch.Tensor], in_channels: int = 3) -> str:
    """The key of the stem conv's weight in a ``state_dict``: the first 4-D
    ``weight`` (in the order the module registered it) with ``in_channels``
    input channels."""
    for key, value in state_dict.items():
        if key.rsplit(".", 1)[-1] == "weight" and value.ndim == 4 and value.shape[1] == in_channels:
            return key
    raise ValueError(f"No 4-D conv weight with {in_channels} input channels found in the state dict")


def change_stem_input_channels(module: nn.Module, stem_kernel_path: Optional[str], in_channels: int) -> nn.Module:
    """Make the stem conv of ``module`` take ``in_channels`` inputs, in place,
    by tiling its weight; return the module.  ``stem_kernel_path`` is the
    weight's ``state_dict`` key; ``None`` finds it by
    :func:`find_stem_kernel_path` (assuming a 3-channel stem)."""
    if stem_kernel_path is None:
        stem_kernel_path = find_stem_kernel_path(module.state_dict())
    conv = module.get_submodule(stem_kernel_path.rsplit(".", 1)[0])
    with torch.no_grad():
        conv.weight = nn.Parameter(make_n_channel_input_kernel(conv.weight, in_channels).clone())
    conv.in_channels = in_channels
    return module


class GenericEncoder(EncoderBase):
    """Wrap a feature extractor into the encoder contract: ``backbone(x)``
    returns NCHW feature maps fine -> coarse, which ``spec`` describes."""

    def __init__(self, backbone: nn.Module, spec: FeatureMapsSpec):
        super().__init__()
        self.backbone = backbone
        self.spec = spec

    def get_output_spec(self) -> FeatureMapsSpec:
        return self.spec

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        return self.backbone(x)
