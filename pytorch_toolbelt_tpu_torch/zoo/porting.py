"""Weight bridge from the JAX package's flax models to the port's modules
(the inverse of ``pytorch_toolbelt_tpu/zoo/porting.py``).

:func:`load_flax_variables` takes a flax variables tree as nested dicts of
numpy arrays, so the port needs no jax, and fills the matching torch module:

* conv kernel HWIO -> OIHW (``.transpose(3, 2, 0, 1)``), conv bias copied;
* BatchNorm ``scale/bias`` -> ``weight/bias`` and ``batch_stats``
  ``mean/var`` -> ``running_mean/running_var``; GroupNorm ``scale/bias``.

Flax names submodules by class and creation order; the decoder creates its
blocks coarsest stage first, so ``UNetDecoder_0/UnetBlock_0`` is the
coarsest stage's block, which is also ``decoder.stages[0]`` here.
"""

from typing import Callable, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from ..nn.normalization import Normalization
from ..nn.unet import UnetBlock
from .decoders.unet import UNetDecoder
from .encoders.unet import UnetEncoder
from .heads.resize import ResizeHead
from .models import EncoderDecoderModel, UNetSegmentationModel

__all__ = ["load_flax_variables"]

_Leaf = Tuple[str, Tuple[str, ...], torch.Tensor, Callable[[np.ndarray], np.ndarray]]


def _same(a: np.ndarray) -> np.ndarray:
    return a


def _hwio_to_oihw(a: np.ndarray) -> np.ndarray:
    return a.transpose(3, 2, 0, 1)


def _children(module: nn.Module):
    if isinstance(module, UNetSegmentationModel):
        return [("UnetEncoder_0", module.encoder), ("UNetDecoder_0", module.decoder), ("ResizeHead_0", module.head)]
    if isinstance(module, EncoderDecoderModel):
        return [("encoder", module.encoder), ("decoder", module.decoder), ("head", module.head)]
    if isinstance(module, UnetEncoder):
        return [(f"UnetBlock_{i}", block) for i, block in enumerate(module.blocks)]
    if isinstance(module, UNetDecoder):
        blocks = [block for stage in module.stages for block in stage]
        return [(f"UnetBlock_{i}", block) for i, block in enumerate(blocks)]
    if isinstance(module, UnetBlock):
        return [("Conv_0", module.conv1), ("Normalization_0", module.norm1),
                ("Conv_1", module.conv2), ("Normalization_1", module.norm2)]
    if isinstance(module, ResizeHead):
        return [("Conv_0", module.conv)]
    raise NotImplementedError(f"no flax layout known for {type(module).__name__}")


def _leaves(module: nn.Module, path: Tuple[str, ...]) -> Iterator[_Leaf]:
    if isinstance(module, nn.Conv2d):
        yield "params", path + ("kernel",), module.weight, _hwio_to_oihw
        if module.bias is not None:
            yield "params", path + ("bias",), module.bias, _same
        return
    if isinstance(module, Normalization):
        norm = module.norm
        if isinstance(norm, nn.BatchNorm2d):
            scope = path + ("BatchNorm_0",)
            yield "params", scope + ("scale",), norm.weight, _same
            yield "params", scope + ("bias",), norm.bias, _same
            yield "batch_stats", scope + ("mean",), norm.running_mean, _same
            yield "batch_stats", scope + ("var",), norm.running_var, _same
        elif isinstance(norm, nn.GroupNorm):
            scope = path + ("GroupNorm_0",)
            yield "params", scope + ("scale",), norm.weight, _same
            yield "params", scope + ("bias",), norm.bias, _same
        return
    for name, child in _children(module):
        yield from _leaves(child, path + (name,))


def _flatten(node: Mapping, prefix: Tuple[str, ...], out: Dict[Tuple[str, ...], np.ndarray]) -> None:
    for key, value in node.items():
        if isinstance(value, Mapping):
            _flatten(value, prefix + (key,), out)
        else:
            out[prefix + (key,)] = np.asarray(value)


def load_flax_variables(model: nn.Module, variables: Mapping) -> nn.Module:
    """Fill ``model`` in place from flax ``variables`` ({'params': ...,
    'batch_stats': ...} as nested dicts of numpy arrays) and return it.

    Raises if a flax leaf is left unused, a module parameter or running
    statistic is left unset, or a shape disagrees.
    """
    flat: Dict[Tuple[str, ...], np.ndarray] = {}
    _flatten(variables, (), flat)
    used, filled = set(), set()
    with torch.no_grad():
        for collection, path, tensor, transform in _leaves(model, ()):
            key = (collection,) + path
            if key not in flat:
                raise KeyError(f"flax variables lack {'/'.join(key)}")
            value = transform(flat[key].astype(np.float32))
            if tuple(value.shape) != tuple(tensor.shape):
                raise ValueError(f"{'/'.join(key)}: shape {value.shape} does not fit {tuple(tensor.shape)}")
            tensor.copy_(torch.from_numpy(np.ascontiguousarray(value)))
            used.add(key)
            filled.add(id(tensor))
    unused = sorted("/".join(k) for k in set(flat) - used)
    if unused:
        raise ValueError(f"flax leaves left unused: {unused}")
    tensors = list(model.named_parameters()) + [
        (name, buf) for name, buf in model.named_buffers() if not name.endswith("num_batches_tracked")
    ]
    unset = [name for name, t in tensors if id(t) not in filled]
    if unset:
        raise ValueError(f"module tensors left unset: {unset}")
    return model
