"""Weight bridge from the JAX package's flax models to the port's modules
(the inverse of ``pytorch_toolbelt_tpu/zoo/porting.py``).

:func:`load_flax_variables` takes a flax variables tree as nested dicts of
numpy arrays, so the port needs no jax, and fills the matching torch module:

* conv kernel HWIO -> OIHW (``.transpose(3, 2, 0, 1)``), conv bias copied;
  a grouped conv's kernel is HWIO with I = in / groups, and the same
  transpose gives torch's ``[O, I / groups, kh, kw]``;
* ``ConvTranspose`` kernel HWIO -> torch's IOHW, flipped in space: flax's
  transposed conv correlates the dilated input with the kernel as it is,
  torch's with the kernel flipped;
* ``Dense`` kernel [in, out] -> ``nn.Linear`` weight [out, in], bias
  copied; an ``nn.LazyLinear`` is materialized at the kernel's shape;
* BatchNorm ``scale/bias`` -> ``weight/bias`` and ``batch_stats``
  ``mean/var`` -> ``running_mean/running_var`` (``BatchNorm2d``, and
  ``BatchNorm1d`` for flax's BatchNorm on ``[B, F]``); GroupNorm and
  LayerNorm ``scale/bias``; PReLU ``alpha`` -> ``weight``;
* ``DropBlockScheduled``'s ``state`` variable ``step`` -> its ``step`` buffer;
* a module's own parameters (``nn.Parameter`` attributes, e.g. BiFPN's
  ``w1``/``w2``, GeM's ``p``, the pools' ``weights``) are flax params of
  the same name and shape (Swin's ``relative_position_bias``, SRM's
  ``cfc``).

Flax names a submodule by its class and creation order (``Conv_0``,
``BatchNorm_1``, ``UnetResidualBlock_2``), one counter per class, unless
the module names it.  The port's modules register their children in the
order flax creates them, so by default a module's children, with
``nn.Sequential`` and ``nn.ModuleList`` flattened, are named that way:
``Conv2d`` is ``Conv``, ``ConvTranspose2d`` ``ConvTranspose``,
``BatchNorm1d``/``2d`` ``BatchNorm``, ``Linear`` ``Dense``, any other module
its class name.  A ``UnetResidualBlock`` with a shortcut conv has it as ``Conv_0``, created
before its 3x3 convs; the UNet decoder's upsample layers and blocks are
numbered coarsest stage first.  MiT and Swin name their blocks by hand
(``MiTBlock_{i}``, ``SwinBlock_{i}``, counted over all stages), which is
how the numbering names them.  The exceptions are named here: the
composite models' and ``GenericEncoder``'s attributes, the SENet's own
names (``layer0_conv1``, ``layer{s}_{i}/conv1``, ``.../se/se_fc1``) and the
FPN decoder's ``Conv_0..Conv_{L-1}`` (the laterals fine -> coarse, then one
prediction conv per fused level, the second-coarsest first).
``FullyConnectedClassificationHead`` flattens NCHW in (c, h, w) order where
flax flattens NHWC in (h, w, c) order, so its kernel's rows are reordered.

:func:`flax_name_map` gives the reverse map, torch name -> flax path, which
the parity tests use to compare gradients, param groups and running
statistics with the JAX package's.
"""

from typing import Callable, Dict, Iterator, List, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from ..nn.dropblock import DropBlockScheduled
from .decoders.fpn import FPNDecoder
from .encoders.common import GenericEncoder
from .encoders.senet import SENetBottleneck, SENetEncoder, SEModule
from .heads.classification import FullyConnectedClassificationHead
from .models import EncoderDecoderModel, UNetSegmentationModel

__all__ = ["flax_name_map", "load_flax_variables"]

_Leaf = Tuple[str, Tuple[str, ...], torch.Tensor, Callable[[np.ndarray], np.ndarray]]

# flax's class name of the torch modules whose flax counterpart is a flax layer
_FLAX_CLASS = ((nn.Conv2d, "Conv"), (nn.ConvTranspose2d, "ConvTranspose"), (nn.BatchNorm2d, "BatchNorm"),
               (nn.BatchNorm1d, "BatchNorm"), (nn.GroupNorm, "GroupNorm"), (nn.Linear, "Dense"))


def _same(a: np.ndarray) -> np.ndarray:
    return a


def _hwio_to_oihw(a: np.ndarray) -> np.ndarray:
    return a.transpose(3, 2, 0, 1)


def _flax_transpose_kernel(a: np.ndarray) -> np.ndarray:
    return a[::-1, ::-1].transpose(2, 3, 0, 1)


def _dense_kernel(a: np.ndarray) -> np.ndarray:
    return a.T


def _nhwc_flat_dense_kernel(channels: int) -> Callable[[np.ndarray], np.ndarray]:
    """A Dense kernel over NHWC-flattened [h, w, c] rows -> a Linear weight
    over NCHW-flattened (c, h, w) columns."""

    def reorder(a: np.ndarray) -> np.ndarray:
        k = a.shape[-1]
        return a.reshape(-1, channels, k).transpose(1, 0, 2).reshape(-1, k).T

    return reorder


def _flax_class(module: nn.Module) -> str:
    for cls, name in _FLAX_CLASS:
        if isinstance(module, cls):
            return name
    return type(module).__name__


def _flat(modules) -> Iterator[nn.Module]:
    for module in modules:
        if isinstance(module, (nn.Sequential, nn.ModuleList)):
            yield from _flat(module)
        else:
            yield module


def _numbered(modules) -> List[Tuple[str, nn.Module]]:
    """Name ``modules`` as flax names the submodules it creates in this order."""
    counts: Dict[str, int] = {}
    named = []
    for module in _flat(modules):
        cls = _flax_class(module)
        named.append((f"{cls}_{counts.get(cls, 0)}", module))
        counts[cls] = counts.get(cls, 0) + 1
    return named


def _children(module: nn.Module):
    if isinstance(module, EncoderDecoderModel) and not isinstance(module, UNetSegmentationModel):
        return [("encoder", module.encoder), ("decoder", module.decoder), ("head", module.head)]
    if isinstance(module, GenericEncoder):
        return [("backbone", module.backbone)]
    if isinstance(module, SENetEncoder):
        stem = [(f"layer0_{name}", child) for name, child in module.layer0.named_children()
                if not isinstance(child, nn.ReLU)]
        return stem + [(f"layer{s}_{i}", block) for s, stage in enumerate(module.stages, start=1)
                       for i, block in enumerate(stage)]
    if isinstance(module, SENetBottleneck):
        children = [(name, getattr(module, name)) for name in ("conv1", "bn1", "conv2", "bn2", "conv3", "bn3")]
        if module.downsample is not None:
            children += [("downsample_conv", module.downsample[0]), ("downsample_bn", module.downsample[1])]
        return children + [("se", module.se_module)]
    if isinstance(module, SEModule):
        return [("se_fc1", module.fc1), ("se_fc2", module.fc2)]
    if isinstance(module, FPNDecoder):
        convs = list(module.lateral) + [p for p in module.predict if isinstance(p, nn.Conv2d)]
        return [(f"Conv_{i}", conv) for i, conv in enumerate(convs)]
    return _numbered(module.children())


def _leaves(module: nn.Module, path: Tuple[str, ...]) -> Iterator[_Leaf]:
    if isinstance(module, FullyConnectedClassificationHead):
        fc = path + ("Dense_0",)
        yield "params", fc + ("kernel",), module.fc.weight, _nhwc_flat_dense_kernel(module.in_channels)
        yield "params", fc + ("bias",), module.fc.bias, _same
        return
    if isinstance(module, nn.Linear):
        yield "params", path + ("kernel",), module.weight, _dense_kernel
        if module.bias is not None:
            yield "params", path + ("bias",), module.bias, _same
        return
    if isinstance(module, (nn.Conv2d, nn.ConvTranspose2d)):
        kernel = _flax_transpose_kernel if isinstance(module, nn.ConvTranspose2d) else _hwio_to_oihw
        yield "params", path + ("kernel",), module.weight, kernel
        if module.bias is not None:
            yield "params", path + ("bias",), module.bias, _same
        return
    if isinstance(module, (nn.BatchNorm1d, nn.BatchNorm2d, nn.GroupNorm, nn.LayerNorm)):
        yield "params", path + ("scale",), module.weight, _same
        yield "params", path + ("bias",), module.bias, _same
        if not isinstance(module, (nn.GroupNorm, nn.LayerNorm)):
            yield "batch_stats", path + ("mean",), module.running_mean, _same
            yield "batch_stats", path + ("var",), module.running_var, _same
        return
    if isinstance(module, DropBlockScheduled):
        yield "state", path + ("step",), module.step, _same
        return
    if isinstance(module, nn.PReLU):
        yield "params", path + ("alpha",), module.weight, _same
        return
    for name, param in module.named_parameters(recurse=False):
        yield "params", path + (name,), param, _same
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
            if isinstance(tensor, nn.parameter.UninitializedParameter):
                tensor.materialize(value.shape)
            if tuple(value.shape) != tuple(tensor.shape):
                raise ValueError(f"{'/'.join(key)}: shape {value.shape} does not fit {tuple(tensor.shape)}")
            tensor.copy_(torch.from_numpy(np.ascontiguousarray(value).reshape(value.shape)))  # 0-d stays 0-d
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


def flax_name_map(model: nn.Module) -> Dict[str, Tuple[str, Tuple[str, ...]]]:
    """{torch parameter or buffer name: (flax collection, flax path)} for
    every tensor :func:`load_flax_variables` fills, e.g.
    ``'encoder.layer0.conv1.weight' -> ('params', ('encoder', 'layer0_conv1', 'kernel'))``.
    The layout change of each tensor is the one ``load_flax_variables`` applies."""
    name_of = {id(t): name for name, t in model.named_parameters()}
    name_of.update({id(t): name for name, t in model.named_buffers()})
    return {name_of[id(tensor)]: (collection, path) for collection, path, tensor, _ in _leaves(model, ())}
