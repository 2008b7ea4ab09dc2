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
* NFNet's ``WSConv``: ``kernel`` HWIO -> OIHW, ``bias`` and ``gain`` copied
  (the standardization runs at every call, so the raw kernel is stored);
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
names (``layer0_conv1``, ``layer{s}_{i}/conv1``, ``.../se/se_fc1``), the
WiderResNet's (``mod1_conv1``, ``mod{m}_block{b}/proj_conv``, the port's
attribute names) and the FPN decoder's ``Conv_0..Conv_{L-1}`` (the laterals fine -> coarse, then one
prediction conv per fused level, the second-coarsest first).
``FullyConnectedClassificationHead`` flattens NCHW in (c, h, w) order where
flax flattens NHWC in (h, w, c) order, so its kernel's rows are reordered.

:func:`flax_name_map` gives the reverse map, torch name -> flax path, which
the parity tests use to compare gradients, param groups and running
statistics with the JAX package's.

:func:`port_torch_state_dict` fills a port module from a state dict in the
layout of the reference's torch modules (pytorch-toolbelt's and Cadene's
backbones), through a mapping {flax path: torch key} of the JAX package's
form.  The mapping builders below are the JAX package's, copied: each flax
path reaches the port's tensor through the bridge's naming, and a
reference tensor, already in torch layout, is copied as it is.
"""

from typing import Callable, Dict, Iterator, List, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from ..nn.dropblock import DropBlockScheduled
from .decoders.fpn import FPNDecoder
from .encoders.common import GenericEncoder
from .encoders.mobilenet import _V2_CONFIG
from .encoders.nfnet import WSConv
from .encoders.senet import SENetBottleneck, SENetEncoder, SEModule
from .encoders.wide_resnet import _MODULE_CHANNELS, IdentityResidualBlock, WiderResNetEncoder
from .heads.classification import FullyConnectedClassificationHead
from .models import EncoderDecoderModel, UNetSegmentationModel

__all__ = [
    "bn_mapping",
    "conv_mapping",
    "flax_name_map",
    "fpn_decoder_mapping",
    "inception_v4_mapping",
    "load_flax_variables",
    "mobilenet_v2_mapping",
    "port_torch_state_dict",
    "prefix_mapping",
    "resize_head_mapping",
    "senet_mapping",
    "wider_resnet_mapping",
]

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
    if isinstance(module, (WiderResNetEncoder, IdentityResidualBlock)):
        return list(module.named_children())
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
    if isinstance(module, WSConv):
        yield "params", path + ("kernel",), module.weight, _hwio_to_oihw
        yield "params", path + ("bias",), module.bias, _same
        yield "params", path + ("gain",), module.gain, _same
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


def port_torch_state_dict(model: nn.Module, state_dict: Mapping[str, torch.Tensor],
                          mapping: Mapping[Tuple[str, ...], str], strict: bool = True) -> nn.Module:
    """Copy the tensors of a reference-layout torch ``state_dict`` into
    ``model`` in place and return it.

    ``mapping`` is {flax path: torch key}, the flax path with its collection
    first (``('params', 'Conv_0', 'kernel')``, ``('batch_stats',
    'BatchNorm_0', 'mean')``), as the JAX package's ``port_torch_state_dict``
    takes it and the builders of this module make it.  A flax path the
    model lacks raises ``KeyError``; a torch key the state dict lacks raises
    ``KeyError`` under ``strict`` and is skipped otherwise; a tensor of
    another shape than the model's raises ``ValueError``.  Tensors no entry
    maps keep their values.
    """
    tensors = {(collection,) + path: tensor for collection, path, tensor, _ in _leaves(model, ())}
    with torch.no_grad():
        for flax_path, torch_key in mapping.items():
            flax_path = tuple(str(p) for p in flax_path)
            if flax_path not in tensors:
                raise KeyError(f"Flax path {flax_path} not found in the model")
            if torch_key not in state_dict:
                if strict:
                    raise KeyError(f"Torch key '{torch_key}' not found in state dict")
                continue
            tensor, value = tensors[flax_path], torch.as_tensor(state_dict[torch_key])
            if tuple(value.shape) != tuple(tensor.shape):
                raise ValueError(f"{torch_key}: shape {tuple(value.shape)} does not fit "
                                 f"{'/'.join(flax_path)} of shape {tuple(tensor.shape)}")
            tensor.copy_(value)
    return model


# ---------------------------------------------------------------------------
# Mapping builders for the reference's torch backbones (copied from the JAX
# package's ``zoo/porting.py``)
# ---------------------------------------------------------------------------


def conv_mapping(flax_prefix: Tuple[str, ...], torch_prefix: str, bias: bool = False) -> Dict:
    """{flax path: torch key} entries for one conv layer."""
    m = {("params",) + flax_prefix + ("kernel",): f"{torch_prefix}.weight"}
    if bias:
        m[("params",) + flax_prefix + ("bias",)] = f"{torch_prefix}.bias"
    return m


def bn_mapping(flax_prefix: Tuple[str, ...], torch_prefix: str) -> Dict:
    """{flax path: torch key} entries for one BatchNorm layer (affine and
    running statistics)."""
    return {
        ("params",) + flax_prefix + ("scale",): f"{torch_prefix}.weight",
        ("params",) + flax_prefix + ("bias",): f"{torch_prefix}.bias",
        ("batch_stats",) + flax_prefix + ("mean",): f"{torch_prefix}.running_mean",
        ("batch_stats",) + flax_prefix + ("var",): f"{torch_prefix}.running_var",
    }


def prefix_mapping(mapping: Mapping[Tuple[str, ...], str], flax_prefix: Tuple[str, ...]) -> Dict:
    """Re-root every flax path of ``mapping`` under ``flax_prefix``, after
    the collection (``('params', *prefix, ...)``), so that component mappings
    compose into an ``EncoderDecoderModel`` ('encoder', 'decoder', 'head')."""
    return {(path[0],) + tuple(flax_prefix) + tuple(path[1:]): key for path, key in mapping.items()}


def fpn_decoder_mapping(num_levels: int, torch_prefix: str = "") -> Dict[Tuple[str, ...], str]:
    """FPNDecoder <- the reference's FPNDecoder: the laterals are
    Conv_0..Conv_{n-1} fine -> coarse (torch ``lateral.{i}``), the prediction
    convs Conv_{n+j} (torch ``outputs.{j}``, j = 0 the coarsest
    non-context level)."""
    p = f"{torch_prefix}." if torch_prefix else ""
    m: Dict[Tuple[str, ...], str] = {}
    for i in range(num_levels):
        m.update(conv_mapping((f"Conv_{i}",), f"{p}lateral.{i}", bias=True))
    for j in range(num_levels - 1):
        m.update(conv_mapping((f"Conv_{num_levels + j}",), f"{p}outputs.{j}", bias=True))
    return m


def resize_head_mapping(torch_prefix: str = "") -> Dict[Tuple[str, ...], str]:
    """ResizeHead <- the reference's ResizeHead: one biased conv ('final')."""
    p = f"{torch_prefix}." if torch_prefix else ""
    return conv_mapping(("Conv_0",), f"{p}final", bias=True)


def mobilenet_v2_mapping() -> Dict[Tuple[str, ...], str]:
    """MobileNetV2Encoder <- the reference's torch MobileNetV2."""
    m = {}
    m.update(conv_mapping(("Conv_0",), "layer0.0"))
    m.update(bn_mapping(("BatchNorm_0",), "layer0.1"))
    block = 0
    for layer_index, (t, _, n, _) in enumerate(_V2_CONFIG):
        for i in range(n):
            fp, tp = f"InvertedResidual_{block}", f"layer{layer_index + 1}.{i}.conv"
            # t == 1: dw, bn, act, pw-linear, bn; else pw, bn, act, dw, bn, act, pw-linear, bn
            for k, index in enumerate((0, 3) if t == 1 else (0, 3, 6)):
                m.update(conv_mapping((fp, f"Conv_{k}"), f"{tp}.{index}"))
                m.update(bn_mapping((fp, f"BatchNorm_{k}"), f"{tp}.{index + 1}"))
            block += 1
    return m


def senet_mapping(stage_blocks: Tuple[int, ...], input_3x3: bool = False) -> Dict[Tuple[str, ...], str]:
    """SENetEncoder <- the reference's torch SENet: the stem, every
    bottleneck's convs, BNs and SE gate, and the first blocks' shortcut
    projections."""
    m = {}
    for i in (1, 2, 3) if input_3x3 else (1,):
        m.update(conv_mapping((f"layer0_conv{i}",), f"layer0.conv{i}"))
        m.update(bn_mapping((f"layer0_bn{i}",), f"layer0.bn{i}"))
    for stage, num_blocks in enumerate(stage_blocks, start=1):
        for i in range(num_blocks):
            fp, tp = f"layer{stage}_{i}", f"layer{stage}.{i}"
            for c in ("conv1", "conv2", "conv3"):
                m.update(conv_mapping((fp, c), f"{tp}.{c}"))
            for b in ("bn1", "bn2", "bn3"):
                m.update(bn_mapping((fp, b), f"{tp}.{b}"))
            m.update(conv_mapping((fp, "se", "se_fc1"), f"{tp}.se_module.fc1", bias=True))
            m.update(conv_mapping((fp, "se", "se_fc2"), f"{tp}.se_module.fc2", bias=True))
            if i == 0:  # every stage's first block projects the shortcut
                m.update(conv_mapping((fp, "downsample_conv"), f"{tp}.downsample.0"))
                m.update(bn_mapping((fp, "downsample_bn"), f"{tp}.downsample.1"))
    return m


def inception_v4_mapping(stage_repeats: Tuple[int, int, int] = (4, 7, 3)) -> Dict[Tuple[str, ...], str]:
    """InceptionV4Encoder <- the reference's torch InceptionV4 (Cadene's
    ``features.N`` layout; the indices shift with ``stage_repeats`` where the
    torch model is assembled with fewer blocks).  ConvBN k is the k-th the
    module creates; each is a torch BasicConv2d (``.conv``, ``.bn``)."""
    na, nb, nc = stage_repeats
    m = {}

    def cb(flax_idx: int, torch_path: str, outer: Tuple[str, ...] = ()):
        m.update(conv_mapping(outer + (f"ConvBN_{flax_idx}", "Conv_0"), f"{torch_path}.conv"))
        m.update(bn_mapping(outer + (f"ConvBN_{flax_idx}", "BatchNorm_0"), f"{torch_path}.bn"))

    stem = ["features.0", "features.1", "features.2", "features.3.conv", "features.4.branch0.0",
            "features.4.branch0.1", "features.4.branch1.0", "features.4.branch1.1", "features.4.branch1.2",
            "features.4.branch1.3", "features.5.conv"]
    for j, path in enumerate(stem):
        cb(j, path)
    a_branches = ["branch0", "branch1.0", "branch1.1", "branch2.0", "branch2.1", "branch2.2", "branch3.1"]
    for i in range(na):
        for j, b in enumerate(a_branches):
            cb(j, f"features.{6 + i}.{b}", (f"InceptionA_{i}",))
    for j, b in enumerate(["branch0", "branch1.0", "branch1.1", "branch1.2"]):
        cb(j, f"features.{6 + na}.{b}", ("ReductionA_0",))
    b_branches = ["branch0", "branch1.0", "branch1.1", "branch1.2", "branch2.0", "branch2.1", "branch2.2",
                  "branch2.3", "branch2.4", "branch3.1"]
    for i in range(nb):
        for j, b in enumerate(b_branches):
            cb(j, f"features.{7 + na + i}.{b}", (f"InceptionB_{i}",))
    for j, b in enumerate(["branch0.0", "branch0.1", "branch1.0", "branch1.1", "branch1.2", "branch1.3"]):
        cb(j, f"features.{7 + na + nb}.{b}", ("ReductionB_0",))
    c_branches = ["branch0", "branch1_0", "branch1_1a", "branch1_1b", "branch2_0", "branch2_1", "branch2_2",
                  "branch2_3a", "branch2_3b", "branch3.1"]
    for i in range(nc):
        for j, b in enumerate(c_branches):
            cb(j, f"features.{8 + na + nb + i}.{b}", (f"InceptionC_{i}",))
    return m


def wider_resnet_mapping(structure: Tuple[int, ...], a2: bool = False,
                         dilation: bool = False) -> Dict[Tuple[str, ...], str]:
    """WiderResNetEncoder <- the reference's torch WiderResNet / A2, whose
    ABN norm layers hold their BatchNorm under '<bn>.bn'."""
    m = conv_mapping(("mod1_conv1",), "mod1.conv1")
    in_channels = 64
    for mod_id, num_blocks in enumerate(structure):
        channels = _MODULE_CHANNELS[mod_id]
        for block_id in range(num_blocks):
            if a2 and not dilation:
                stride = 2 if block_id == 0 and 2 <= mod_id <= 4 else 1
            elif a2 and dilation:
                stride = 2 if block_id == 0 and mod_id == 2 else 1
            else:
                stride = 1
            fp, tp = f"mod{mod_id + 2}_block{block_id + 1}", f"mod{mod_id + 2}.block{block_id + 1}"
            m.update(bn_mapping((fp, "bn1"), f"{tp}.bn1.bn"))
            m.update(conv_mapping((fp, "conv1"), f"{tp}.convs.conv1"))
            m.update(bn_mapping((fp, "bn2"), f"{tp}.convs.bn2.bn"))
            m.update(conv_mapping((fp, "conv2"), f"{tp}.convs.conv2"))
            if len(channels) == 3:
                m.update(bn_mapping((fp, "bn3"), f"{tp}.convs.bn3.bn"))
                m.update(conv_mapping((fp, "conv3"), f"{tp}.convs.conv3"))
            if stride != 1 or in_channels != channels[-1]:
                m.update(conv_mapping((fp, "proj_conv"), f"{tp}.proj_conv"))
            in_channels = channels[-1]
    return m
