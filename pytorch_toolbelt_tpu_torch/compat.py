"""Reference-spelled compatibility surface (counterpart of
``pytorch_toolbelt_tpu/compat.py``).

Every public name of BloodAxe/pytorch-toolbelt v0.8.0 that this framework
spells differently resolves here under its original spelling, so a
migrating user can ``from pytorch_toolbelt_tpu_torch.compat import <old name>``
and find the port's equivalent.  ``tests/test_torch_compat.py`` holds that the
port's public names and this module cover the JAX package's public names and
its ``compat``, apart from the names left out on purpose.

Three kinds of entries:

* pure aliases (``_ALIASES``): the same concept under the port's name (the
  reference's NCHW ``torch_rot90_ccw`` is ``image_rot90_ccw``, which acts on
  NCHW dims (2, 3) here; encoder *classes* are the factory functions, which
  take the same instantiate-with-kwargs call shape);
* thin adapters (defined below), torch-native: ``get_non_wrapped_model``
  unwraps DP/DDP, ``maybe_cuda`` moves to CUDA when there is a card,
  ``freeze_model`` clears ``requires_grad`` and freezes BatchNorm;
* activation-class factories: the reference instantiates ``Mish()`` then
  calls it; the factory returns the port's activation function, so that
  call shape still works.

Aliases resolve lazily through the module's ``__getattr__``, so importing
``compat`` stays cheap and avoids import cycles.
"""

from importlib import import_module
from typing import Iterator

import torch
from torch import nn

__all__: list  # populated at the end of the module

_F = "pytorch_toolbelt_tpu_torch.inference.functional"
_Z = "pytorch_toolbelt_tpu_torch.zoo"
_NN = "pytorch_toolbelt_tpu_torch.nn"
_LF = "pytorch_toolbelt_tpu_torch.losses.functional"
_U = "pytorch_toolbelt_tpu_torch.utils"
_UT = "pytorch_toolbelt_tpu_torch.utils.tensor"
_O = "pytorch_toolbelt_tpu_torch.optimization"
_D = "pytorch_toolbelt_tpu_torch.distributed"
_CI = "pytorch_toolbelt_tpu_torch.core.interfaces"

_ALIASES = {
    # ---- inference/functional.py torch_* TTA primitives (NCHW dims (2,3)
    # in the reference; the image_* twins act on NCHW dims (2, 3) too) ----
    "torch_none": (_F, "image_none"),
    "torch_fliplr": (_F, "image_fliplr"),
    "torch_flipud": (_F, "image_flipud"),
    "torch_rot90_ccw": (_F, "image_rot90_ccw"),
    "torch_rot90_cw": (_F, "image_rot90_cw"),
    "torch_rot90": (_F, "image_rot90_ccw"),  # deprecated ref spelling (functional.py:71-78)
    "torch_rot270": (_F, "image_rot90_cw"),  # deprecated ref spelling (functional.py:98-105)
    "torch_rot180": (_F, "image_rot180"),
    "torch_rot180_transpose": (_F, "image_rot180_transpose"),
    "torch_transpose_rot180": (_F, "image_transpose_rot180"),
    "torch_rot90_ccw_transpose": (_F, "image_rot90_ccw_transpose"),
    "torch_rot90_cw_transpose": (_F, "image_rot90_cw_transpose"),
    "torch_transpose_rot90_ccw": (_F, "image_transpose_rot90_ccw"),
    "torch_transpose_rot90_cw": (_F, "image_transpose_rot90_cw"),
    "torch_transpose": (_F, "image_transpose"),
    "torch_transpose_": (_F, "image_transpose"),  # returns a new tensor, not in place
    "torch_transpose2": (_F, "image_rot180_transpose"),  # second-diagonal transpose
    # ---- losses ----
    "sigmoid_focal_loss": (_LF, "focal_loss_with_logits"),  # deprecated ref alias (functional.py:176-178)
    # ---- interfaces ----
    "AbstractEncoder": (_Z, "EncoderBase"),
    "AbstractDecoder": (_CI, "AbstractDecoder"),
    "AbstractHead": (_CI, "AbstractHead"),
    "HasOutputFeaturesSpecification": (_CI, "HasOutputFeaturesSpecification"),
    "EncoderModule": (_Z, "EncoderBase"),
    "GenericTimmEncoder": (_Z, "GenericEncoder"),
    # ---- initialization / upsample ----
    "first_class_background_init": (_NN, "first_class_background_init_bias"),
    "bilinear_upsample_initializer": (_NN, "bilinear_upsample_initializer"),
    # ---- activations: naive fn spellings ----
    "mish_naive": (_NN, "mish_naive"),
    "swish_naive": (_NN, "swish_naive"),
    # ---- optimization: torch LR-scheduler classes -> the port's schedule factories ----
    "CosineAnnealingLRWithDecay": (_O, "cosine_annealing_with_decay_schedule"),
    "CosineAnnealingWarmRestartsWithDecay": (_O, "cosine_annealing_warm_restarts_with_decay_schedule"),
    "FlatCosineAnnealingLR": (_O, "flat_cosine_annealing_schedule"),
    "GradualWarmupScheduler": (_O, "gradual_warmup_schedule"),
    "OnceCycleLR": (_O, "once_cycle_schedule"),
    "PolyLR": (_O, "poly_schedule"),
    # ---- utils ----
    "pytorch_toolbelt_deprecated": (_U, "toolbelt_deprecated"),
    "distributed_guard": (_D, "DistributedGuard"),
    "resize_as": (_UT, "resize_like"),
    "tensor_from_mask_image": (_UT, "image_to_tensor"),
    "move_to_device_non_blocking": (_UT, "move_to_device"),
    # ---- vendored torch backbones -> encoder equivalents ----
    "InceptionV4": (_Z, "InceptionV4Encoder"),
    "inceptionv4": (_Z, "inception_v4_encoder"),
    "MobileNetV2": (_Z, "MobileNetV2Encoder"),
    "InvertedResidual": ("pytorch_toolbelt_tpu_torch.zoo.encoders.mobilenet", "InvertedResidual"),
    "SENet": (_Z, "SENetEncoder"),
    "se_resnet50": (_Z, "se_resnet50_encoder"),
    "se_resnet101": (_Z, "se_resnet101_encoder"),
    "se_resnet152": (_Z, "se_resnet152_encoder"),
    "se_resnext50_32x4d": (_Z, "se_resnext50_encoder"),
    "se_resnext101_32x4d": (_Z, "se_resnext101_encoder"),
    "senet154": (_Z, "senet154_encoder"),
    "WiderResNet": (_Z, "WiderResNetEncoder"),
    "WiderResNetA2": (_Z, "WiderResNetA2Encoder"),
    "IdentityResidualBlock": ("pytorch_toolbelt_tpu_torch.zoo.encoders.wide_resnet", "IdentityResidualBlock"),
    "wider_resnet_16": (_Z, "wider_resnet16_encoder"),
    "wider_resnet_20": (_Z, "wider_resnet20_encoder"),
    "wider_resnet_38": (_Z, "wider_resnet38_encoder"),
    "wider_resnet_16_a2": (_Z, "wider_resnet16_a2_encoder"),
    "wider_resnet_20_a2": (_Z, "wider_resnet20_a2_encoder"),
    "wider_resnet_38_a2": (_Z, "wider_resnet38_a2_encoder"),
    # ---- encoder classes -> factory functions (same kwargs call shape) ----
    "ResnetEncoder": (_Z, "ResNetEncoder"),
    "Resnet18Encoder": (_Z, "resnet18_encoder"),
    "Resnet34Encoder": (_Z, "resnet34_encoder"),
    "Resnet50Encoder": (_Z, "resnet50_encoder"),
    "Resnet101Encoder": (_Z, "resnet101_encoder"),
    "Resnet152Encoder": (_Z, "resnet152_encoder"),
    "SEResnetEncoder": (_Z, "SENetEncoder"),
    "SEResnet50Encoder": (_Z, "se_resnet50_encoder"),
    "SEResnet101Encoder": (_Z, "se_resnet101_encoder"),
    "SEResnet152Encoder": (_Z, "se_resnet152_encoder"),
    "SEResNeXt50Encoder": (_Z, "se_resnext50_encoder"),
    "SEResNeXt101Encoder": (_Z, "se_resnext101_encoder"),
    "SENet154Encoder": (_Z, "senet154_encoder"),
    "DenseNet121Encoder": (_Z, "densenet121_encoder"),
    "DenseNet161Encoder": (_Z, "densenet161_encoder"),
    "DenseNet169Encoder": (_Z, "densenet169_encoder"),
    "DenseNet201Encoder": (_Z, "densenet201_encoder"),
    "SqueezenetEncoder": (_Z, "squeezenet_encoder"),
    "MobilenetV2Encoder": (_Z, "MobileNetV2Encoder"),
    "MobileNetV3Large": (_Z, "mobilenet_v3_large_encoder"),
    "MobileNetV3Small": (_Z, "mobilenet_v3_small_encoder"),
    "HRNetV2Encoder18": (_Z, "hrnet18_encoder"),
    "HRNetV2Encoder34": (_Z, "hrnet34_encoder"),
    "HRNetV2Encoder48": (_Z, "hrnet48_encoder"),
    "HRNetW18Encoder": (_Z, "hrnet18_encoder"),
    "HRNetW32Encoder": (_Z, "hrnet32_encoder"),
    "HRNetW48Encoder": (_Z, "hrnet48_encoder"),
    "TimmHRNetW18SmallV2Encoder": (_Z, "hrnet_w18_small_v2_encoder"),
    "WiderResnetEncoder": (_Z, "WiderResNetEncoder"),
    "WiderResnetA2Encoder": (_Z, "WiderResNetA2Encoder"),
    "WiderResnet16Encoder": (_Z, "wider_resnet16_encoder"),
    "WiderResnet20Encoder": (_Z, "wider_resnet20_encoder"),
    "WiderResnet38Encoder": (_Z, "wider_resnet38_encoder"),
    "WiderResnet16A2Encoder": (_Z, "wider_resnet16_a2_encoder"),
    "WiderResnet20A2Encoder": (_Z, "wider_resnet20_a2_encoder"),
    "WiderResnet38A2Encoder": (_Z, "wider_resnet38_a2_encoder"),
    "XResNet18Encoder": (_Z, "xresnet18_encoder"),
    "XResNet34Encoder": (_Z, "xresnet34_encoder"),
    "XResNet50Encoder": (_Z, "xresnet50_encoder"),
    "XResNet101Encoder": (_Z, "xresnet101_encoder"),
    "XResNet152Encoder": (_Z, "xresnet152_encoder"),
    "SEXResNet18Encoder": (_Z, "se_xresnet18_encoder"),
    "SEXResNet34Encoder": (_Z, "se_xresnet34_encoder"),
    "SEXResNet50Encoder": (_Z, "se_xresnet50_encoder"),
    "SEXResNet101Encoder": (_Z, "se_xresnet101_encoder"),
    "SEXResNet152Encoder": (_Z, "se_xresnet152_encoder"),
    "SwinT": (_Z, "swin_tiny_encoder"),
    "SwinS": (_Z, "swin_small_encoder"),
    "SwinB": (_Z, "swin_base_encoder"),
    "SwinL": (_Z, "swin_large_encoder"),
    "SwinTransformer": (_Z, "SwinTransformerEncoder"),
    "MixVisionTransformer": (_Z, "MixVisionTransformerEncoder"),
    "MitB0Encoder": (_Z, "mit_b0_encoder"),
    "MitB1Encoder": (_Z, "mit_b1_encoder"),
    "MitB2Encoder": (_Z, "mit_b2_encoder"),
    "MitB3Encoder": (_Z, "mit_b3_encoder"),
    "MitB4Encoder": (_Z, "mit_b4_encoder"),
    "MitB5Encoder": (_Z, "mit_b5_encoder"),
    # MiT building blocks (reference mix_transformer.py internals)
    "OverlapPatchEmbed": ("pytorch_toolbelt_tpu_torch.zoo.encoders.mix_transformer", "OverlapPatchEmbed"),
    "Attention": ("pytorch_toolbelt_tpu_torch.zoo.encoders.mix_transformer", "EfficientSelfAttention"),
    "Block": ("pytorch_toolbelt_tpu_torch.zoo.encoders.mix_transformer", "MiTBlock"),
    "Mlp": ("pytorch_toolbelt_tpu_torch.zoo.encoders.mix_transformer", "MixFFN"),
    # ---- timm preset classes -> factories ----
    "DPN68Encoder": (_Z, "dpn68_encoder"),
    "DPN68BEncoder": (_Z, "dpn68b_encoder"),
    "DPN92Encoder": (_Z, "dpn92_encoder"),
    "DPN107Encoder": (_Z, "dpn107_encoder"),
    "DPN131Encoder": (_Z, "dpn131_encoder"),
    "B0Encoder": (_Z, "efficientnet_b0_encoder"),
    "B1Encoder": (_Z, "efficientnet_b1_encoder"),
    "B2Encoder": (_Z, "efficientnet_b2_encoder"),
    "B3Encoder": (_Z, "efficientnet_b3_encoder"),
    "B4Encoder": (_Z, "efficientnet_b4_encoder"),
    "B5Encoder": (_Z, "efficientnet_b5_encoder"),
    "B6Encoder": (_Z, "efficientnet_b6_encoder"),
    "B7Encoder": (_Z, "efficientnet_b7_encoder"),
    "TimmB0Encoder": (_Z, "efficientnet_b0_encoder"),
    "TimmB1Encoder": (_Z, "efficientnet_b1_encoder"),
    "TimmB2Encoder": (_Z, "efficientnet_b2_encoder"),
    "TimmB3Encoder": (_Z, "efficientnet_b3_encoder"),
    "TimmB4Encoder": (_Z, "efficientnet_b4_encoder"),
    "TimmB5Encoder": (_Z, "efficientnet_b5_encoder"),
    "TimmB6Encoder": (_Z, "efficientnet_b6_encoder"),
    "TimmB7Encoder": (_Z, "efficientnet_b7_encoder"),
    "MixNetXLEncoder": (_Z, "mixnet_xl_encoder"),
    "TimmMixNetXLEncoder": (_Z, "mixnet_xl_encoder"),
    "TimmEfficientNetV2": (_Z, "EfficientNetV2Encoder"),
    "MaxVitEncoder": (_Z, "MaxViTEncoder"),
    "NFNetF0Encoder": (_Z, "nfnet_f0_encoder"),
    "NFNetF1Encoder": (_Z, "nfnet_f1_encoder"),
    "NFNetF2Encoder": (_Z, "nfnet_f2_encoder"),
    "NFNetF3Encoder": (_Z, "nfnet_f3_encoder"),
    "NFNetF4Encoder": (_Z, "nfnet_f4_encoder"),
    "NFNetF5Encoder": (_Z, "nfnet_f5_encoder"),
    "NFNetF6Encoder": (_Z, "nfnet_f6_encoder"),
    "NFNetF7Encoder": (_Z, "nfnet_f7_encoder"),
    "NFRegNetB0Encoder": (_Z, "nf_regnet_b0_encoder"),
    "NFRegNetB1Encoder": (_Z, "nf_regnet_b1_encoder"),
    "NFRegNetB2Encoder": (_Z, "nf_regnet_b2_encoder"),
    "NFRegNetB3Encoder": (_Z, "nf_regnet_b3_encoder"),
    "NFRegNetB4Encoder": (_Z, "nf_regnet_b4_encoder"),
    "NFRegNetB5Encoder": (_Z, "nf_regnet_b5_encoder"),
    "TimmRes2Net101Encoder": (_Z, "res2net101_encoder"),
    "TimmRes2Next50Encoder": (_Z, "res2next50_encoder"),
    "SKResNet18Encoder": (_Z, "skresnet18_encoder"),
    "SKResNeXt50Encoder": (_Z, "skresnext50_encoder"),
    "SWSLResNeXt101Encoder": (_Z, "swsl_resnext101_encoder"),
    "TResNetMEncoder": (_Z, "tresnet_m_encoder"),
    "TimmResnet26D": (_Z, "resnet26d_encoder"),
    "TimmResnet50D": (_Z, "resnet50d_encoder"),
    "TimmResnet101D": (_Z, "resnet101d_encoder"),
    "TimmResnet152D": (_Z, "resnet152d_encoder"),
    "TimmResnet200D": (_Z, "resnet200d_encoder"),
    "TimmSEResnet152D": (_Z, "seresnet152d_encoder"),
}


# ---------------------------------------------------------------------------
# Thin adapters, torch-native
# ---------------------------------------------------------------------------


def get_non_wrapped_model(model: nn.Module) -> nn.Module:
    """The model inside a ``DataParallel`` or ``DistributedDataParallel``
    wrapper (reference torch_utils.py:468-480); any other model as it is."""
    if isinstance(model, (nn.DataParallel, nn.parallel.DistributedDataParallel)):
        return model.module
    return model


def maybe_cuda(x):
    """``x.cuda()`` when a CUDA card is available, else ``x`` as it is
    (reference torch_utils.py:276-284)."""
    return x.cuda() if torch.cuda.is_available() else x


def get_optimizable_parameters(model: nn.Module) -> Iterator[nn.Parameter]:
    """The parameters with ``requires_grad`` (reference
    optimization/functional.py:204-211)."""
    return filter(lambda p: p.requires_grad, model.parameters())


def freeze_model(module: nn.Module, freeze_parameters: bool = True, freeze_bn: bool = True) -> nn.Module:
    """Clear ``requires_grad`` of every parameter and put every batch norm in
    eval mode (its running statistics then stay as they are), in place;
    return the module (reference optimization/functional.py ``freeze_model``)."""
    if freeze_parameters:
        for p in module.parameters():
            p.requires_grad_(False)
    if freeze_bn:
        for m in module.modules():
            if isinstance(m, nn.modules.batchnorm._BatchNorm):
                m.eval()
    return module


def container_to_tensor(value):
    """numpy arrays inside lists / tuples / mappings -> tensors
    (reference torch_utils.py:188-205)."""
    from .utils.tensor import container_to_tensor as _impl

    return _impl(value)


def conv_bn(inp: int, oup: int, stride: int) -> nn.Sequential:
    """Reference backbone/mobilenet.py ``conv_bn``: a 3x3 conv (flax ``SAME``,
    no bias), the port's BatchNorm and ReLU6."""
    from .nn.normalization import BN_MOMENTUM, BatchNorm2d
    from .nn.simple import Conv2dSame

    return nn.Sequential(Conv2dSame(inp, oup, 3, stride=stride, bias=False), BatchNorm2d(oup, momentum=BN_MOMENTUM),
                         nn.ReLU6())


def conv_1x1_bn(inp: int, oup: int) -> nn.Sequential:
    """Reference backbone/mobilenet.py ``conv_1x1_bn``: a 1x1 conv (no bias),
    the port's BatchNorm and ReLU6."""
    from .nn.normalization import BN_MOMENTUM, BatchNorm2d

    return nn.Sequential(nn.Conv2d(inp, oup, 1, bias=False), BatchNorm2d(oup, momentum=BN_MOMENTUM), nn.ReLU6())


def make_n_channel_input(conv, in_channels: int, mode: str = "auto"):
    """Reference encoders/common.py:87-126: a conv that takes ``in_channels``
    inputs, its weight tiled (then cut) along the input channels by
    ``zoo.encoders.common.make_n_channel_input_kernel``.  Given a conv module
    (``nn.Conv2d``, NFNet's ``WSConv``), returns a new one; given an OIHW
    weight, returns the new weight.  ``mode`` is accepted and ignored."""
    import copy

    from .zoo.encoders.common import make_n_channel_input_kernel

    if isinstance(conv, torch.Tensor):
        return make_n_channel_input_kernel(conv, in_channels)
    new = copy.deepcopy(conv)
    with torch.no_grad():
        new.weight = nn.Parameter(make_n_channel_input_kernel(conv.weight, in_channels).clone())
    new.in_channels = in_channels
    if hasattr(new, "fan_in"):  # WSConv standardizes over kh * kw * in / groups
        new.fan_in = new.weight.shape[1] * new.weight.shape[2] * new.weight.shape[3]
    return new


def make_n_channel_input_std_conv(conv, in_channels: int, mode: str = "auto"):
    """Reference encoders/timm/common.py: :func:`make_n_channel_input` for a
    weight-standardized conv; the weight surgery is the same."""
    return make_n_channel_input(conv, in_channels, mode)


# The reference instantiates activation modules (``Mish()(x)``); the factory
# returns the port's activation function, so that call shape keeps working.
def Mish():
    from .nn import mish

    return mish


def MishNaive():
    from .nn import mish

    return mish


def Swish():
    from .nn import swish

    return swish


def SwishNaive():
    from .nn import swish

    return swish


def HardSigmoid():
    from .nn.activations import hard_sigmoid

    return hard_sigmoid


def HardSwish():
    from .nn.activations import hard_swish

    return hard_swish


def DWConv(dim: int = 768) -> nn.Conv2d:
    """Reference mix_transformer.py ``DWConv``: a 3x3 depthwise conv with
    bias, padded by 1."""
    return nn.Conv2d(dim, dim, 3, padding=1, groups=dim)


def _dim_helper(fn_name: str, dim: int):
    def helper(x: torch.Tensor) -> torch.Tensor:
        from .utils.tensor import argmax_over, softmax_over

        impl = argmax_over if fn_name == "argmax" else softmax_over
        return impl(x, dim=dim)

    helper.__name__ = f"{fn_name}_over_dim_{dim}"
    helper.__doc__ = f"Reference torch_utils.py {fn_name}_over_dim_{dim}: {fn_name} over dim {dim} (NCHW)."
    return helper


argmax_over_dim_0 = _dim_helper("argmax", 0)
argmax_over_dim_1 = _dim_helper("argmax", 1)
argmax_over_dim_2 = _dim_helper("argmax", 2)
argmax_over_dim_3 = _dim_helper("argmax", 3)
softmax_over_dim_0 = _dim_helper("softmax", 0)
softmax_over_dim_1 = _dim_helper("softmax", 1)
softmax_over_dim_2 = _dim_helper("softmax", 2)
softmax_over_dim_3 = _dim_helper("softmax", 3)


_ADAPTERS = [
    "argmax_over_dim_0",
    "argmax_over_dim_1",
    "argmax_over_dim_2",
    "argmax_over_dim_3",
    "softmax_over_dim_0",
    "softmax_over_dim_1",
    "softmax_over_dim_2",
    "softmax_over_dim_3",
    "DWConv",
    "get_non_wrapped_model",
    "maybe_cuda",
    "get_optimizable_parameters",
    "freeze_model",
    "container_to_tensor",
    "conv_bn",
    "conv_1x1_bn",
    "make_n_channel_input",
    "make_n_channel_input_std_conv",
    "Mish",
    "MishNaive",
    "Swish",
    "SwishNaive",
    "HardSigmoid",
    "HardSwish",
]

__all__ = sorted(set(_ALIASES) | set(_ADAPTERS))


def __getattr__(name: str):
    try:
        module_name, attr = _ALIASES[name]
    except KeyError:
        raise AttributeError(f"module 'pytorch_toolbelt_tpu_torch.compat' has no attribute {name!r}")
    return getattr(import_module(module_name), attr)


def __dir__():
    return __all__
