from .common import EncoderBase
from .senet import (
    SENetBottleneck,
    SENetEncoder,
    max_pool_ceil,
    se_resnet50_encoder,
    se_resnet101_encoder,
    se_resnet152_encoder,
    se_resnext50_encoder,
    se_resnext101_encoder,
    senet154_encoder,
)
from .unet import UnetEncoder

__all__ = [
    "EncoderBase",
    "SENetBottleneck",
    "SENetEncoder",
    "UnetEncoder",
    "max_pool_ceil",
    "se_resnet50_encoder",
    "se_resnet101_encoder",
    "se_resnet152_encoder",
    "se_resnext50_encoder",
    "se_resnext101_encoder",
    "senet154_encoder",
]
