from .decoders import FPNDecoder, UNetDecoder
from .encoders import (
    EncoderBase,
    SENetEncoder,
    UnetEncoder,
    se_resnet50_encoder,
    se_resnet101_encoder,
    se_resnet152_encoder,
    se_resnext50_encoder,
    se_resnext101_encoder,
    senet154_encoder,
)
from .fast_unet import fuse_unet_inference
from .heads import ResizeHead
from .models import EncoderDecoderModel, UNetSegmentationModel
from .porting import load_flax_variables

__all__ = [
    "EncoderBase",
    "EncoderDecoderModel",
    "FPNDecoder",
    "ResizeHead",
    "SENetEncoder",
    "UNetDecoder",
    "UNetSegmentationModel",
    "UnetEncoder",
    "fuse_unet_inference",
    "load_flax_variables",
    "se_resnet50_encoder",
    "se_resnet101_encoder",
    "se_resnet152_encoder",
    "se_resnext50_encoder",
    "se_resnext101_encoder",
    "senet154_encoder",
]
