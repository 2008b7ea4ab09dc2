from .decoders import UNetDecoder
from .encoders import EncoderBase, UnetEncoder
from .fast_unet import fuse_unet_inference
from .heads import ResizeHead
from .models import EncoderDecoderModel, UNetSegmentationModel
from .porting import load_flax_variables

__all__ = [
    "EncoderBase",
    "EncoderDecoderModel",
    "ResizeHead",
    "UNetDecoder",
    "UNetSegmentationModel",
    "UnetEncoder",
    "fuse_unet_inference",
    "load_flax_variables",
]
