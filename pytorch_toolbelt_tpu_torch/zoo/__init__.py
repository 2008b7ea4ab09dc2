from .decoders import FPNDecoder, UNetDecoder
from .encoders import *  # noqa: F401,F403
from .encoders import __all__ as _encoders_all
from .fast_unet import fuse_unet_inference
from .heads import ResizeHead
from .models import EncoderDecoderModel, UNetSegmentationModel
from .porting import load_flax_variables

__all__ = [
    "EncoderDecoderModel",
    "FPNDecoder",
    "ResizeHead",
    "UNetDecoder",
    "UNetSegmentationModel",
    "fuse_unet_inference",
    "load_flax_variables",
    *_encoders_all,
]
