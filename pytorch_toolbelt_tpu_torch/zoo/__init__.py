from .decoders import (
    BiFPNBlock,
    BiFPNConvBlock,
    BiFPNDecoder,
    CANDecoder,
    DeeplabV3Decoder,
    DeeplabV3PlusDecoder,
    FPNDecoder,
    PPMDecoder,
    UNetDecoder,
)
from .encoders import *  # noqa: F401,F403
from .encoders import __all__ as _encoders_all
from .fast_unet import fuse_unet_inference
from .heads import (
    DeepSupervisionHead,
    FullyConnectedClassificationHead,
    GeneralizedMeanPoolingClassificationHead,
    GenericPoolingClassificationHead,
    GlobalAveragePoolingClassificationHead,
    GlobalMaxAvgPoolingClassificationHead,
    GlobalMaxAvgSumPoolingClassificationHead,
    GlobalMaxPoolingClassificationHead,
    HypercolumnHead,
    ProgressiveShuffleHead,
    ResizeHead,
    SegFormerHead,
)
from .models import EncoderDecoderModel, UNetSegmentationModel
from .porting import flax_name_map, load_flax_variables, port_torch_state_dict
from .quantized_encdec import attribute_quantization_error, quantize_encoder_decoder_inference
from .quantized_unet import quantize_unet_inference

__all__ = [
    "BiFPNBlock",
    "BiFPNConvBlock",
    "BiFPNDecoder",
    "CANDecoder",
    "DeepSupervisionHead",
    "DeeplabV3Decoder",
    "DeeplabV3PlusDecoder",
    "EncoderDecoderModel",
    "FPNDecoder",
    "FullyConnectedClassificationHead",
    "GeneralizedMeanPoolingClassificationHead",
    "GenericPoolingClassificationHead",
    "GlobalAveragePoolingClassificationHead",
    "GlobalMaxAvgPoolingClassificationHead",
    "GlobalMaxAvgSumPoolingClassificationHead",
    "GlobalMaxPoolingClassificationHead",
    "HypercolumnHead",
    "PPMDecoder",
    "ProgressiveShuffleHead",
    "ResizeHead",
    "SegFormerHead",
    "UNetDecoder",
    "UNetSegmentationModel",
    "attribute_quantization_error",
    "fuse_unet_inference",
    "flax_name_map",
    "load_flax_variables",
    "port_torch_state_dict",
    "quantize_encoder_decoder_inference",
    "quantize_unet_inference",
    *_encoders_all,
]
