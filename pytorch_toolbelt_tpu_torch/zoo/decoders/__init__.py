from .bifpn import BiFPNBlock, BiFPNConvBlock, BiFPNDecoder
from .can import CANDecoder
from .deeplab import DeeplabV3Decoder, DeeplabV3PlusDecoder
from .fpn import FPNDecoder
from .ppm import PPMDecoder
from .unet import UNetDecoder

__all__ = [
    "BiFPNBlock",
    "BiFPNConvBlock",
    "BiFPNDecoder",
    "CANDecoder",
    "DeeplabV3Decoder",
    "DeeplabV3PlusDecoder",
    "FPNDecoder",
    "PPMDecoder",
    "UNetDecoder",
]
