from .fpn import FPNDecoder
from .unet import UNetDecoder

__all__ = ["FPNDecoder", "UNetDecoder"]
