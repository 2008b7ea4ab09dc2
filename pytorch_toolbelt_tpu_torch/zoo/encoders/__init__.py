from .common import EncoderBase
from .unet import UnetEncoder

__all__ = ["EncoderBase", "UnetEncoder"]
