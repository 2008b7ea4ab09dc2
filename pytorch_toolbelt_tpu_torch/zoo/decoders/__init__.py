from .unet import UNetDecoder

__all__ = ["UNetDecoder"]
