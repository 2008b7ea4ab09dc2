from .activations import *  # noqa: F401,F403
from .functional import resize_2d, resize_bilinear, resize_nearest
from .normalization import NORM_BATCH, NORM_GROUP, NORM_INSTANCE, Normalization, instantiate_normalization_block
from .unet import UnetBlock
from .upsample import BilinearInterpolationLayer, UpsampleLayerType, instantiate_upsample_block
