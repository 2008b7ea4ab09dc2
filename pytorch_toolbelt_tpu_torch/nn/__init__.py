from .activations import *  # noqa: F401,F403
from .drop_path import DropPath, drop_path
from .functional import resize_2d, resize_bilinear, resize_nearest
from .initialization import bilinear_upsample_initializer, icnr_init
from .normalization import (
    NORM_BATCH,
    NORM_GROUP,
    NORM_INSTANCE,
    BatchNorm2d,
    Normalization,
    instantiate_normalization_block,
)
from .scse import ChannelGate2d, ChannelSpatialGate2d, ChannelSpatialGate2dV2, SpatialGate2d, SpatialGate2dV2
from .simple import Conv2dSame, Identity, conv1x1, conv3x3
from .unet import UnetBlock, UnetResidualBlock
from .upsample import (
    AbstractResizeLayer,
    BilinearAdditiveUpsample2d,
    BilinearInterpolationLayer,
    DeconvolutionUpsample2d,
    NearestNeighborResizeLayer,
    PixelShuffle,
    PixelShuffleWithLinear,
    ResidualDeconvolutionUpsample2d,
    UpsampleLayerType,
    instantiate_upsample_block,
    upsample_out_channels,
)
