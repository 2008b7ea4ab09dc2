from .activations import *  # noqa: F401,F403
from .coord_conv import AddCoords, CoordConv, append_coords
from .drop_path import DropPath, drop_path
from .dropblock import DropBlock2D, DropBlock3D, DropBlockScheduled
from .dsconv import DepthwiseSeparableConv2d, DepthwiseSeparableConv2dBlock
from .fpn import FPNBottleneckBlock, FPNContextBlock, FPNFuse, FPNFuseSum, HFF
from .functional import resize_2d, resize_bilinear, resize_nearest
from .initialization import (
    bilinear_upsample_initializer,
    first_class_background_init_bias,
    icnr_init,
    zeros_kernel_init,
)
from .normalization import (
    BN_MOMENTUM,
    NORM_BATCH,
    NORM_GROUP,
    NORM_INSTANCE,
    BatchNorm1d,
    BatchNorm2d,
    Normalization,
    instantiate_normalization_block,
)
from .ocnet import (
    ASPObjectContextBlock,
    ObjectContextBlock,
    PyramidObjectContextBlock,
    PyramidSelfAttentionBlock2D,
    SelfAttentionBlock2D,
)
from .pooling import (
    GWAP,
    GeneralizedMeanPooling2d,
    GlobalAvgPool2d,
    GlobalKMaxPool2d,
    GlobalMaxAvgPooling2d,
    GlobalMaxPool2d,
    GlobalRankPooling,
    GlobalWeightedAvgPool2d,
    MILCustomPoolingModule,
    RMSPool,
)
from .scse import ChannelGate2d, ChannelSpatialGate2d, ChannelSpatialGate2dV2, SpatialGate2d, SpatialGate2dV2
from .simple import Conv2dSame, Identity, conv1x1, conv3x3
from .spp import ASPP, ASPPModule, ASPPPooling, SeparableASPPModule
from .srm import SRMLayer
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
