from .functional import *  # noqa: F401,F403
from .tiles import (
    ImageSlicer,
    TileMerger,
    clear_tiled_cache,
    compute_pyramid_patch_weight_loss,
    tiled_apply,
    tiled_apply_d4_tta,
)
from .tta import (
    d4_image2mask,
    d4_image_augment,
    d4_image_augment_views,
    d4_image_deaugment,
    d4_image_deaugment_views,
)
