from .functional import *  # noqa: F401,F403
from .tiles import (
    ImageSlicer,
    TileMerger,
    accumulate_tiles,
    clear_tiled_cache,
    compute_pyramid_patch_weight_loss,
    tiled_apply,
    tiled_apply_d4_tta,
)
from .tta import (
    MultiscaleTTA,
    d4_image2mask,
    d4_image_augment,
    d4_image_augment_views,
    d4_image_deaugment,
    d4_image_deaugment_views,
    ms_image_augment,
    ms_image_deaugment,
    ms_labels_augment,
    ms_labels_deaugment,
)
