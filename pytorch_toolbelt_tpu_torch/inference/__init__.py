from .ensembling import (
    ApplySigmoidTo,
    ApplySoftmaxTo,
    Ensembler,
    PickModelOutput,
    SelectByIndex,
    average_checkpoints,
)
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
from .tiles_3d import VolumeMerger, VolumeSlicer, compute_pyramid_patch_weight_loss_3d, tiled_apply_3d
from .tta import *  # noqa: F401,F403
