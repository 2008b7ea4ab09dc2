from .functional import (
    build_optimizer_param_groups,
    count_optimizable_parameters,
    freeze_parameters,
    make_optimizer,
    scale_learning_rate_for_ddp,
)
from .lr_schedules import (
    cosine_annealing_warm_restarts_with_decay_schedule,
    cosine_annealing_with_decay_schedule,
    flat_cosine_annealing_schedule,
    gradual_warmup_schedule,
    once_cycle_schedule,
    poly_schedule,
)

__all__ = [
    "build_optimizer_param_groups",
    "cosine_annealing_warm_restarts_with_decay_schedule",
    "cosine_annealing_with_decay_schedule",
    "count_optimizable_parameters",
    "flat_cosine_annealing_schedule",
    "freeze_parameters",
    "gradual_warmup_schedule",
    "make_optimizer",
    "once_cycle_schedule",
    "poly_schedule",
    "scale_learning_rate_for_ddp",
]
