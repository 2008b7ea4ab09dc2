"""Learning-rate schedules as plain ``step -> lr`` callables (counterpart of
``pytorch_toolbelt_tpu/optimization/lr_schedules.py``).

A schedule drives a torch optimizer through
``torch.optim.lr_scheduler.LambdaLR(optimizer, lambda step: schedule(step) / base_lr)``.
"""

import math
from typing import Callable, Optional

import numpy as np

__all__ = [
    "once_cycle_schedule",
    "cosine_annealing_with_decay_schedule",
    "cosine_annealing_warm_restarts_with_decay_schedule",
    "poly_schedule",
    "flat_cosine_annealing_schedule",
    "gradual_warmup_schedule",
]

Schedule = Callable[[int], float]


def once_cycle_schedule(base_lr: float, epochs: int, min_lr_factor: float = 0.05, max_lr: float = 1.0) -> Schedule:
    """Linear grow -> linear decay -> short final decay
    (reference OnceCycleLR, lr_schedules.py:32-45)."""
    half_epochs = epochs // 2
    decay_epochs = int(epochs * 0.05)
    lr_grow = np.linspace(min_lr_factor, max_lr, num=half_epochs)
    lr_down = np.linspace(max_lr, min_lr_factor, num=int(epochs - half_epochs - decay_epochs))
    lr_decay = np.linspace(min_lr_factor, min_lr_factor * 0.01, int(decay_epochs))
    factors = np.concatenate((lr_grow, lr_down, lr_decay)) / max_lr

    def schedule(step: int) -> float:
        idx = min(int(step), len(factors) - 1)
        return base_lr * float(factors[idx])

    return schedule


def cosine_annealing_with_decay_schedule(
    base_lr: float, t_max: float, gamma: float, eta_min: float = 0.0
) -> Schedule:
    """Cosine annealing with multiplicative decay of the peak
    (reference CosineAnnealingLRWithDecay, lr_schedules.py:47-89)."""

    def schedule(step: int) -> float:
        return (
            eta_min
            + (base_lr * gamma**step - eta_min) * (1 + math.cos(math.pi * step / t_max)) / 2
        )

    return schedule


def poly_schedule(base_lr: float, max_epoch: int, gamma: float = 0.9) -> Schedule:
    """(1 - t/T)^gamma decay (reference PolyLR, lr_schedules.py:91-96)."""

    def schedule(step: int) -> float:
        return base_lr * (1.0 - float(step) / max_epoch) ** gamma

    return schedule


def cosine_annealing_warm_restarts_with_decay_schedule(
    base_lr: float, t_0: int, t_mult: int = 1, eta_min: float = 0.0, gamma: float = 0.9
) -> Schedule:
    """SGDR warm restarts with per-step multiplicative peak decay
    (reference CosineAnnealingWarmRestartsWithDecay, lr_schedules.py:99-117)."""

    def schedule(step: int) -> float:
        # locate restart cycle
        if t_mult == 1:
            t_cur = step % t_0
            t_i = t_0
        else:
            n = int(math.log(step / t_0 * (t_mult - 1) + 1, t_mult)) if step > 0 else 0
            t_start = t_0 * (t_mult**n - 1) // (t_mult - 1)
            t_i = t_0 * t_mult**n
            t_cur = step - t_start
        return eta_min + (base_lr * gamma**step - eta_min) * (1 + math.cos(math.pi * t_cur / t_i)) / 2

    return schedule


def flat_cosine_annealing_schedule(
    base_lr: float, t_max: int, t_flat: int, eta_min: float = 0.0
) -> Schedule:
    """Flat LR for t_flat steps, then cosine to eta_min (fast.ai fit_flat_cos;
    reference FlatCosineAnnealingLR closed form, lr_schedules.py:249-257)."""

    def schedule(step: int) -> float:
        t = max(0, step - t_flat)
        span = max(1, t_max - t_flat)
        return eta_min + (base_lr - eta_min) * (1 + math.cos(math.pi * t / span)) / 2

    return schedule


def gradual_warmup_schedule(
    base_lr: float,
    multiplier: float,
    total_epoch: int,
    after_schedule: Optional[Schedule] = None,
) -> Schedule:
    """Linear warmup to base_lr * multiplier, then chain to another schedule
    (reference GradualWarmupScheduler, lr_schedules.py:120-187)."""
    if multiplier < 1.0:
        raise ValueError("multiplier should be greater than or equal to 1.")

    def schedule(step: int) -> float:
        if step > total_epoch:
            if after_schedule is not None:
                return after_schedule(step - total_epoch)
            return base_lr * multiplier
        if multiplier == 1.0:
            return max(1e-6, base_lr * (float(step) / total_epoch))
        return base_lr * ((multiplier - 1.0) * step / total_epoch + 1.0)

    return schedule
