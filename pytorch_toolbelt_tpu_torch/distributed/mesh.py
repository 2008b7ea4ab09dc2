"""Process-group queries (counterpart of the host helpers of
``pytorch_toolbelt_tpu/distributed/mesh.py``).

torch runs one process per GPU, so the job's device count, which
``jax.device_count()`` gives the JAX package, is the process group's world
size here: ``dist.get_world_size()`` when a group is initialized, else 1.
The JAX package's sharding helpers (``make_mesh``, ``batch_sharding``,
``batch_spatial_sharding``, ``replicated``) serve training and wait for its
slice of the port.
"""

from typing import Optional

import torch.distributed as dist

__all__ = [
    "get_rank",
    "get_world_size",
    "is_main_process",
    "master_print",
    "scale_learning_rate_for_ddp",
]


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_world_size() -> int:
    """Processes (one per GPU) of the initialized group; 1 without one."""
    return dist.get_world_size() if _initialized() else 1


def get_rank() -> int:
    """This process's rank in the initialized group; 0 without one."""
    return dist.get_rank() if _initialized() else 0


def is_main_process() -> bool:
    return get_rank() == 0


def master_print(*args, **kwargs) -> None:
    """Print only from the main process."""
    if is_main_process():
        print(*args, **kwargs)


def scale_learning_rate_for_ddp(lr: float, world_size: Optional[int] = None) -> float:
    """Linear LR scaling by the number of data-parallel processes."""
    if world_size is None:
        world_size = get_world_size()
    return lr * world_size
