"""Cross-process communication helpers over ``torch.distributed``
(counterpart of ``pytorch_toolbelt_tpu/distributed/comm.py``): generic
object all-gather, master broadcast, dict reduction, work splitting across
processes, and the process-group guard.

Every helper is the identity without an initialized group of more than one
process, as the JAX helpers are in a single-process run.
"""

import datetime
import functools
import logging
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..utils.bucket_assignment import filler_bucket_assignment
from .mesh import get_rank, get_world_size, is_main_process

logger = logging.getLogger(__name__)

__all__ = [
    "DistributedGuard",
    "all_gather",
    "broadcast_from_master",
    "reduce_dict_sum",
    "split_across_nodes",
    "master_node_only",
    "is_dist_avail_and_initialized",
]


def is_dist_avail_and_initialized() -> bool:
    """True when an initialized process group has more than one process."""
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def all_gather(data: Any) -> List[Any]:
    """Gather a picklable object from every process, in rank order."""
    if not is_dist_avail_and_initialized():
        return [data]
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, data)
    return gathered


def broadcast_from_master(data: Any) -> Any:
    """Broadcast a picklable object from rank 0 to every process."""
    if not is_dist_avail_and_initialized():
        return data
    box = [data if is_main_process() else None]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def reduce_dict_sum(input_dict: Dict[str, Any]) -> Dict[str, Any]:
    """Element-wise sum of dict values across processes."""
    if not is_dist_avail_and_initialized():
        return input_dict
    result: Dict[str, Any] = {}
    for d in all_gather(input_dict):
        for key, value in d.items():
            result[key] = result[key] + value if key in result else value
    return result


def split_across_nodes(
    collection: Sequence,
    costs: Optional[np.ndarray] = None,
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
) -> List:
    """This rank's share of the work items: every ``world_size``-th item from
    ``rank``, or, when per-item costs are given, the greedy cost-balanced
    bucket of ``filler_bucket_assignment``."""
    if world_size is None:
        world_size = get_world_size()
    if rank is None:
        rank = get_rank()
    if world_size == 1:
        return list(collection)

    if costs is not None:
        if len(costs) != len(collection):
            raise ValueError("costs must have the same length as the collection")
        assignment = filler_bucket_assignment(np.asarray(costs, dtype=np.float64), world_size)
        return [item for item, bucket in zip(collection, assignment) if bucket == rank]

    return list(collection[rank::world_size])


class DistributedGuard:
    """Context manager that makes and ends the process group.

    Given an ``init_method`` (``"env://"`` under ``torchrun``,
    ``"tcp://host:port"`` or ``"file:///path"``) and no group exists yet,
    ``__enter__`` calls ``init_process_group`` and ``__exit__`` calls
    ``destroy_process_group``.  Without an ``init_method`` it is a no-op.
    ``rank`` may be left out: ``env://`` reads it from ``RANK``, and a world
    of one process takes rank 0.

    The backend is ``nccl`` unless ``backend`` names another; ``nccl``
    without a GPU raises (pass ``backend="gloo"`` to run on the CPU).  Under
    ``nccl`` each process takes GPU ``rank % torch.cuda.device_count()`` as
    its current device while the group lives.
    """

    def __init__(self, init_method: Optional[str] = None, world_size: Optional[int] = None,
                 rank: Optional[int] = None, backend: Optional[str] = None, timeout_s: float = 1800.0):
        self.init_method = init_method
        self.world_size = world_size
        self.rank = rank
        self.backend = backend or "nccl"
        self.timeout_s = timeout_s
        self._initialized_here = False
        self._previous_device = None

    def __enter__(self):
        if self.init_method is not None and not (dist.is_available() and dist.is_initialized()):
            if self.backend == "nccl" and not torch.cuda.is_available():
                raise RuntimeError("the nccl backend needs a CUDA GPU; pass backend='gloo' to run on the CPU")
            kwargs = {} if self.world_size is None else {"world_size": self.world_size}
            # without a rank torch takes its own default, which env:// fills from RANK; a world
            # of one has only rank 0
            rank = 0 if self.rank is None and self.world_size == 1 else self.rank
            if rank is not None:
                kwargs["rank"] = rank
            dist.init_process_group(self.backend, init_method=self.init_method,
                                    timeout=datetime.timedelta(seconds=self.timeout_s), **kwargs)
            self._initialized_here = True
            if self.backend == "nccl":
                self._previous_device = torch.cuda.current_device()
                torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
        logger.info("DistributedGuard: %d processes, rank %d", get_world_size(), get_rank())
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        if self._initialized_here:
            dist.destroy_process_group()
            self._initialized_here = False
            if self._previous_device is not None:
                torch.cuda.set_device(self._previous_device)
                self._previous_device = None
        return False


def master_node_only(func=None, *, default=None):
    """Decorator: run the function only on the main process; other ranks
    get ``default``."""

    def decorator(f):
        @functools.wraps(f)
        def wrapper(*args, **kwargs):
            if is_main_process():
                return f(*args, **kwargs)
            return default

        return wrapper

    if func is not None:
        return decorator(func)
    return decorator
