"""Device mesh and process-group helpers (counterpart of
``pytorch_toolbelt_tpu/distributed/mesh.py``).

torch runs one process per GPU, so the job's device count, which
``jax.device_count()`` gives the JAX package, is the process group's world
size here: ``dist.get_world_size()`` when a group is initialized, else 1.

The JAX package trains SPMD over a ``jax.sharding.Mesh`` with axes
``("data", "spatial")``; here :func:`make_mesh` gives a ``DeviceMesh`` with
the same dims, the sharding helpers give DTensor placements with their mesh
(:class:`MeshSharding`), and :func:`data_parallel` wraps the model in
``DistributedDataParallel``.  Two things differ:

* under ``jit`` over a batch-sharded mesh, XLA computes BatchNorm statistics
  and the loss over the global batch; DDP computes both per rank.
  :func:`data_parallel` converts every batch norm to the port's
  ``SyncBatchNorm2d`` (``global_batch.py``) when the world is larger than 1,
  and a loss that does not decompose over ranks (Lovasz with
  ``per_image=False``, batch-reduced dice) runs on the logits and targets of
  ``global_batch.gather_batch``, as the example's does;
* XLA inserts the halo exchanges of convolutions over a ``spatial`` axis,
  torch does not, so ``spatial_parallel`` must be 1.
"""

from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import Replicate, Shard

__all__ = [
    "MESH_DIMS",
    "MeshSharding",
    "batch_sharding",
    "batch_spatial_sharding",
    "data_parallel",
    "local_part",
    "make_mesh",
    "replicated",
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


MESH_DIMS = ("data", "spatial")


def make_mesh(data_parallel: Optional[int] = None, spatial_parallel: int = 1, device_type: str = "cuda"):
    """A ``DeviceMesh`` of shape (data_parallel, spatial_parallel) with dims
    ``("data", "spatial")`` over the initialized group's world, or over this
    process's one device without a group."""
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false; pass device_type='cpu' to run on the CPU")
    if spatial_parallel != 1:
        raise NotImplementedError(
            "spatial_parallel > 1 needs a halo exchange around every convolution, which torch does not insert "
            "(ROADMAP.md, queue 1: slice D on four GPUs)"
        )
    n = get_world_size()
    if data_parallel is None:
        data_parallel = n // spatial_parallel
    if data_parallel * spatial_parallel != n:
        raise ValueError(f"data_parallel ({data_parallel}) x spatial_parallel ({spatial_parallel}) != devices ({n})")
    if _initialized():
        return init_device_mesh(device_type, (data_parallel, spatial_parallel), mesh_dim_names=MESH_DIMS)
    # one process and no group: a mesh of this process's device that needs no backend
    return DeviceMesh(device_type, [[0]], mesh_dim_names=MESH_DIMS, _init_backend=False, _rank=0)


@dataclass(frozen=True)
class MeshSharding:
    """DTensor placements (one per mesh dim) with their mesh: the
    counterpart of a ``jax.sharding.NamedSharding``."""

    mesh: Any
    placements: Tuple[Any, ...]


def batch_sharding(mesh, ndim: int = 4) -> MeshSharding:
    """Dim 0 (the batch) over ``data``; replicated over ``spatial``.
    ``ndim`` has no effect: dim 0 is the batch at any rank.  It is kept so
    that calls read as the JAX package's, and as :func:`batch_spatial_sharding`'s."""
    return MeshSharding(mesh, (Shard(0), Replicate()))


def batch_spatial_sharding(mesh, ndim: int = 4) -> MeshSharding:
    """The batch over ``data`` and the rows over ``spatial``: dim 2 of NCHW
    images, dim 1 of [B, H, W] targets (the JAX package's NHWC axis 1)."""
    return MeshSharding(mesh, (Shard(0), Shard(ndim - 2)))


def replicated(mesh) -> MeshSharding:
    return MeshSharding(mesh, (Replicate(), Replicate()))


def local_part(x: torch.Tensor, sharding: MeshSharding) -> torch.Tensor:
    """This rank's part of a global tensor under ``sharding``: along each
    mesh dim with a ``Shard(d)`` placement, the rank's equal chunk of dim d."""
    coordinate = sharding.mesh.get_coordinate()
    for mesh_dim, placement in enumerate(sharding.placements):
        if not isinstance(placement, Shard):
            continue
        n, d = sharding.mesh.size(mesh_dim), placement.dim
        if x.shape[d] % n:
            raise ValueError(f"dim {d} of size {x.shape[d]} does not split into {n} equal parts")
        size = x.shape[d] // n
        x = x.narrow(d, coordinate[mesh_dim] * size, size)
    return x


def data_parallel(model: nn.Module, mesh=None, **ddp_kwargs) -> nn.Module:
    """Wrap ``model`` in ``DistributedDataParallel`` over the mesh's ``data``
    dim (the whole group without a mesh); batch norms become the port's
    ``SyncBatchNorm2d`` over that group when it holds more than one process.
    Without an initialized group the model is returned as it is."""
    from .global_batch import convert_sync_batchnorm

    if not _initialized():
        return model
    group = mesh.get_group("data") if mesh is not None else None
    if dist.get_world_size(group) > 1:
        model = convert_sync_batchnorm(model, group)
    first = next(model.parameters(), None)
    device_ids = [first.device] if first is not None and first.is_cuda else None
    return nn.parallel.DistributedDataParallel(model, device_ids=device_ids, process_group=group, **ddp_kwargs)
