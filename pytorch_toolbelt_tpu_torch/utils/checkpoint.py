"""Checkpoint save and restore (counterpart of ``pytorch_toolbelt_tpu/utils/checkpoint.py``,
which stores a pytree with orbax).

A checkpoint is one file written by ``torch.save``: a dict whose modules
and optimizers are stored as their ``state_dict``s, next to whatever else
the caller puts in it (the step, :func:`~.random_utils.get_rng_state`).  It
is read back with ``torch.load(weights_only=True)``, so it may hold tensors,
python numbers, strings, lists, tuples and dicts, and nothing else.
"""

import os
from typing import Any, Mapping, Optional

import torch
from torch import nn

__all__ = ["save_checkpoint", "load_checkpoint", "checkpoint_exists"]


def _unwrap(module: nn.Module) -> nn.Module:
    # DistributedDataParallel prefixes its module's names with "module."
    return module.module if isinstance(module, nn.parallel.DistributedDataParallel) else module


def _stored(value: Any) -> Any:
    if isinstance(value, (nn.Module, torch.optim.Optimizer)):
        return (_unwrap(value) if isinstance(value, nn.Module) else value).state_dict()
    return value


def save_checkpoint(path: str, state: Mapping[str, Any], force: bool = True) -> None:
    """Save ``state`` (a dict; modules and optimizers go in as their state
    dicts) to the file ``path``.  Without ``force`` an existing file raises."""
    path = os.path.abspath(path)
    if not force and os.path.exists(path):
        raise FileExistsError(f"checkpoint {path} exists")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp"
    torch.save({key: _stored(value) for key, value in state.items()}, tmp)
    os.replace(tmp, path)  # a reader never sees half a file


def load_checkpoint(path: str, target: Optional[Mapping[str, Any]] = None, map_location="cpu") -> dict:
    """Read a checkpoint written by :func:`save_checkpoint`.

    ``target`` (optional) maps keys of the checkpoint to modules and
    optimizers, which load their state dicts in place; the stored dict is
    returned either way.
    """
    state = torch.load(os.path.abspath(path), map_location=map_location, weights_only=True)
    for key, obj in (target or {}).items():
        if isinstance(obj, nn.Module):
            _unwrap(obj).load_state_dict(state[key])
        elif isinstance(obj, torch.optim.Optimizer):
            obj.load_state_dict(state[key])
        else:
            raise TypeError(f"target[{key!r}] must be a module or an optimizer, got {type(obj).__name__}")
    return state


def checkpoint_exists(path: str) -> bool:
    return os.path.isfile(os.path.abspath(path))
