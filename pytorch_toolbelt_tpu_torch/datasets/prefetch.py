"""Host -> device input pipelining (counterpart of ``pytorch_toolbelt_tpu/datasets/prefetch.py``).

The JAX package keeps ``size`` ``device_put``s in flight and lets async
dispatch overlap them with the running step.  Here each leaf goes to pinned
host memory, then to the card with ``non_blocking=True`` on a side stream,
``size`` batches ahead of the consumer.  Before a batch is handed out, the
consumer's stream waits on its copy's event, and each tensor is marked as
used on that stream (``record_stream``), so the caching allocator does not
hand its memory to a later copy while the step still reads it.  The pinned
host buffers need no reference kept: torch's pinned-memory allocator records
the copy's stream and reuses a buffer only after the copy has finished.

Typical loop::

    for batch in prefetch_to_device(loader, sharding=batch_sharding(make_mesh(), 4)):
        loss = train_step(batch)

``loader`` is any iterable of numpy-array (or CPU tensor) pytrees: dicts,
lists and tuples of them (``default_collate``'s batches).
"""

from collections import deque
from typing import Any, Callable, Iterable, Iterator, Optional, Union

import numpy as np
import torch

from ..distributed.mesh import MeshSharding, local_part

__all__ = ["prefetch_to_device"]


def _map(fn: Callable, item):
    """Apply ``fn`` to every numeric array or tensor of nested dicts / lists / tuples."""
    if isinstance(item, torch.Tensor) or (isinstance(item, np.ndarray) and item.dtype.kind in "biufc"):
        return fn(item)
    if isinstance(item, dict):
        return {k: _map(fn, v) for k, v in item.items()}
    if isinstance(item, (list, tuple)):
        return type(item)(_map(fn, v) for v in item)
    return item


def _tensors(item) -> Iterator[torch.Tensor]:
    if isinstance(item, torch.Tensor):
        yield item
    elif isinstance(item, (dict, list, tuple)):
        for value in item.values() if isinstance(item, dict) else item:
            yield from _tensors(value)


def prefetch_to_device(
    iterable: Iterable[Any],
    size: int = 2,
    sharding: Optional[MeshSharding] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> Iterator[Any]:
    """Yield the items of ``iterable`` with their arrays on ``device``,
    keeping up to ``size`` copies in flight ahead of the consumer.

    Args:
        iterable: yields pytrees of host arrays (numpy or CPU tensors).
        size: prefetch depth; 2 = double buffering.
        sharding: optional :class:`~..distributed.MeshSharding` (e.g.
            ``batch_sharding(mesh, 4)``): each rank takes only its own part
            of every array, as the ``data`` axis splits the global batch.
        device: the card (default: the current CUDA device; raises without
            one), or ``"cpu"``, where the arrays become CPU tensors.
    """
    device = torch.device("cuda" if device is None else device)
    on_card = device.type == "cuda"
    if on_card:
        if not torch.cuda.is_available():
            raise RuntimeError("torch.cuda.is_available() is false; pass device='cpu' to run on the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        copies = torch.cuda.Stream(device)

    def host(leaf) -> torch.Tensor:
        t = torch.from_numpy(leaf) if isinstance(leaf, np.ndarray) else leaf
        return t if sharding is None else local_part(t, sharding)

    def put(item):
        if not on_card:
            return _map(lambda leaf: host(leaf).to(device), item), None
        pinned = _map(lambda leaf: host(leaf).contiguous().pin_memory(), item)
        with torch.cuda.stream(copies):
            moved = _map(lambda t: t.to(device, non_blocking=True), pinned)
            done = torch.cuda.Event()
            done.record(copies)
        return moved, done

    queue: deque = deque()
    it = iter(iterable)
    for item in it:
        queue.append(put(item))
        if len(queue) >= max(1, size):
            break
    while queue:
        moved, done = queue.popleft()
        if done is not None:
            consumer = torch.cuda.current_stream(device)
            consumer.wait_event(done)
            for t in _tensors(moved):
                t.record_stream(consumer)
        yield moved
        for item in it:
            queue.append(put(item))
            break
