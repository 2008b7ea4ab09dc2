"""Batch collation (counterpart of ``pytorch_toolbelt_tpu/datasets/collate.py``).

``default_collate`` stacks the numpy leaves of a list of sample dicts or
tuples into numpy batches (``prefetch_to_device`` moves them to the card);
``get_collate_for_dataset`` finds a dataset's own ``get_collate_fn`` and checks
that concatenated datasets agree on it."""

from typing import Any, Callable, Sequence

import numpy as np

__all__ = ["default_collate", "get_collate_for_dataset"]


def default_collate(batch: Sequence[Any]):
    """Stack a list of samples into batched arrays (recursive over
    dicts / tuples / lists; numbers -> arrays; strings kept as lists)."""
    elem = batch[0]
    if isinstance(elem, dict):
        return {key: default_collate([d[key] for d in batch]) for key in elem}
    if isinstance(elem, (tuple, list)):
        return type(elem)(default_collate(items) for items in zip(*batch))
    if isinstance(elem, str):
        return list(batch)
    if isinstance(elem, (int, float, np.integer, np.floating)):
        return np.asarray(batch)
    if hasattr(elem, "shape"):
        return np.stack([np.asarray(b) for b in batch])
    return list(batch)


def get_collate_for_dataset(dataset) -> Callable:
    """Return the collate fn a dataset advertises via ``get_collate_fn``.

    For concatenations (objects with a ``datasets`` attribute), verifies all
    members share the same collate fn like the reference's ConcatDataset
    consistency check.
    """
    collate_fn = default_collate

    get_collate = getattr(dataset, "get_collate_fn", None)
    if callable(get_collate):
        found = get_collate()
        if found is not None:
            collate_fn = found

    members = getattr(dataset, "datasets", None)
    if members is not None:
        collates = [get_collate_for_dataset(ds) for ds in members]
        if any(c != collates[0] for c in collates):
            raise ValueError("Datasets have different collate functions")
        collate_fn = collates[0]
    return collate_fn
