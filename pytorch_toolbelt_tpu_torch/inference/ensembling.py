"""Model ensembling (counterpart of ``pytorch_toolbelt_tpu/inference/ensembling.py``).

Models are plain callables (``nn.Module`` or any function, such as the
forward ``fuse_unet_inference`` builds).  ``Ensembler.from_stacked`` runs
members of one architecture as ONE vmapped forward over their stacked
parameters (``torch.func``), the counterpart of the JAX package's ``vmap``
over stacked parameter pytrees.  ``average_checkpoints`` averages state
dicts.  Logits are NCHW: the softmax of ``ApplySoftmaxTo`` runs over dim 1.
"""

import copy
from typing import Callable, Dict, Iterable, Mapping, Optional, Sequence

import torch
from torch import nn

from .tta import _deaugment_averaging

__all__ = [
    "ApplySoftmaxTo",
    "ApplySigmoidTo",
    "Ensembler",
    "PickModelOutput",
    "SelectByIndex",
    "average_checkpoints",
]


def _as_key_tuple(output_key) -> tuple:
    return (output_key,) if isinstance(output_key, (str, int)) else tuple(set(output_key))


def _copy_container(output):
    return dict(output) if isinstance(output, dict) else list(output) if isinstance(output, list) else output


class ApplySoftmaxTo:
    """Apply temperature-scaled softmax over ``dim`` (channels of NCHW) to
    named outputs of a model callable."""

    def __init__(self, model_fn: Callable, output_key="logits", dim: int = 1, temperature: float = 1):
        self.model_fn = model_fn
        self.output_keys = _as_key_tuple(output_key)
        self.dim = dim
        self.temperature = temperature

    def __call__(self, *args, **kwargs):
        output = _copy_container(self.model_fn(*args, **kwargs))
        for key in self.output_keys:
            output[key] = torch.softmax(output[key] * self.temperature, dim=self.dim)
        return output


class ApplySigmoidTo:
    """Apply temperature-scaled sigmoid to named outputs of a model callable."""

    def __init__(self, model_fn: Callable, output_key="logits", temperature: float = 1):
        self.model_fn = model_fn
        self.output_keys = _as_key_tuple(output_key)
        self.temperature = temperature

    def __call__(self, *args, **kwargs):
        output = _copy_container(self.model_fn(*args, **kwargs))
        for key in self.output_keys:
            output[key] = torch.sigmoid(output[key] * self.temperature)
        return output


class Ensembler:
    """Reduce the outputs of several models (tensor, dict or list outputs)
    with one of the TTA reductions (``'mean'``, ``'sum'``, ``'gmean'``,
    ``'hmean'``, ``'harmonic1p'``, ``'logodd'``, ``'log1p'``, a callable or
    None); ``outputs`` picks the keys (or indices) to reduce."""

    def __init__(self, models: Sequence[Callable], reduction="mean", outputs: Optional[Iterable] = None):
        self.models = list(models)
        self.reduction = reduction
        self.return_some_outputs = outputs is not None
        self.outputs = tuple(outputs) if outputs else tuple()
        self._stacked_forward = None

    @classmethod
    def from_stacked(cls, models: Sequence[nn.Module], reduction="mean",
                     outputs: Optional[Iterable] = None) -> "Ensembler":
        """All members share one architecture: their parameters and buffers
        are stacked along a new dim 0 (``torch.func.stack_module_state``)
        and one ``torch.func.vmap`` of ``functional_call`` runs them as one
        batched forward instead of one forward per member."""
        params, buffers = torch.func.stack_module_state(list(models))
        base = copy.deepcopy(models[0]).to("meta")

        def member(p, b, args, kwargs):
            return torch.func.functional_call(base, (p, b), args, kwargs)

        ensemble = cls(models=[], reduction=reduction, outputs=outputs)
        ensemble._stacked_forward = lambda *args, **kwargs: torch.func.vmap(member, in_dims=(0, 0, None, None))(
            params, buffers, args, kwargs)
        return ensemble

    def _member_outputs(self, *args, **kwargs):
        """Every member's output stacked on a new dim 0: a tensor, or a dict
        or list of them."""
        if self._stacked_forward is not None:
            return self._stacked_forward(*args, **kwargs)
        outputs = [model(*args, **kwargs) for model in self.models]
        if isinstance(outputs[0], dict):
            return {key: torch.stack([o[key] for o in outputs]) for key in outputs[0]}
        if isinstance(outputs[0], (list, tuple)):
            return [torch.stack([o[i] for o in outputs]) for i in range(len(outputs[0]))]
        return torch.stack(outputs)

    def __call__(self, *args, **kwargs):
        stacked = self._member_outputs(*args, **kwargs)
        output_is_dict = isinstance(stacked, dict)
        if self.return_some_outputs:
            keys = self.outputs
        elif output_is_dict:
            keys = stacked.keys()
        elif isinstance(stacked, (list, tuple)):
            keys = range(len(stacked))
        else:
            return _deaugment_averaging(stacked, self.reduction)
        if isinstance(stacked, torch.Tensor):  # members on dim 0: take each member's output[key]
            reduced = [_deaugment_averaging(stacked[:, key], self.reduction) for key in keys]
        else:
            reduced = [_deaugment_averaging(stacked[key], self.reduction) for key in keys]
        return dict(zip(keys, reduced)) if output_is_dict else reduced


class PickModelOutput:
    """Wrap a model returning a dict or list; return only ``output[key]``."""

    def __init__(self, model_fn: Callable, key):
        self.model_fn = model_fn
        self.target_key = key

    def __call__(self, *args, **kwargs):
        return self.model_fn(*args, **kwargs)[self.target_key]


class SelectByIndex:
    """Select ``output[key]`` from an already computed outputs container."""

    def __init__(self, key):
        self.target_key = key

    def __call__(self, outputs):
        return outputs[self.target_key]


def average_checkpoints(state_dicts: Sequence[Mapping[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """Average state dicts with the same keys (SWA-style): floating tensors
    are averaged; integer tensors (BatchNorm's ``num_batches_tracked``) are
    summed, then floor-divided by their count."""
    if len(state_dicts) == 0:
        raise ValueError("Need at least one checkpoint")
    num = len(state_dicts)
    averaged = {}
    for key, first in state_dicts[0].items():
        total = first
        for state in state_dicts[1:]:
            total = total + state[key]
        averaged[key] = total / num if torch.is_floating_point(first) else total // num
    return averaged
