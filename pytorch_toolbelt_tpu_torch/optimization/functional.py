"""Optimizer parameter groups (counterpart of ``pytorch_toolbelt_tpu/optimization/functional.py``).

The JAX package labels the leaves of a params pytree for
``optax.multi_transform``; here the same rules group a module's
``named_parameters`` into the param groups of one torch optimizer.  Every
parameter gets a group from prefix-matched layerwise LR / WD specs (with
``_default_``), honoring the no-weight-decay-on-bias/norm switches, and the
parameter count of the groups must add up to the model's.

Norm parameters are told by their module's type (``_BatchNorm``,
``GroupNorm``, ``LayerNorm``, ``_InstanceNorm``, ``RMSNorm``), where the
JAX package looks for flax's auto-names (``BatchNorm_0``) in the path.
"""

import numbers
from typing import Callable, Dict, Iterable, List, Mapping, Tuple, Union

import torch
from torch import nn

from ..distributed.mesh import scale_learning_rate_for_ddp  # re-export, as in the JAX package

__all__ = [
    "build_optimizer_param_groups",
    "make_optimizer",
    "freeze_parameters",
    "count_optimizable_parameters",
    "scale_learning_rate_for_ddp",
]

_NORM_TYPES = (nn.modules.batchnorm._BatchNorm, nn.GroupNorm, nn.LayerNorm, nn.modules.instancenorm._InstanceNorm,
               nn.RMSNorm)


def _trainable(model: nn.Module) -> List[Tuple[str, nn.Parameter]]:
    return [(name, p) for name, p in model.named_parameters() if p.requires_grad]


def _norm_parameter_names(model: nn.Module) -> set:
    names = set()
    for module_name, module in model.named_modules():
        if isinstance(module, _NORM_TYPES):
            names.update(name for name, _ in module.named_parameters(prefix=module_name, recurse=False))
    return names


def build_optimizer_param_groups(
    model: nn.Module,
    learning_rate: Union[float, Mapping[str, float]],
    weight_decay: Union[float, Mapping[str, float]],
    apply_weight_decay_on_bias: bool = True,
    apply_weight_decay_on_norm: bool = True,
):
    """Assign each trainable parameter of ``model`` to an (lr, weight_decay) group.

    Args:
        learning_rate: scalar or {prefix: lr, ..., '_default_': lr} matched
            against parameter names like 'encoder.layer0.conv1.weight'.
        weight_decay: scalar or prefix-dict like learning_rate.

    Returns:
        (labels, groups, defaults):
        labels — {parameter name: group name}, in ``named_parameters`` order;
        groups — {name: {'lr': float, 'weight_decay': float, 'count': int}};
        defaults — {'lr': ..., 'weight_decay': ...}.
    """
    if isinstance(learning_rate, Mapping) and "_default_" not in learning_rate:
        raise RuntimeError(
            "When using layerwise learning rate, a key _default_ must be present to indicate default LR"
        )
    if isinstance(weight_decay, Mapping) and "_default_" not in weight_decay:
        raise RuntimeError(
            "When using layerwise weight decay, a key _default_ must be present to indicate default LR"
        )

    if isinstance(learning_rate, numbers.Number):
        learning_rate = {"_default_": float(learning_rate)}
    if isinstance(weight_decay, numbers.Number):
        weight_decay = {"_default_": float(weight_decay)}

    default_lr = float(learning_rate["_default_"])
    default_wd = float(weight_decay["_default_"])
    lr_items = [(k, v) for k, v in learning_rate.items() if k != "_default_"]
    wd_items = [(k, v) for k, v in weight_decay.items() if k != "_default_"]
    norms = _norm_parameter_names(model)

    groups: Dict[str, Dict] = {}
    # Groups are identified by the (lr_index, wd_index) TUPLE: '_'-joined
    # strings collide when prefixes contain '_' (lr 'a' + wd 'b_c' against
    # lr 'a_b' + wd 'c').  Clashing display names get a numeric suffix.
    name_by_key: Dict[Tuple[str, str], str] = {}
    labels: Dict[str, str] = {}
    for name, p in _trainable(model):
        lr_index, lr_value = "default", default_lr
        for prefix, lr in lr_items:
            if name.startswith(prefix):
                lr_index, lr_value = prefix, float(lr)
                break
        wd_index, wd_value = "default", default_wd
        for prefix, wd in wd_items:
            if name.startswith(prefix):
                wd_index, wd_value = prefix, float(wd)
                break

        is_norm = name in norms
        if not apply_weight_decay_on_norm and is_norm:
            wd_index, wd_value = "no_wd_on_norm", 0.0
        elif not apply_weight_decay_on_bias and name.endswith(".bias") and not is_norm:
            wd_index, wd_value = "no_wd_on_bias", 0.0

        key = (lr_index, wd_index)
        group_name = name_by_key.get(key)
        if group_name is None:
            group_name = lr_index if lr_index == wd_index else f"{lr_index}_{wd_index}"
            taken = set(name_by_key.values())
            if group_name in taken:
                suffix = 2
                while f"{group_name}~{suffix}" in taken:
                    suffix += 1
                group_name = f"{group_name}~{suffix}"
            name_by_key[key] = group_name
        entry = groups.setdefault(group_name, {"lr": lr_value, "weight_decay": wd_value, "count": 0})
        entry["count"] += p.numel()
        labels[name] = group_name

    total = count_optimizable_parameters(model)
    grouped = sum(g["count"] for g in groups.values())
    if total != grouped:
        raise RuntimeError(
            f"Detected mismatch in total number of optimizable parameters ({total}) and "
            f"number of parameters across each groups ({grouped})."
        )

    defaults = {"lr": default_lr, "weight_decay": default_wd}
    return labels, groups, defaults


def make_optimizer(
    model: nn.Module,
    learning_rate: Union[float, Mapping[str, float]],
    weight_decay: Union[float, Mapping[str, float]] = 0.0,
    optimizer_factory: Callable[..., torch.optim.Optimizer] = torch.optim.AdamW,
    apply_weight_decay_on_bias: bool = True,
    apply_weight_decay_on_norm: bool = True,
    **opt_kwargs,
) -> torch.optim.Optimizer:
    """One ``optimizer_factory(param_groups, lr=..., weight_decay=..., **opt_kwargs)``
    with one param group (``'name'``, ``'lr'``, ``'weight_decay'``) per group of
    :func:`build_optimizer_param_groups`."""
    labels, groups, defaults = build_optimizer_param_groups(
        model,
        learning_rate,
        weight_decay,
        apply_weight_decay_on_bias=apply_weight_decay_on_bias,
        apply_weight_decay_on_norm=apply_weight_decay_on_norm,
    )
    params = dict(_trainable(model))
    param_groups = [
        {"params": [params[n] for n, label in labels.items() if label == name], "name": name,
         "lr": g["lr"], "weight_decay": g["weight_decay"]}
        for name, g in groups.items()
    ]
    return optimizer_factory(param_groups, lr=defaults["lr"], weight_decay=defaults["weight_decay"], **opt_kwargs)


def freeze_parameters(prefixes: Union[str, Iterable[str]]) -> Callable[[nn.Module], Dict[str, bool]]:
    """Return ``mask_fn(model) -> {parameter name: frozen}``, True for the
    parameters under the given name prefixes (apply it with
    ``p.requires_grad_(not mask[name])``)."""
    if isinstance(prefixes, str):
        prefixes = (prefixes,)
    prefixes = tuple(prefixes)

    def mask_fn(model: nn.Module) -> Dict[str, bool]:
        return {name: any(name.startswith(p) for p in prefixes) for name, _ in model.named_parameters()}

    return mask_fn


def count_optimizable_parameters(model: nn.Module) -> int:
    """Elements of the parameters that require a gradient."""
    return sum(p.numel() for _, p in _trainable(model))
