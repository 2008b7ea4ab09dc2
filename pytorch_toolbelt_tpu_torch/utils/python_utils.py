"""Misc python helpers (counterpart of ``pytorch_toolbelt_tpu/utils/python_utils.py``)."""

import numbers
from typing import Any, Dict, Iterable, Tuple, Union

from ..core.support import toolbelt_deprecated

__all__ = ["maybe_eval", "without", "load_yaml", "as_tuple_of_two"]


def maybe_eval(x):
    """Evaluate '$'-prefixed strings; recurse into lists."""
    if isinstance(x, str):
        if x.startswith("$"):
            return eval(x[1:])
        return x
    if isinstance(x, list):
        return list(map(maybe_eval, x))
    return x


def without(dictionary: Dict, key: Union[str, set]) -> Dict:
    """Copy of dictionary without the given key(s)."""
    if isinstance(key, str):
        key = {key}
    return {k: v for k, v in dictionary.items() if k not in key}


@toolbelt_deprecated("This method is deprecated. Please use OmegaConf")
def load_yaml(stream: Any):
    """YAML load with float-safe resolver for values like 1e-4."""
    import re

    import yaml

    loader = yaml.SafeLoader
    loader.add_implicit_resolver(
        "tag:yaml.org,2002:float",
        re.compile(
            """^(?:
         [-+]?(?:[0-9][0-9_]*)\\.[0-9_]*(?:[eE][-+]?[0-9]+)?
        |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
        |\\.[0-9_]+(?:[eE][-+][0-9]+)?
        |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\\.[0-9_]*
        |[-+]?\\.(?:inf|Inf|INF)
        |\\.(?:nan|NaN|NAN))$""",
            re.X,
        ),
        list("-+0123456789."),
    )
    return yaml.load(stream, Loader=loader)


def as_tuple_of_two(value) -> Tuple[numbers.Number, numbers.Number]:
    """512 -> (512, 512); (256, 257) -> (256, 257)."""
    if isinstance(value, Iterable):
        a, b = value
        return a, b
    if isinstance(value, numbers.Number):
        return value, value
    raise RuntimeError(f"Unsupported input value {value}")
