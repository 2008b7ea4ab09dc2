"""Deprecation helper (counterpart of ``pytorch_toolbelt_tpu/core/support.py``)."""

import functools
import warnings

__all__ = ["toolbelt_deprecated", "DeprecationError"]


class DeprecationError(Exception):
    pass


def toolbelt_deprecated(reason: str):
    """Decorator that emits a DeprecationWarning with ``reason`` on call."""

    def decorator(func):
        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            warnings.warn(reason, DeprecationWarning, stacklevel=2)
            return func(*args, **kwargs)

        return wrapper

    return decorator
