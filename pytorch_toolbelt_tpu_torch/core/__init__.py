from .interfaces import FeatureMapsSpec, FeatureMapsSpecification
from .support import DeprecationError, toolbelt_deprecated

__all__ = ["DeprecationError", "FeatureMapsSpec", "FeatureMapsSpecification", "toolbelt_deprecated"]
