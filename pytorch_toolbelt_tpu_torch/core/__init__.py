from .interfaces import (
    AbstractDecoder,
    AbstractHead,
    FeatureMapsSpec,
    FeatureMapsSpecification,
    HasOutputFeaturesSpecification,
)
from .support import DeprecationError, toolbelt_deprecated

__all__ = [
    "AbstractDecoder",
    "AbstractHead",
    "DeprecationError",
    "FeatureMapsSpec",
    "FeatureMapsSpecification",
    "HasOutputFeaturesSpecification",
    "toolbelt_deprecated",
]
