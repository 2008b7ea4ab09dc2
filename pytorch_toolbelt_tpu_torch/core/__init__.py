from .interfaces import FeatureMapsSpec, FeatureMapsSpecification

__all__ = ["FeatureMapsSpec", "FeatureMapsSpecification"]
