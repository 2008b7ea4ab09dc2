"""Migration-friendly namespace (counterpart of ``pytorch_toolbelt_tpu/modules.py``):
``pytorch_toolbelt_tpu_torch.modules`` mirrors the reference's
``pytorch_toolbelt.modules`` import surface (blocks + encoders + decoders +
heads in one place).  New code should import from ``nn`` and ``zoo``
directly.
"""

from .nn import *  # noqa: F401,F403
from .zoo import *  # noqa: F401,F403
from .core.interfaces import FeatureMapsSpec, FeatureMapsSpecification  # noqa: F401
