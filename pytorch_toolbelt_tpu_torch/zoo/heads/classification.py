"""Classification heads (counterpart of
``pytorch_toolbelt_tpu/zoo/heads/classification.py``).

flax's ``Dense`` is ``nn.Linear`` (its kernel [in, out] is the transposed
``weight``; ``zoo.porting`` transposes it).  A head's input features come
from ``input_spec``, except where they depend on the map's size or on a
``pool_fn``: there the linear layer is ``nn.LazyLinear``, as flax infers it.
``FullyConnectedClassificationHead`` flattens the NCHW map in torch's
(c, h, w) order; flax flattens NHWC in (h, w, c) order, and the bridge
reorders its kernel's rows.
"""

from typing import Callable, List, Optional

import torch
from torch import nn

from ...core.interfaces import FeatureMapsSpec
from ...nn.activations import ACT_RELU, instantiate_activation_block
from ...nn.normalization import BN_MOMENTUM, BatchNorm1d
from ...nn.pooling import GeneralizedMeanPooling2d

__all__ = [
    "FullyConnectedClassificationHead",
    "GeneralizedMeanPoolingClassificationHead",
    "GenericPoolingClassificationHead",
    "GlobalAveragePoolingClassificationHead",
    "GlobalMaxAvgPoolingClassificationHead",
    "GlobalMaxAvgSumPoolingClassificationHead",
    "GlobalMaxPoolingClassificationHead",
]


class _ClassificationHeadBase(nn.Module):
    def __init__(self, input_spec: FeatureMapsSpec, num_classes: int, dropout_rate: float = 0.0,
                 feature_map_index: int = -1):
        super().__init__()
        self.input_spec = input_spec
        self.num_classes = num_classes
        self.feature_map_index = feature_map_index
        self.in_channels = input_spec.channels[feature_map_index]
        self.dropout = nn.Dropout(dropout_rate)

    def get_output_spec(self) -> FeatureMapsSpec:
        return FeatureMapsSpec(channels=(self.num_classes,), strides=(-1,))


class GenericPoolingClassificationHead(_ClassificationHeadBase):
    """pool(feature_map) -> dropout -> linear.  ``pool_fn`` maps NCHW ->
    [B, F]; without one it is the global average."""

    def __init__(self, input_spec: FeatureMapsSpec, num_classes: int, dropout_rate: float = 0.0,
                 feature_map_index: int = -1, pool_fn: Optional[Callable] = None):
        super().__init__(input_spec, num_classes, dropout_rate, feature_map_index)
        self.pool_fn = pool_fn
        self.fc = nn.LazyLinear(num_classes) if pool_fn is not None else nn.Linear(self.in_channels, num_classes)

    def forward(self, feature_maps: List[torch.Tensor], output_size=None) -> torch.Tensor:
        x = feature_maps[self.feature_map_index]
        x = self.pool_fn(x) if self.pool_fn is not None else x.mean(dim=(2, 3))
        return self.fc(self.dropout(x))


class GlobalAveragePoolingClassificationHead(_ClassificationHeadBase):
    def __init__(self, input_spec: FeatureMapsSpec, num_classes: int, dropout_rate: float = 0.0,
                 feature_map_index: int = -1):
        super().__init__(input_spec, num_classes, dropout_rate, feature_map_index)
        self.fc = nn.Linear(self.in_channels, num_classes)

    def forward(self, feature_maps: List[torch.Tensor], output_size=None) -> torch.Tensor:
        return self.fc(self.dropout(feature_maps[self.feature_map_index].mean(dim=(2, 3))))


class GlobalMaxPoolingClassificationHead(_ClassificationHeadBase):
    def __init__(self, input_spec: FeatureMapsSpec, num_classes: int, dropout_rate: float = 0.0,
                 feature_map_index: int = -1):
        super().__init__(input_spec, num_classes, dropout_rate, feature_map_index)
        self.fc = nn.Linear(self.in_channels, num_classes)

    def forward(self, feature_maps: List[torch.Tensor], output_size=None) -> torch.Tensor:
        return self.fc(self.dropout(feature_maps[self.feature_map_index].amax(dim=(2, 3))))


class GeneralizedMeanPoolingClassificationHead(_ClassificationHeadBase):
    """L2-normalized GeM pooling -> dropout -> linear."""

    def __init__(self, input_spec: FeatureMapsSpec, num_classes: int, dropout_rate: float = 0.0,
                 feature_map_index: int = -1):
        super().__init__(input_spec, num_classes, dropout_rate, feature_map_index)
        self.pool = GeneralizedMeanPooling2d(l2_normalize=True, flatten=True)
        self.fc = nn.Linear(self.in_channels, num_classes)

    def forward(self, feature_maps: List[torch.Tensor], output_size=None) -> torch.Tensor:
        return self.fc(self.dropout(self.pool(feature_maps[self.feature_map_index])))


class FullyConnectedClassificationHead(_ClassificationHeadBase):
    """Flatten everything -> dropout -> linear (``nn.LazyLinear``)."""

    def __init__(self, input_spec: FeatureMapsSpec, num_classes: int, dropout_rate: float = 0.0,
                 feature_map_index: int = -1):
        super().__init__(input_spec, num_classes, dropout_rate, feature_map_index)
        self.fc = nn.LazyLinear(num_classes)

    def forward(self, feature_maps: List[torch.Tensor], output_size=None) -> torch.Tensor:
        return self.fc(self.dropout(feature_maps[self.feature_map_index].flatten(1)))


class GlobalMaxAvgPoolingClassificationHead(_ClassificationHeadBase):
    """Concat of max and average pooling -> (BN-linear-act-dropout) x 2 ->
    linear."""

    def __init__(self, input_spec: FeatureMapsSpec, num_classes: int, dropout_rate: float = 0.0,
                 feature_map_index: int = -1, activation: str = ACT_RELU):
        super().__init__(input_spec, num_classes, dropout_rate, feature_map_index)
        c = self.in_channels
        self.act = instantiate_activation_block(activation)
        self.bn1 = BatchNorm1d(2 * c, momentum=BN_MOMENTUM)
        self.fc1 = nn.Linear(2 * c, c)
        self.bn2 = BatchNorm1d(c, momentum=BN_MOMENTUM)
        self.fc2 = nn.Linear(c, c)
        self.fc3 = nn.Linear(c, num_classes)

    def forward(self, feature_maps: List[torch.Tensor], output_size=None) -> torch.Tensor:
        fm = feature_maps[self.feature_map_index]
        x = torch.cat([fm.amax(dim=(2, 3)), fm.mean(dim=(2, 3))], dim=1)
        x = self.dropout(self.act(self.fc1(self.bn1(x))))
        x = self.dropout(self.act(self.fc2(self.bn2(x))))
        return self.fc3(x)


class GlobalMaxAvgSumPoolingClassificationHead(_ClassificationHeadBase):
    """Sum of max and average pooling -> dropout -> linear."""

    def __init__(self, input_spec: FeatureMapsSpec, num_classes: int, dropout_rate: float = 0.0,
                 feature_map_index: int = -1):
        super().__init__(input_spec, num_classes, dropout_rate, feature_map_index)
        self.fc = nn.Linear(self.in_channels, num_classes)

    def forward(self, feature_maps: List[torch.Tensor], output_size=None) -> torch.Tensor:
        fm = feature_maps[self.feature_map_index]
        return self.fc(self.dropout(fm.amax(dim=(2, 3)) + fm.mean(dim=(2, 3))))
