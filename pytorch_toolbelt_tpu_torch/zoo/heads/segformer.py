"""SegFormer MLP head (arXiv:2105.15203; counterpart of
``pytorch_toolbelt_tpu/zoo/heads/segformer.py``).  The default GELU is the
tanh approximation, as ``jax.nn.gelu``'s."""

from typing import List, Optional, Tuple

import torch
from torch import nn

from ...core.interfaces import FeatureMapsSpec
from ...datasets.common import name_for_stride
from ...nn.activations import ACT_GELU, instantiate_activation_block
from ...nn.functional import resize_bilinear
from ...nn.normalization import BN_MOMENTUM, BatchNorm2d

__all__ = ["SegFormerHead"]


class SegFormerHead(nn.Module):
    """Per-level 1x1 projection -> resize to the finest -> concat (coarsest
    first) -> fuse (1x1 conv, norm, act) -> dropout -> 1x1 conv -> resize to
    ``output_size``.  With ``with_supervision``, one more 1x1 conv per
    projected level; flax creates those after the fused path, so they are
    registered last."""

    def __init__(self, input_spec: FeatureMapsSpec, num_classes: int, embedding_dim: int = 256,
                 with_supervision: bool = False, output_name: Optional[str] = None, dropout_rate: float = 0.0,
                 activation: str = ACT_GELU):
        super().__init__()
        if len(input_spec) != 4:
            raise ValueError("SegFormerHead expects exactly 4 feature maps")
        self.input_spec = input_spec
        self.num_classes = num_classes
        self.with_supervision = with_supervision
        self.output_name = output_name
        self.project = nn.ModuleList(nn.Conv2d(c, embedding_dim, 1) for c in input_spec.channels)
        self.fuse_conv = nn.Conv2d(4 * embedding_dim, embedding_dim, 1, bias=False)
        self.fuse_bn = BatchNorm2d(embedding_dim, momentum=BN_MOMENTUM)
        self.act = instantiate_activation_block(activation)
        self.dropout = nn.Dropout(dropout_rate)
        self.final = nn.Conv2d(embedding_dim, num_classes, 1)
        self.supervision = (nn.ModuleList(nn.Conv2d(embedding_dim, num_classes, 1) for _ in range(4))
                            if with_supervision else None)

    def get_output_spec(self) -> FeatureMapsSpec:
        return FeatureMapsSpec(channels=(self.num_classes,), strides=(1,))

    def forward(self, feature_maps: List[torch.Tensor], output_size: Tuple[int, int]):
        if len(feature_maps) != 4:
            raise ValueError("SegFormerHead expects exactly 4 feature maps")
        c1, c2, c3, c4 = (conv(fm) for conv, fm in zip(self.project, feature_maps))
        target = c1.shape[2:]
        fused = torch.cat([resize_bilinear(c4, target), resize_bilinear(c3, target), resize_bilinear(c2, target), c1],
                          dim=1)
        fused = self.act(self.fuse_bn(self.fuse_conv(fused)))
        x = resize_bilinear(self.final(self.dropout(fused)), output_size)
        outputs = {self.output_name: x} if self.output_name is not None else x
        if self.supervision is not None:
            sup = [conv(c) for conv, c in zip(self.supervision, (c1, c2, c3, c4))]
            if self.output_name is not None:
                for stride, out in zip((4, 8, 16, 32), sup):
                    outputs[name_for_stride(self.output_name, stride)] = out
            else:
                outputs = (outputs,) + tuple(sup)
        return outputs
