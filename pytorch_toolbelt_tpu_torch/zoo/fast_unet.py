"""Fused inference forward for ``UNetSegmentationModel`` (counterpart of
``fuse_unet_inference`` in ``pytorch_toolbelt_tpu/zoo/fast_unet.py``).

BatchNorm is folded into each conv's epilogue once, when the forward is
built, and every 3x3 conv of the forward (the 3-channel stem, every encoder
and decoder conv, and the head with its bias and no ReLU) runs through the
K2 kernel :func:`~pytorch_toolbelt_tpu_torch.ops.conv3x3`.  Pooling,
upsampling and concatenation are plain torch ops.  Activations stay bf16 in
the ``channels_last`` memory format between the convs.

The TPU package's space-to-depth variant (``fuse_unet_inference_s2d``)
works around the TPU's 128-lane layout and is not ported.
"""

from typing import Callable, List

import torch
import torch.nn.functional as F

from ..nn.activations import ACT_RELU
from ..nn.functional import resize_bilinear
from ..nn.normalization import _BATCH_ALIASES
from ..nn.unet import UnetBlock
from ..ops.conv_kernels import conv3x3, fold_batchnorm, pack_conv3x3_weights
from .models import UNetSegmentationModel

__all__ = ["fuse_unet_inference"]

_CL = torch.channels_last


class _FusedConv:
    """One 3x3 conv with its folded epilogue, weights packed for K2."""

    def __init__(self, weight: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, relu: bool):
        self.w_packed = pack_conv3x3_weights(weight.detach())
        self.scale = scale.detach().float().contiguous()
        self.bias = bias.detach().float().contiguous()
        self.relu = relu

    @classmethod
    def from_block(cls, block: UnetBlock) -> List["_FusedConv"]:
        convs = []
        for conv, norm in ((block.conv1, block.norm1), (block.conv2, block.norm2)):
            bn = norm.norm
            scale, bias = fold_batchnorm(bn.weight.float(), bn.bias.float(), bn.running_mean.float(),
                                         bn.running_var.float(), bn.eps)
            convs.append(cls(conv.weight, scale, bias, relu=True))
        return convs

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return conv3x3(x, self.w_packed, self.scale, self.bias, relu=self.relu)


def fuse_unet_inference(model: UNetSegmentationModel) -> Callable[[torch.Tensor], torch.Tensor]:
    """Build the inference forward of a trained ``UNetSegmentationModel``.

    Returns ``forward(x: [B, C, H, W]) -> [B, num_classes, H, W]`` bf16
    logits (or ``{output_name: logits}``), matching ``model.eval()(x)`` at
    bf16 precision.  The forward runs on the device that holds ``model``.
    """
    if model.activation.lower() != ACT_RELU:
        raise NotImplementedError("fuse_unet_inference supports activation='relu' only")
    if model.normalization.lower() not in _BATCH_ALIASES:
        raise NotImplementedError("fuse_unet_inference supports batch normalization only")
    if model.encoder.pool != "max":
        raise NotImplementedError("fuse_unet_inference supports max pooling only")

    enc = [_FusedConv.from_block(block) for block in model.encoder.blocks]
    # decoder stages in creation order: coarsest first
    dec = [[conv for block in stage for conv in _FusedConv.from_block(block)] for stage in model.decoder.stages]
    head_conv = model.head.conv
    head = _FusedConv(head_conv.weight, torch.ones_like(head_conv.bias), head_conv.bias, relu=False)
    output_name = model.output_name

    @torch.no_grad()
    def forward(x: torch.Tensor):
        in_hw = tuple(x.shape[2:])
        x = x.to(torch.bfloat16).contiguous(memory_format=_CL)
        skips = []
        for layer, convs in enumerate(enc):
            if layer > 0:
                x = F.max_pool2d(x, 2).contiguous(memory_format=_CL)
            for conv in convs:
                x = conv(x)
            skips.append(x)
        for convs, skip in zip(dec, reversed(skips[:-1])):
            x = resize_bilinear(x, skip.shape[2:], align_corners=True)
            x = torch.cat([x, skip], dim=1).contiguous(memory_format=_CL)
            for conv in convs:
                x = conv(x)
        y = head(x)
        y = resize_bilinear(y, in_hw, align_corners=False).contiguous()
        if output_name is not None:
            return {output_name: y}
        return y

    return forward
