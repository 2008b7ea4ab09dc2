"""Encoder-decoder-head composition and the ready-made UNet (counterpart of
``pytorch_toolbelt_tpu/zoo/models.py``)."""

from typing import Optional, Tuple

import torch
from torch import nn

from ..nn.activations import ACT_RELU
from ..nn.normalization import NORM_BATCH
from .decoders.unet import UNetDecoder
from .encoders.unet import UnetEncoder
from .heads.resize import ResizeHead

__all__ = ["EncoderDecoderModel", "UNetSegmentationModel"]


class EncoderDecoderModel(nn.Module):
    """Generic encoder -> decoder -> head pipeline; the head's output size is
    the input's spatial size."""

    def __init__(self, encoder: nn.Module, decoder: nn.Module, head: nn.Module):
        super().__init__()
        self.encoder = encoder
        self.decoder = decoder
        self.head = head

    def forward(self, x: torch.Tensor):
        feature_maps = self.decoder(self.encoder(x))
        return self.head(feature_maps, output_size=x.shape[2:])


class UNetSegmentationModel(EncoderDecoderModel):
    """The canonical UNet (UnetEncoder + UNetDecoder + conv head).

    ``in_channels`` is new here: flax infers it from the first input.
    """

    def __init__(
        self,
        num_classes: int,
        encoder_channels: int = 32,
        num_layers: int = 4,
        growth_factor: int = 2,
        activation: str = ACT_RELU,
        normalization: str = NORM_BATCH,
        dropout_rate: float = 0.0,
        output_name: Optional[str] = None,
        in_channels: int = 3,
    ):
        encoder = UnetEncoder(
            in_channels=in_channels,
            out_channels=encoder_channels,
            num_layers=num_layers,
            growth_factor=growth_factor,
            activation=activation,
            normalization=normalization,
        )
        decoder_channels = tuple(encoder_channels * (growth_factor**i) for i in range(num_layers - 1))
        decoder = UNetDecoder(
            input_spec=encoder.get_output_spec(),
            out_channels=decoder_channels,
            activation=activation,
            normalization=normalization,
        )
        head = ResizeHead(
            input_spec=decoder.get_output_spec(),
            num_classes=num_classes,
            dropout_rate=dropout_rate,
            output_name=output_name,
        )
        super().__init__(encoder, decoder, head)
        self.num_classes = num_classes
        self.encoder_channels = encoder_channels
        self.num_layers = num_layers
        self.growth_factor = growth_factor
        self.activation = activation
        self.normalization = normalization
        self.dropout_rate = dropout_rate
        self.output_name = output_name

    def decoder_channels(self) -> Tuple[int, ...]:
        return self.decoder.out_channels
