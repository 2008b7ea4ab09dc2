"""The program's ``seresnext50-fpn-int8``: ``EncoderDecoderModel`` of
``seresnext50_encoder()``, ``FPNDecoder(.., 128)`` and ``ResizeHead(.., 19)``
built on the device, the benchmark's seeded weights loaded by name, and
``quantize_encoder_decoder_inference`` with its defaults calibrated on the
benchmark's images."""

import torch


def float_model(cfg, device="cpu"):
    from pytorch_toolbelt_tpu_torch.zoo import EncoderDecoderModel, FPNDecoder, ResizeHead, seresnext50_encoder

    with torch.device(device):
        encoder = seresnext50_encoder()
        decoder = FPNDecoder(encoder.get_output_spec(), out_channels=cfg["fpn_channels"])
        head = ResizeHead(decoder.get_output_spec(), num_classes=cfg["num_classes"])
        return EncoderDecoderModel(encoder, decoder, head).eval()


def build(cfg, weights: dict, calibration_images: torch.Tensor, device):
    from pytorch_toolbelt_tpu_torch.zoo import quantize_encoder_decoder_inference

    model = float_model(cfg, device)
    model.load_state_dict(weights, strict=True)
    return quantize_encoder_decoder_inference(model, calibration_images)
