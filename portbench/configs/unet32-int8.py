"""The program's ``unet32-int8``: ``UNetSegmentationModel`` built on the
device, the benchmark's seeded weights loaded by name, and
``quantize_unet_inference`` calibrated on the benchmark's images."""

import torch


def float_model(cfg, device="cpu"):
    from pytorch_toolbelt_tpu_torch.zoo import UNetSegmentationModel

    with torch.device(device):
        return UNetSegmentationModel(num_classes=cfg["num_classes"], encoder_channels=cfg["encoder_channels"],
                                     num_layers=cfg["num_layers"], growth_factor=cfg["growth_factor"],
                                     in_channels=cfg["in_channels"]).eval()


def build(cfg, weights: dict, calibration_images: torch.Tensor, device):
    from pytorch_toolbelt_tpu_torch.zoo import quantize_unet_inference

    model = float_model(cfg, device)
    model.load_state_dict(weights, strict=True)
    return quantize_unet_inference(model, calibration_images)
