"""Inputs of a run, made from its ``--seed``: the user images of the traffic,
the calibration images of the configuration, and the user code that turns
a uint8 image into the model's float input.  Both the program and the
reference receive exactly these."""

import numpy as np
import torch

MEAN = (0.485, 0.456, 0.406)  # ImageNet statistics, as users of the pretrained encoders normalise
STD = (0.229, 0.224, 0.225)


def subseed(seed: int, tag: str) -> int:
    """A 63-bit seed for one purpose of a run, from any whole ``seed``."""
    words = [int(b) for b in tag.encode()]
    return int(np.random.SeedSequence([abs(int(seed)), int(seed < 0), *words]).generate_state(1, np.uint64)[0] >> 1)


_STATS = {}  # device -> (mean, std), made once: a tensor made from a list on the card waits for the card


def normalize(images: torch.Tensor) -> torch.Tensor:
    """[..., H, W, 3] uint8 -> [..., 3, H, W] float32, contiguous, on the
    images' device."""
    x = images.float().div_(255.0)
    if x.device not in _STATS:
        _STATS[x.device] = tuple(torch.tensor(v, dtype=torch.float32, device=x.device) for v in (MEAN, STD))
    mean, std = _STATS[x.device]
    return ((x - mean) / std).movedim(-1, -3).contiguous()


def _uint8_images(n: int, h: int, w: int, device, seed: int) -> torch.Tensor:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.randint(0, 256, (n, h, w, 3), generator=gen, device=device, dtype=torch.uint8)


def image_pool(traffic: dict, device, seed: int) -> list:
    """The traffic's distinct user images, [H, W, 3] uint8 on the host (pinned
    where the device is a card), drawn on the device in one call per size;
    request i is image ``i % len(pool)``.  Sizes cycle through
    ``traffic["image"]["sizes"]``."""
    spec = traffic["image"]
    sizes = [tuple(s) for s in spec["sizes"]]
    pool = [None] * spec["pool"]
    for k, (h, w) in enumerate(sizes):
        slots = list(range(k, spec["pool"], len(sizes)))
        images = _uint8_images(len(slots), h, w, device, subseed(seed, f"images{k}"))
        pinned = torch.device(device).type == "cuda"
        for slot, image in zip(slots, images):
            pool[slot] = torch.empty(image.shape, dtype=torch.uint8, pin_memory=pinned).copy_(image)
        del images
    return pool


def calibration_images(cfg: dict, device, seed: int) -> torch.Tensor:
    """[N, 3, S, S] float32 on the device: the configuration's seeded
    calibration batch, normalised as the traffic's images are."""
    cal = cfg["calibration"]
    return normalize(_uint8_images(cal["images"], cal["size"], cal["size"], device, seed))
