"""End-to-end segmentation training example (counterpart of
``examples/train_segmentation.py``, the JAX package's).

Trains the UNet on synthetic blobs with dice + focal, param groups without
weight decay on biases and norms, the mesh's data parallelism (DDP once a
process group is initialized) and batches prefetched to the card; then runs
tiled d4-TTA inference on a larger synthetic image.  Past one process, the
BatchNorm statistics (``SyncBatchNorm2d``) and the loss
(:func:`global_batch_loss`) run over the global batch, as under the JAX
example's ``jit``.  As in the JAX example,
the optimizer's learning rate stays 1e-3 and the warmup-cosine schedule is
only printed.

Run: python -m pytorch_toolbelt_tpu_torch.examples.train_segmentation
(on the card; ``main(device="cpu")`` runs it on the CPU)
"""

from typing import Iterator, Tuple

import numpy as np
import torch

from .. import losses as L
from ..datasets import prefetch_to_device
from ..distributed import batch_sharding, data_parallel, gather_batch, make_mesh
from ..inference import tiled_apply
from ..inference.tta import d4_image2mask
from ..optimization import flat_cosine_annealing_schedule, gradual_warmup_schedule, make_optimizer
from ..utils import count_parameters, get_random_name, set_manual_seed
from ..zoo import UNetSegmentationModel

__all__ = ["global_batch_loss", "main", "synthetic_batch"]


def synthetic_batch(rng: np.random.RandomState, batch: int, size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Random blobs: image = noisy disks, mask = disk interiors.  The JAX
    example's draws, as NCHW float32 images and [B, H, W] int32 masks."""
    yy, xx = np.mgrid[:size, :size]
    images = np.zeros((batch, size, size, 3), np.float32)
    masks = np.zeros((batch, size, size), np.int32)
    for i in range(batch):
        cy, cx = rng.randint(size // 4, 3 * size // 4, size=2)
        r = rng.randint(size // 8, size // 4)
        disk = ((yy - cy) ** 2 + (xx - cx) ** 2) < r**2
        masks[i] = disk
        images[i] = disk[..., None] * 0.7 + rng.rand(size, size, 3) * 0.3
    return np.ascontiguousarray(images.transpose(0, 3, 1, 2)), masks


def global_batch_loss(loss_fn, logits: torch.Tensor, targets: torch.Tensor, group=None) -> torch.Tensor:
    """``loss_fn`` on every rank's logits and targets gathered over
    ``group`` (the default group if None, which is the mesh's data group:
    ``make_mesh`` keeps ``spatial_parallel`` at 1) by ``gather_batch``: the
    global batch's loss on every rank, whose gradients DDP's mean over ranks
    turns into the global loss's.  Without a group of more than one
    process, ``loss_fn(logits, targets)``."""
    return loss_fn(gather_batch(logits, group), gather_batch(targets, group))


def _batches(rng: np.random.RandomState, steps: int, batch: int, size: int) -> Iterator:
    for _ in range(steps):
        yield synthetic_batch(rng, batch, size)


def main(steps: int = 20, batch: int = 8, size: int = 128, device="cuda"):
    """Train for ``steps`` steps, then predict a (4 size)^2 image.  Returns
    {'losses': the printed steps' losses, 'prediction': [2, 4 size, 4 size]}."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("torch.cuda.is_available() is false; pass device='cpu' to run on the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    set_manual_seed(42)
    run_name = get_random_name()
    print(f"run: {run_name}, devices: [{device}]")

    model = UNetSegmentationModel(num_classes=2, encoder_channels=16, num_layers=3).to(device)
    print("parameters:", count_parameters(model, human_friendly=True)["total"])

    schedule = gradual_warmup_schedule(
        1e-3, multiplier=1.0, total_epoch=5,
        after_schedule=flat_cosine_annealing_schedule(1e-3, t_max=steps, t_flat=steps // 2),
    )
    optimizer = make_optimizer(
        model,
        learning_rate=1e-3,
        weight_decay=1e-4,
        optimizer_factory=torch.optim.AdamW,
        apply_weight_decay_on_norm=False,
        apply_weight_decay_on_bias=False,
        betas=(0.9, 0.999),
        eps=1e-8,
    )
    loss_fn = L.JointLoss(L.DiceLoss(mode="multiclass"), L.CrossEntropyFocalLoss(), 1.0, 0.5)

    mesh = make_mesh(device_type=device.type)
    net = data_parallel(model, mesh)
    net.train()
    losses = []
    batches = prefetch_to_device(_batches(np.random.RandomState(1), steps, batch, size),
                                 sharding=batch_sharding(mesh, 4), device=device)
    for i, (x, y) in enumerate(batches):
        loss = global_batch_loss(loss_fn, net(x), y)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        if i % 5 == 0 or i == steps - 1:
            losses.append(loss.item())
            print(f"step {i:3d}  lr {schedule(i):.2e}  loss {losses[-1]:.4f}")

    # inference: tiled + d4 TTA on a big synthetic image; the canvas scales
    # with the train tile, so size=32 stays a handful of tiles
    model.eval()
    big = size * 4
    big_image = torch.from_numpy(np.random.RandomState(7).rand(big, big, 3).astype(np.float32))
    big_image = big_image.permute(2, 0, 1).contiguous().to(device)
    with torch.no_grad():
        merged = tiled_apply(
            lambda t: d4_image2mask(model, t), big_image,
            tile_size=size, tile_step=size // 2, weight="pyramid", batch_size=4,
        )
    print("tiled d4-TTA prediction:", tuple(merged.shape), "finite:", bool(torch.isfinite(merged).all()))
    return {"losses": losses, "prediction": merged}


if __name__ == "__main__":
    main()
