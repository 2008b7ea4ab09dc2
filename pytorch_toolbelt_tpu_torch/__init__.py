"""pytorch-toolbelt-tpu-torch: the PyTorch/CUDA port of ``pytorch_toolbelt_tpu``.

It mirrors the JAX package's layout, so each module's counterpart sits at the
same path there.  Public tensors are NCHW.  The TPU package's Pallas kernels
become CUDA kernels written for Hopper (``csrc/``), built by ``nvcc`` on
first use on a CUDA tensor; on CPU tensors every kernel wrapper runs its
plain PyTorch version.

  core/        model-building contracts, the deprecation helper
  nn/          building blocks (activations, normalization, resize, UNet block,
               depthwise-separable convs, ASPP, FPN fusion, global pools)
  zoo/         encoders, decoders (UNet, FPN, DeepLabV3/V3+, PPM, CAN, BiFPN), heads,
               models, flax weight bridge, fused UNet, int8 inference
  modules.py   nn + zoo in one namespace, as the reference's ``pytorch_toolbelt.modules``
  inference/   tiled huge-image inference with d4 TTA, ensembling, 3D tiles
  distributed/ process groups, the (data, spatial) mesh and DDP, strip-sharded tiled
               inference (config 5)
  losses/      segmentation and classification losses (Lovasz sorts on K4 / K5)
  ops/         the CUDA kernels' wrappers and their plain versions
  optimization/ param groups for one torch optimizer, learning-rate schedules
  datasets/    sample keys, collate, dataset wrappers, prefetch to the card
  utils/       checkpoints, seeding and RNG state, profiling, tensor / fs / name helpers,
               cost-balanced bucket assignment
  examples/    training a UNet on synthetic blobs, then tiled d4 inference
"""

__version__ = "0.1.0"

from . import core, datasets, distributed, inference, losses, nn, ops, optimization, utils, zoo

__all__ = [
    "core", "datasets", "distributed", "inference", "losses", "nn", "ops", "optimization", "utils", "zoo", "__version__",
]
