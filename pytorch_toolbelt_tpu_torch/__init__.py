"""pytorch-toolbelt-tpu-torch: the PyTorch/CUDA port of ``pytorch_toolbelt_tpu``.

It mirrors the JAX package's layout, so each module's counterpart sits at the
same path there.  Public tensors are NCHW.  The TPU package's Pallas kernels
become CUDA kernels written for Hopper (``csrc/``), built by ``nvcc`` on
first use on a CUDA tensor; on CPU tensors every kernel wrapper runs its
plain PyTorch version.

  core/       model-building contracts
  nn/         building blocks (activations, normalization, resize, UNet block)
  zoo/        UNet encoder / decoder / head, models, flax weight bridge, fused UNet
  inference/  tiled huge-image inference with d4 TTA
  ops/        the CUDA kernels' wrappers and their plain versions
"""

__version__ = "0.1.0"

from . import core, inference, nn, ops, zoo

__all__ = ["core", "inference", "nn", "ops", "zoo", "__version__"]
