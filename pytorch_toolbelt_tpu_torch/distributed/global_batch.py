"""The global batch under data parallelism: BatchNorm statistics and
whole-batch gathers over the data group.

Under ``jit`` over a batch-sharded mesh, the JAX package's BatchNorm
statistics and its losses run over the *global* batch.  DDP runs each rank
on its own part, so:

* :class:`SyncBatchNorm2d` all-reduces the per-channel sum, sum of squares
  and count over the group in training mode, with autograd through the
  all-reduce, so that the input gradients come from the global statistics;
  it updates the running variance with the biased global variance, as flax
  and the port's ``BatchNorm2d`` do (torch's ``nn.SyncBatchNorm`` uses the
  unbiased one, and raises on CPU tensors).  It runs on gloo and on nccl;
* :func:`gather_batch` concatenates every rank's part along dim 0, with a
  backward that all-reduces the gradient and keeps this rank's slice, so
  that a loss that does not decompose over ranks (batch-reduced dice,
  Lovasz with ``per_image=False``) runs on the global batch.  Every rank then
  computes the same loss, and DDP's mean over ranks of its gradients is the
  global loss's gradient.
"""

from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

from ..nn.normalization import BatchNorm2d

__all__ = ["SyncBatchNorm2d", "convert_sync_batchnorm", "gather_batch"]


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def _group_size(group) -> int:
    return dist.get_world_size(group) if _initialized() else 1


class _AllReduceSum(torch.autograd.Function):
    """The sum over the group; its gradient is the sum of the ranks'
    gradients (every rank's output is the same sum)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _GatherBatch(torch.autograd.Function):
    """Every rank's [n, ...] part concatenated along dim 0 in rank order; the
    gradient of this rank's part is its slice of the all-reduced gradient
    (gloo has no reduce-scatter)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group, ctx.n = group, x.shape[0]
        ctx.rank = dist.get_rank(group)
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=0)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad[ctx.rank * ctx.n:(ctx.rank + 1) * ctx.n], None


def gather_batch(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's part of the batch (equal sizes), concatenated along dim
    0 in rank order, over ``group`` (the default group if None); ``x`` as
    it is without a group of more than one process.  Differentiable for
    float tensors."""
    if _group_size(group) == 1:
        return x
    if x.is_floating_point() and x.requires_grad:
        return _GatherBatch.apply(x, group)
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=0)


class SyncBatchNorm2d(BatchNorm2d):
    """The port's ``BatchNorm2d`` with its training-mode statistics taken
    over ``process_group`` (the default group if None): mean and biased
    variance from the all-reduced per-channel sum, sum of squares and count,
    in float32.  Without an initialized process group, or in eval mode, it
    is ``BatchNorm2d``."""

    def __init__(self, *args, process_group=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.process_group = process_group

    def _check_input_dim(self, x: torch.Tensor) -> None:
        if x.dim() < 2:
            raise ValueError(f"expected at least a 2-D input (got {x.dim()}-D)")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or not _initialized():
            return super().forward(x)
        self._check_input_dim(x)
        dims = [0] + list(range(2, x.dim()))
        shape = [1, -1] + [1] * (x.dim() - 2)
        xf = x.float()
        local = torch.cat([xf.sum(dims), (xf * xf).sum(dims),
                           torch.full((1,), x.numel() // x.shape[1], dtype=torch.float32, device=x.device)])
        total = _AllReduceSum.apply(local, self.process_group)
        c = x.shape[1]
        n = total[2 * c]
        mean = total[:c] / n
        var = torch.clamp(total[c:2 * c] / n - mean * mean, min=0.0)
        scale = torch.rsqrt(var + self.eps)
        if self.weight is not None:
            scale = scale * self.weight
        shift = -mean * scale
        if self.bias is not None:
            shift = shift + self.bias
        y = (xf * scale.reshape(shape) + shift.reshape(shape)).to(x.dtype)
        if self.track_running_stats and self.running_mean is not None:
            with torch.no_grad():
                self.num_batches_tracked.add_(1)
                m = self.momentum if self.momentum is not None else 1.0 / float(self.num_batches_tracked)
                self.running_mean.mul_(1.0 - m).add_(mean.detach().to(self.running_mean.dtype), alpha=m)
                self.running_var.mul_(1.0 - m).add_(var.detach().to(self.running_var.dtype), alpha=m)
        return y


def convert_sync_batchnorm(module: nn.Module, process_group=None) -> nn.Module:
    """``module`` with every batch norm (torch's or the port's, any number
    of dims) replaced by a :class:`SyncBatchNorm2d` over ``process_group``
    that holds the same parameters and running statistics; the module
    itself is changed in place where it is not a batch norm."""
    if isinstance(module, nn.modules.batchnorm._BatchNorm) and not isinstance(module, SyncBatchNorm2d):
        converted = SyncBatchNorm2d(module.num_features, module.eps, module.momentum, module.affine,
                                    module.track_running_stats, process_group=process_group)
        if module.affine:
            converted.weight, converted.bias = module.weight, module.bias
        if module.track_running_stats:
            converted.running_mean, converted.running_var = module.running_mean, module.running_var
            converted.num_batches_tracked = module.num_batches_tracked
        converted.train(module.training)
        return converted
    for name, child in module.named_children():
        new = convert_sync_batchnorm(child, process_group)
        if new is not child:
            setattr(module, name, new)
    return module
