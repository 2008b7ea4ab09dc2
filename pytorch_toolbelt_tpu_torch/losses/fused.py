"""Analytic-gradient paths for the hot pointwise losses.

Counterpart of ``pytorch_toolbelt_tpu/losses/fused.py``.  Each
``jax.custom_vjp`` there becomes a ``torch.autograd.Function`` here with the
same hand-derived backward: the only tensors saved for backward are the
inputs, the forward is one read-and-reduce pass, and the backward recomputes
the cheap elementwise chain and writes the gradient in one pass.  autograd
would instead keep the softmax, one-hot and focal intermediates alive
between the two halves.  These are plain PyTorch: no TPU kernel stood
behind them.

The class axis is 1 (NCHW).

Gradients:

softmax focal:
    L = mean/sum over pixels of  pos * sum_c w_c pt_c^g bce_c,
    p = softmax(z), pt_c = p_c + t_c (1 - 2 p_c), bce_c = sigmoid-BCE(z_c, t_c)
    dL/dz_k = pos * [ u_k - p_k sum_c u_c + w_k pt_k^g (sigma(z_k) - t_k) ]
    with u_c = g w_c pt_c^(g-1) bce_c (1 - 2 t_c) p_c.

soft dice / jaccard (per-class scalars over batch and pixels):
    dice:    score_c = (2 I_c + s) / max(P_c + T_c + s, eps)
    jaccard: score_c = (I_c + s) / max(P_c + T_c - I_c + s, eps)
    dL/dp_i = a_c t_i + b_c, then the softmax VJP  dz = p (G - sum_c G_c p_c)
    (multiclass) or the sigmoid VJP  dz = G p (1 - p) (binary, multilabel).
    ``live`` zeroes the denominator branch where the eps clamp is active.
"""

from typing import Optional, Sequence

import torch

__all__ = [
    "fused_softmax_focal",
    "fused_multiclass_dice",
    "fused_sigmoid_dice",
    "fused_multiclass_jaccard",
    "fused_sigmoid_jaccard",
    "ENABLED",
]

# Set False to route every loss through the plain autograd path.
ENABLED = True


def _class_view(t: torch.Tensor, ndim: int) -> torch.Tensor:
    """[C] -> [1, C, 1, ...] broadcastable against an NCHW tensor of ``ndim`` dims."""
    return t.reshape([1, -1] + [1] * (ndim - 2))


def _is_target(z: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Boolean one-hot of integer labels ``y`` [B, *] along axis 1 of ``z``."""
    classes = torch.arange(z.shape[1], device=z.device)
    return _class_view(classes, z.ndim) == y.unsqueeze(1)


def _reduce_axes(z: torch.Tensor):
    return (0,) + tuple(range(2, z.ndim))


def _pow(x: torch.Tensor, e: float) -> torch.Tensor:
    if e == 1.0:
        return x
    if e == 2.0:
        return x * x
    return torch.pow(x, e)


# ---------------------------------------------------------------------------
# Softmax focal
# ---------------------------------------------------------------------------


def _focal_pieces(z, t, class_weights, ignore_index):
    z = z.float()
    ignore_mask = t == ignore_index
    pos = (~ignore_mask).float()
    is_t = _is_target(z, torch.where(ignore_mask, 0, t))
    p = torch.softmax(z, dim=1)
    base = z.clamp_min(0) + torch.log1p(torch.exp(-z.abs()))
    bce = torch.where(is_t, base - z, base)
    pt = torch.where(is_t, 1.0 - p, p)
    w = None
    if class_weights is not None:
        w = _class_view(torch.tensor(class_weights, dtype=torch.float32, device=z.device), z.ndim)
    return z, pos, is_t, p, bce, pt, w


class _SoftmaxFocal(torch.autograd.Function):
    @staticmethod
    def forward(ctx, output, target, gamma, class_weights, ignore_index, reduction):
        _, pos, _, _, bce, pt, w = _focal_pieces(output, target, class_weights, ignore_index)
        loss = _pow(pt, gamma) * bce
        if w is not None:
            loss = loss * w
        loss = loss.sum(dim=1) * pos
        ctx.save_for_backward(output, target)
        ctx.args = (gamma, class_weights, ignore_index, reduction)
        return loss.mean() if reduction == "mean" else loss.sum()

    @staticmethod
    def backward(ctx, g):
        output, target = ctx.saved_tensors
        gamma, class_weights, ignore_index, reduction = ctx.args
        z, pos, is_t, p, bce, pt, w = _focal_pieces(output, target, class_weights, ignore_index)
        u_mag = gamma * _pow(pt, gamma - 1.0) * bce * p
        u = torch.where(is_t, -u_mag, u_mag)  # (1 - 2 t) sign flip
        sig = torch.sigmoid(z)
        tail = _pow(pt, gamma) * torch.where(is_t, sig - 1.0, sig)
        if w is not None:
            u = u * w
            tail = tail * w
        grad = (u - p * u.sum(dim=1, keepdim=True) + tail) * pos.unsqueeze(1)
        scale = g / pos.numel() if reduction == "mean" else g
        return (grad * scale).to(output.dtype), None, None, None, None, None


def fused_softmax_focal(output, target, gamma: float, class_weights: Optional[Sequence[float]], ignore_index: int,
                        reduction: str):
    """softmax_focal_loss_with_logits for normalized=False,
    reduced_threshold=None and reduction 'mean' or 'sum'.  ``output``
    [B, C, *] logits, ``target`` [B, *] integer labels."""
    return _SoftmaxFocal.apply(output, target, gamma, class_weights, ignore_index, reduction)


# ---------------------------------------------------------------------------
# Soft dice / jaccard
# ---------------------------------------------------------------------------


def _iou_epilogue(kind, intersection, p_sum, t_sum, smooth, eps, log_loss, classes):
    if kind == "dice":
        num = 2.0 * intersection + smooth
        den_raw = p_sum + t_sum + smooth
    else:
        num = intersection + smooth
        den_raw = p_sum + t_sum - intersection + smooth
    d = den_raw.clamp_min(eps)
    scores = num / d
    loss = -torch.log(scores.clamp_min(eps)) if log_loss else 1.0 - scores
    loss = loss * (t_sum > 0)
    if classes is not None:
        loss = loss[list(classes)]
    return loss.mean(), scores, d, den_raw, num


def _iou_gp(kind, scores, d, den_raw, num, t_sum, eps, log_loss, classes):
    """(a, b) per class: dL/dp_i = a t_i + b."""
    num_classes = scores.shape[0]
    if classes is not None:
        dloss = torch.zeros(num_classes, dtype=torch.float32, device=scores.device)
        dloss[list(classes)] = 1.0 / len(classes)
    else:
        dloss = torch.full((num_classes,), 1.0 / num_classes, dtype=torch.float32, device=scores.device)
    dloss = dloss * (t_sum > 0)
    if log_loss:
        dscore = dloss * (-1.0 / scores.clamp_min(eps)) * (scores > eps)
    else:
        dscore = -dloss
    live = (den_raw > eps).float()
    b = -dscore * num / (d * d) * live
    if kind == "dice":
        a = dscore * 2.0 / d
    else:
        a = dscore * (1.0 / d + num / (d * d) * live)
    return a, b


def _softmax_iou_pieces(z, y, ignore_index):
    """Multiclass: softmax probabilities and one-hot reductions without an
    f32 one-hot (boolean compare, already false on ignored pixels)."""
    z = z.float()
    is_t = _is_target(z, y)
    p_sm = torch.softmax(z, dim=1)
    m = None
    p = p_sm
    if ignore_index is not None:
        valid = y != ignore_index
        is_t = is_t & valid.unsqueeze(1)
        m = valid.float().unsqueeze(1)
        p = p_sm * m
    axes = _reduce_axes(z)
    intersection = torch.where(is_t, p, 0.0).sum(axes)
    p_sum = p.sum(axes)
    t_sum = is_t.float().sum(axes)
    return p_sm, is_t, m, intersection, p_sum, t_sum


class _SoftmaxIoU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y_pred, y_true, kind, smooth, eps, log_loss, ignore_index, classes):
        _, _, _, intersection, p_sum, t_sum = _softmax_iou_pieces(y_pred, y_true, ignore_index)
        loss, _, _, _, _ = _iou_epilogue(kind, intersection, p_sum, t_sum, smooth, eps, log_loss, classes)
        ctx.save_for_backward(y_pred, y_true)
        ctx.args = (kind, smooth, eps, log_loss, ignore_index, classes)
        return loss

    @staticmethod
    def backward(ctx, g):
        y_pred, y_true = ctx.saved_tensors
        kind, smooth, eps, log_loss, ignore_index, classes = ctx.args
        p_sm, is_t, m, intersection, p_sum, t_sum = _softmax_iou_pieces(y_pred, y_true, ignore_index)
        _, scores, d, den_raw, num = _iou_epilogue(kind, intersection, p_sum, t_sum, smooth, eps, log_loss, classes)
        a, b = _iou_gp(kind, scores, d, den_raw, num, t_sum, eps, log_loss, classes)
        a, b = _class_view(a, y_pred.ndim), _class_view(b, y_pred.ndim)
        gp = torch.where(is_t, a + b, b)
        if m is not None:
            gp = gp * m
        grad = p_sm * (gp - (gp * p_sm).sum(dim=1, keepdim=True))  # softmax VJP
        return (grad * g).to(y_pred.dtype), None, None, None, None, None, None, None


def _sigmoid_iou_pieces(z, t, ignore_index):
    """[B, C, *] logits and same-shape float targets -> [B, C, N] sigmoid
    probabilities and per-class reductions, with ``ignore_index`` masking
    both p and t after the sigmoid."""
    bs, c = z.shape[:2]
    z = z.float().reshape(bs, c, -1)
    t = t.float().reshape(z.shape)
    valid = None if ignore_index is None else (t != ignore_index).float()
    p = torch.sigmoid(z)
    p_eff = p if valid is None else p * valid
    t_eff = t if valid is None else t * valid
    intersection = (p_eff * t_eff).sum((0, 2))
    p_sum = p_eff.sum((0, 2))
    t_sum = t_eff.sum((0, 2))
    return p, valid, t_eff, intersection, p_sum, t_sum


class _SigmoidIoU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y_pred, y_true, kind, smooth, eps, log_loss, ignore_index, classes):
        _, _, _, intersection, p_sum, t_sum = _sigmoid_iou_pieces(y_pred, y_true, ignore_index)
        loss, _, _, _, _ = _iou_epilogue(kind, intersection, p_sum, t_sum, smooth, eps, log_loss, classes)
        ctx.save_for_backward(y_pred, y_true)
        ctx.args = (kind, smooth, eps, log_loss, ignore_index, classes)
        return loss

    @staticmethod
    def backward(ctx, g):
        y_pred, y_true = ctx.saved_tensors
        kind, smooth, eps, log_loss, ignore_index, classes = ctx.args
        p, valid, t_eff, intersection, p_sum, t_sum = _sigmoid_iou_pieces(y_pred, y_true, ignore_index)
        _, scores, d, den_raw, num = _iou_epilogue(kind, intersection, p_sum, t_sum, smooth, eps, log_loss, classes)
        a, b = _iou_gp(kind, scores, d, den_raw, num, t_sum, eps, log_loss, classes)
        gp = a[:, None] * t_eff + b[:, None]
        if valid is not None:
            gp = gp * valid
        grad = (gp * p * (1.0 - p) * g).reshape(y_pred.shape)
        return grad.to(y_pred.dtype), None, None, None, None, None, None, None


def fused_multiclass_dice(y_pred, y_true, smooth: float, eps: float, log_loss: bool, ignore_index, classes):
    """DiceLoss(mode='multiclass', from_logits=True): [B, C, *] logits, [B, *] labels."""
    return _SoftmaxIoU.apply(y_pred, y_true, "dice", smooth, eps, log_loss, ignore_index, classes)


def fused_multiclass_jaccard(y_pred, y_true, smooth: float, eps: float, log_loss: bool, classes):
    """JaccardLoss(mode='multiclass', from_logits=True); like the reference
    JaccardLoss it has no ignore_index."""
    return _SoftmaxIoU.apply(y_pred, y_true, "jaccard", smooth, eps, log_loss, None, classes)


def fused_sigmoid_dice(y_pred, y_true, smooth: float, eps: float, log_loss: bool, ignore_index, classes):
    """DiceLoss(mode='binary'|'multilabel', from_logits=True): [B, C, *]
    logits and targets (binary callers pass C = 1)."""
    return _SigmoidIoU.apply(y_pred, y_true, "dice", smooth, eps, log_loss, ignore_index, classes)


def fused_sigmoid_jaccard(y_pred, y_true, smooth: float, eps: float, log_loss: bool, ignore_index, classes):
    """JaccardLoss(mode='binary'|'multilabel', from_logits=True)."""
    return _SigmoidIoU.apply(y_pred, y_true, "jaccard", smooth, eps, log_loss, ignore_index, classes)
