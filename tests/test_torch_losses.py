"""Parity of the port's losses (``pytorch_toolbelt_tpu_torch.losses``) with
the JAX package's, on the CPU: value and gradient.

Inputs are made with numpy from a seed and handed to both packages.  The
JAX losses take channels-last tensors and the port's take NCHW, so the tests
transpose on the way in and transpose the port's gradient back.  Each loss
is held at ``rtol=1e-5, atol=1e-6`` on its value and on its gradient
(``jax.value_and_grad`` against ``loss.backward()``), with the JAX package's
``fused.ENABLED`` left at True and the port's run both ways.  On the CPU the
port's Lovasz losses sort with ``torch.sort``; their CUDA sorts are tested in
``test_torch_cuda.py``.
"""

import contextlib
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_toolbelt_tpu import losses as J
from pytorch_toolbelt_tpu_torch import losses as T
from pytorch_toolbelt_tpu_torch.losses import fused as t_fused
from pytorch_toolbelt_tpu_torch.losses import lovasz as t_lovasz
from pytorch_toolbelt_tpu_torch.ops import sort_reference

RTOL, ATOL = 1e-5, 1e-6
B, C, H, W = 2, 5, 16, 16


def _nchw(a: np.ndarray) -> np.ndarray:
    """Channels-last [B, *spatial, C] -> [B, C, *spatial]."""
    return np.ascontiguousarray(np.moveaxis(a, -1, 1))


def _nhwc(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.moveaxis(a, 1, -1))


@contextlib.contextmanager
def _port_fused(enabled: bool):
    old = t_fused.ENABLED
    t_fused.ENABLED = enabled
    try:
        yield
    finally:
        t_fused.ENABLED = old


def _jax_value_and_grad(fn, x, *args):
    value, grad = jax.value_and_grad(lambda x_: fn(x_, *args))(jnp.asarray(x))
    return float(value), np.asarray(grad)


def _torch_value_and_grad(fn, x, *args):
    x = torch.from_numpy(np.array(x)).requires_grad_(True)
    value = fn(x, *args)
    value.backward()
    return float(value.detach()), x.grad.numpy()


def _assert_parity(j_fn, t_fn, x, j_args, t_args, channels_last=True):
    """``x`` is the JAX input; the port gets its NCHW form when ``channels_last``."""
    want_v, want_g = _jax_value_and_grad(j_fn, x, *(jnp.asarray(a) for a in j_args))
    x_t = _nchw(x) if channels_last else x
    got_v, got_g = _torch_value_and_grad(t_fn, x_t, *(torch.from_numpy(np.array(a)) for a in t_args))
    if channels_last:
        got_g = _nhwc(got_g)
    assert np.isfinite(want_v) and np.isfinite(got_v)
    np.testing.assert_allclose(got_v, want_v, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_g, want_g, rtol=RTOL, atol=ATOL)


def _rng(*key):
    return np.random.RandomState(zlib.crc32(repr(key).encode()))


def _softmax_np(x, axis=-1):
    e = np.exp(x - x.max(axis=axis, keepdims=True))
    return (e / e.sum(axis=axis, keepdims=True)).astype(np.float32)


def _labels(rng, num_classes, ignore=None, shape=(B, H, W)):
    y = rng.randint(0, num_classes, size=shape).astype(np.int32)
    if ignore is not None:
        y[rng.rand(*shape) < 0.1] = ignore
    return y


# ---------------------------------------------------------------------------
# Lovasz
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("classes", ["present", "all", (1, 3)], ids=["present", "all", "list"])
@pytest.mark.parametrize("ignore", [None, 255])
@pytest.mark.parametrize("per_image", [False, True])
def test_lovasz_softmax_matches_jax(per_image, ignore, classes):
    rng = _rng("lovasz", per_image, ignore, str(classes))
    probas = _softmax_np(rng.standard_normal((B, H, W, C)).astype(np.float32))
    labels = _labels(rng, C - 1, ignore)  # class C-1 absent: exercises 'present'
    j_loss = J.LovaszLoss(per_image=per_image, ignore=ignore, classes=classes)
    t_loss = T.LovaszLoss(per_image=per_image, ignore=ignore, classes=classes)
    _assert_parity(j_loss, t_loss, probas, [labels], [labels])


@pytest.mark.parametrize("ignore", [None, 255])
@pytest.mark.parametrize("per_image", [False, True])
def test_binary_lovasz_matches_jax(per_image, ignore):
    rng = _rng("binary_lovasz", per_image, ignore)
    logits = rng.standard_normal((B, H, W)).astype(np.float32)
    labels = _labels(rng, 2, ignore).astype(np.float32)
    j_loss = J.BinaryLovaszLoss(per_image=per_image, ignore_index=ignore)
    t_loss = T.BinaryLovaszLoss(per_image=per_image, ignore_index=ignore)
    _assert_parity(j_loss, t_loss, logits, [labels], [labels], channels_last=False)


class _SortInverseLovaszDot(t_lovasz._LovaszDot):
    """``_LovaszDot`` with the inverse permutation applied as the JAX package
    applies it: a second sort, keyed on the saved positions."""

    @staticmethod
    def backward(ctx, ct):
        perm, w_eff = ctx.saved_tensors
        _, w_unsorted = sort_reference(perm, w_eff)
        return ct[..., None] * w_unsorted, None, None


@pytest.mark.parametrize("per_image", [False, True])
@pytest.mark.parametrize("ignore", [None, 255])
@pytest.mark.parametrize("kind", ["softmax", "hinge"])
def test_lovasz_scatter_backward_equals_the_sort_inverse(kind, ignore, per_image, monkeypatch):
    """The backward's scatter moves the same values to the same pixels as a
    sort keyed on the permutation, so the gradients agree bit for bit."""
    rng = _rng("lovasz_scatter", kind, ignore, per_image)
    if kind == "softmax":
        x = _nchw(_softmax_np(rng.standard_normal((B, H, W, C)).astype(np.float32)))
        labels = torch.from_numpy(_labels(rng, C - 1, ignore))
        loss = T.LovaszLoss(per_image=per_image, ignore=ignore)
    else:
        x = rng.standard_normal((B, H, W)).astype(np.float32)
        labels = torch.from_numpy(_labels(rng, 2, ignore).astype(np.float32))
        loss = T.BinaryLovaszLoss(per_image=per_image, ignore_index=ignore)
    grads = []
    for dot in (t_lovasz._LovaszDot, _SortInverseLovaszDot):
        monkeypatch.setattr(t_lovasz, "_LovaszDot", dot)
        xt = torch.from_numpy(x).requires_grad_(True)
        loss(xt, labels).backward()
        grads.append(xt.grad)
    assert bool(grads[0].abs().sum() > 0)
    assert torch.equal(grads[0], grads[1])


# ---------------------------------------------------------------------------
# Dice, Jaccard, focal; the port with fused.ENABLED True and False
# ---------------------------------------------------------------------------

IOU_CASES = [
    ("binary", {}),
    ("binary", {"log_loss": True}),
    ("binary", {"from_logits": False}),
    ("binary", {"ignore_index": 255}),
    ("multilabel", {}),
    ("multilabel", {"log_loss": True, "smooth": 1.0}),
    ("multilabel", {"from_logits": False}),
    ("multilabel", {"ignore_index": 255}),
    ("multilabel", {"classes": (0, 2)}),
    ("multiclass", {}),
    ("multiclass", {"log_loss": True}),
    ("multiclass", {"from_logits": False}),
    ("multiclass", {"ignore_index": 255}),
    ("multiclass", {"classes": (1, 3), "smooth": 1.0}),
]


def _iou_inputs(mode, kwargs, rng):
    """Channels-last input and the targets for each package."""
    shape = (B, H, W, 1 if mode == "binary" else C)
    x = rng.standard_normal(shape).astype(np.float32)
    if not kwargs.get("from_logits", True):
        x = _softmax_np(x) if mode == "multiclass" else (1.0 / (1.0 + np.exp(-x))).astype(np.float32)
    ignore = kwargs.get("ignore_index")
    if mode == "multiclass":
        y = _labels(rng, C, ignore)
        return x, y, y
    y = (rng.rand(*shape) > 0.5).astype(np.float32)
    if ignore is not None:
        y[rng.rand(*shape) < 0.1] = ignore
    return x, y, _nchw(y)


# JaccardLoss has no ignore_index, as in the reference
IOU_PARAMS = [(case, name) for case in range(len(IOU_CASES)) for name in ("DiceLoss", "JaccardLoss")
              if not (name == "JaccardLoss" and "ignore_index" in IOU_CASES[case][1])]


@pytest.mark.parametrize("enabled", [True, False], ids=["fused", "autograd"])
@pytest.mark.parametrize("case,loss_name", IOU_PARAMS)
def test_dice_and_jaccard_match_jax(case, loss_name, enabled):
    mode, kwargs = IOU_CASES[case]
    x, y_j, y_t = _iou_inputs(mode, kwargs, _rng("iou", case))
    j_loss = getattr(J, loss_name)(mode=mode, **kwargs)
    t_loss = getattr(T, loss_name)(mode=mode, **kwargs)
    with _port_fused(enabled):
        _assert_parity(j_loss, t_loss, x, [y_j], [y_t])


BINARY_FOCAL_CASES = [
    {},
    {"alpha": 0.25},
    {"gamma": 1.5, "reduction": "sum"},
    {"normalized": True},
    {"reduced_threshold": 0.5},
    {"class_weights": (0.5, 1.0, 2.0, 1.5, 0.25)},
    {"ignore_index": 255},
    {"ignore_index": 255, "normalized": True, "alpha": 0.5},
]


@pytest.mark.parametrize("enabled", [True, False], ids=["fused", "autograd"])
@pytest.mark.parametrize("case", range(len(BINARY_FOCAL_CASES)))
def test_binary_focal_matches_jax(case, enabled):
    kwargs = BINARY_FOCAL_CASES[case]
    rng = _rng("binary_focal", case)
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    if "ignore_index" in kwargs:  # integer labels, one-hot encoded by the loss
        y_j = y_t = _labels(rng, C, kwargs["ignore_index"])
    else:
        y_j = (rng.rand(B, H, W, C) > 0.5).astype(np.float32)
        y_t = _nchw(y_j)
    with _port_fused(enabled):
        _assert_parity(J.BinaryFocalLoss(**kwargs), T.BinaryFocalLoss(**kwargs), x, [y_j], [y_t])


CE_FOCAL_CASES = [
    {},
    {"gamma": 1.5},
    {"gamma": 1.0, "reduction": "sum"},
    {"normalized": True},
    {"reduced_threshold": 0.5},
    {"class_weights": (0.5, 1.0, 2.0, 1.5, 0.25)},
    {"ignore_index": 255},
    {"ignore_index": 255, "class_weights": (1.0, 2.0, 1.0, 0.5, 1.0), "gamma": 3.0},
]


@pytest.mark.parametrize("enabled", [True, False], ids=["fused", "autograd"])
@pytest.mark.parametrize("case", range(len(CE_FOCAL_CASES)))
def test_cross_entropy_focal_matches_jax(case, enabled):
    kwargs = CE_FOCAL_CASES[case]
    rng = _rng("ce_focal", case)
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    y = _labels(rng, C, kwargs.get("ignore_index"))
    with _port_fused(enabled):
        _assert_parity(J.CrossEntropyFocalLoss(**kwargs), T.CrossEntropyFocalLoss(**kwargs), x, [y], [y])


def test_focal_loss_alias_warns_and_matches():
    with pytest.warns(DeprecationWarning):
        loss = T.FocalLoss(gamma=1.5)
    assert isinstance(loss, T.CrossEntropyFocalLoss) and loss.gamma == 1.5


# ---------------------------------------------------------------------------
# The rest: simple losses, functional, joint, bi-tempered
# ---------------------------------------------------------------------------


def _simple_cases():
    """(id, JAX loss, port loss, make(rng) -> (x, j_targets, t_targets, channels_last))."""
    def bce_inputs(rng):
        x = rng.standard_normal((B, H, W, C)).astype(np.float32)
        y = (rng.rand(B, H, W, C) > 0.5).astype(np.float32)
        y[rng.rand(B, H, W, C) < 0.1] = -100
        return x, y, _nchw(y), True

    def ce_inputs(rng):
        x = rng.standard_normal((B, H, W, C)).astype(np.float32)
        y = _labels(rng, C, -100)
        return x, y, y, True

    def flat_bce(rng):
        x = rng.standard_normal((B, 37)).astype(np.float32)
        y = (rng.rand(B, 37) > 0.5).astype(np.float32)
        return x, y, y, False

    def flat_bce_c(rng):
        """[B, N, C] logits: pos_weight broadcasts on the last axis in both packages."""
        x = rng.standard_normal((B, 11, C)).astype(np.float32)
        y = (rng.rand(B, 11, C) > 0.5).astype(np.float32)
        return x, y, y, False

    def classify(rng):
        x = rng.standard_normal((8, C)).astype(np.float32)
        y = rng.randint(0, C, size=8).astype(np.int32)
        y[2] = 255
        return x, y, y, False

    def classify_valid(rng):
        x, y, _, _ = classify(rng)
        y[2] = 1
        return x, y, y, False

    def regression(rng):
        x = (3 * rng.standard_normal((B, 17))).astype(np.float32)
        y = (3 * rng.standard_normal((B, 17))).astype(np.float32)
        return x, y, y, False

    def quality(rng):
        x = rng.standard_normal((B, 23)).astype(np.float32)
        y = rng.rand(B, 23).astype(np.float32)
        return x, y, y, False

    def binary_ignored(rng):
        x = rng.standard_normal((B, H, W)).astype(np.float32)
        y = (rng.rand(B, H, W) > 0.5).astype(np.float32)
        y[rng.rand(B, H, W) < 0.1] = 255
        return x, y, y, False

    pos_weight = (1.0, 2.0, 0.5, 1.0, 3.0)
    return [
        ("soft_bce", J.SoftBCEWithLogitsLoss(), T.SoftBCEWithLogitsLoss(), bce_inputs),
        ("soft_bce_smooth", J.SoftBCEWithLogitsLoss(smooth_factor=0.1), T.SoftBCEWithLogitsLoss(smooth_factor=0.1),
         bce_inputs),
        ("soft_bce_pos_weight", J.SoftBCEWithLogitsLoss(pos_weight=pos_weight, ignore_index=None, reduction="sum"),
         T.SoftBCEWithLogitsLoss(pos_weight=pos_weight, ignore_index=None, reduction="sum"), flat_bce_c),
        ("soft_ce", J.SoftCrossEntropyLoss(), T.SoftCrossEntropyLoss(), ce_inputs),
        ("soft_ce_smooth", J.SoftCrossEntropyLoss(smooth_factor=0.1, reduction="sum"),
         T.SoftCrossEntropyLoss(smooth_factor=0.1, reduction="sum"), ce_inputs),
        ("balanced_bce", J.BalancedBCEWithLogitsLoss(gamma=2.0), T.BalancedBCEWithLogitsLoss(gamma=2.0), flat_bce),
        ("binary_soft_f1", J.BinarySoftF1Loss(), T.BinarySoftF1Loss(), flat_bce),
        ("binary_soft_f1_ignore", J.BinarySoftF1Loss(ignore_index=255), T.BinarySoftF1Loss(ignore_index=255),
         binary_ignored),
        ("soft_f1", J.SoftF1Loss(), T.SoftF1Loss(), classify_valid),
        ("soft_f1_ignore", J.SoftF1Loss(ignore_index=255), T.SoftF1Loss(ignore_index=255), classify),
        ("wing", J.WingLoss(), T.WingLoss(), regression),
        ("wing_sum", J.WingLoss(width=2.0, curvature=1.0, reduction="sum"),
         T.WingLoss(width=2.0, curvature=1.0, reduction="sum"), regression),
        ("log_cosh", J.LogCoshLoss(), T.LogCoshLoss(), regression),
        ("focal_cosine", J.FocalCosineLoss(), T.FocalCosineLoss(), classify_valid),
        ("quality_focal", J.QualityFocalLoss(), T.QualityFocalLoss(), quality),
        ("quality_focal_normalized", J.QualityFocalLoss(reduction="normalized"),
         T.QualityFocalLoss(reduction="normalized"), quality),
    ]


SIMPLE_CASES = _simple_cases()


@pytest.mark.parametrize("case", range(len(SIMPLE_CASES)), ids=[c[0] for c in SIMPLE_CASES])
def test_simple_losses_match_jax(case):
    name, j_loss, t_loss, make = SIMPLE_CASES[case]
    x, y_j, y_t, channels_last = make(_rng("simple", name))
    _assert_parity(j_loss, t_loss, x, [y_j], [y_t], channels_last=channels_last)


def _functional_cases():
    """(id, JAX fn, port fn, channels_last) over (x, y) made by _functional_inputs."""
    from pytorch_toolbelt_tpu.losses import functional as JF
    from pytorch_toolbelt_tpu_torch.losses import functional as TF

    return [
        ("bce", lambda x, y: JF.binary_cross_entropy_with_logits(x, y).mean(),
         lambda x, y: TF.binary_cross_entropy_with_logits(x, y).mean(), True),
        ("focal_sigmoid", lambda x, y: JF.focal_loss_with_logits(x, y, reduction="sum"),
         lambda x, y: TF.focal_loss_with_logits(x, y, reduction="sum"), True),
        ("focal_softmax_all", lambda x, y: JF.focal_loss_with_logits(x, y, activation="softmax"),
         lambda x, y: TF.focal_loss_with_logits(x, y, activation="softmax"), True),
        ("focal_softmax_axis", lambda x, y: JF.focal_loss_with_logits(x, y, activation="softmax", softmax_axis=-1),
         lambda x, y: TF.focal_loss_with_logits(x, y, activation="softmax", softmax_axis=1), True),
        ("soft_dice", lambda x, y: JF.soft_dice_score(jax.nn.sigmoid(x), y, 1.0, dims=(0, 1, 2)).sum(),
         lambda x, y: TF.soft_dice_score(torch.sigmoid(x), y, 1.0, dims=(0, 2, 3)).sum(), True),
        ("soft_jaccard", lambda x, y: JF.soft_jaccard_score(jax.nn.sigmoid(x), y),
         lambda x, y: TF.soft_jaccard_score(torch.sigmoid(x), y), True),
        ("label_smoothed_nll", lambda x, y: JF.label_smoothed_nll_loss(jax.nn.log_softmax(x), (y[..., 0] > 0.5).astype(jnp.int32), 0.2),
         lambda x, y: TF.label_smoothed_nll_loss(torch.log_softmax(x, 1), (y[:, 0] > 0.5).long(), 0.2, axis=1), True),
        ("soft_micro_f1", lambda x, y: JF.soft_micro_f1(jax.nn.sigmoid(x.reshape(-1, C)), y.reshape(-1, C)),
         lambda x, y: TF.soft_micro_f1(torch.sigmoid(x.reshape(-1, C)), y.reshape(-1, C)), False),
        ("batchwise_mean", lambda x, y: JF.reduce_loss(JF.wing_loss(x, y, reduction="none"), "batchwise_mean").sum(),
         lambda x, y: TF.reduce_loss(TF.wing_loss(x, y, reduction="none"), "batchwise_mean").sum(), False),
    ]


FUNCTIONAL_CASES = _functional_cases()


@pytest.mark.parametrize("case", range(len(FUNCTIONAL_CASES)), ids=[c[0] for c in FUNCTIONAL_CASES])
def test_functional_matches_jax(case):
    name, j_fn, t_fn, channels_last = FUNCTIONAL_CASES[case]
    rng = _rng("functional", name)
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    y = (rng.rand(B, H, W, C) > 0.5).astype(np.float32)
    _assert_parity(j_fn, t_fn, x, [y], [_nchw(y) if channels_last else y], channels_last=channels_last)


def test_joint_weighted_and_sum_of_losses_match_jax():
    rng = _rng("joint")
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    y = _labels(rng, C, 255)
    j_loss = J.JointLoss(J.DiceLoss(mode="multiclass", ignore_index=255),
                         J.WeightedLoss(J.CrossEntropyFocalLoss(ignore_index=255), 0.3), 1.0, 0.5)
    t_loss = T.JointLoss(T.DiceLoss(mode="multiclass", ignore_index=255),
                         T.WeightedLoss(T.CrossEntropyFocalLoss(ignore_index=255), 0.3), 1.0, 0.5)
    _assert_parity(j_loss, t_loss, x, [y], [y])
    j_sum = J.sum_of_losses([J.JaccardLoss(mode="multiclass"), J.CrossEntropyFocalLoss()], [0.7, 1.3])
    t_sum = T.sum_of_losses([T.JaccardLoss(mode="multiclass"), T.CrossEntropyFocalLoss()], [0.7, 1.3])
    _assert_parity(j_sum, t_sum, x, [y], [y])
    with pytest.raises(ValueError):
        T.sum_of_losses([T.LogCoshLoss()], [1.0, 2.0])


# (t1, t2, smoothing, ignore_index): t2 >= t1, away from the F2 case
BITEMPERED_CASES = [(1.0, 1.0, 0.0, None), (0.8, 1.2, 0.0, None), (0.5, 0.8, 0.1, None), (0.7, 1.5, 0.0, 255)]


@pytest.mark.parametrize("t1,t2,smoothing,ignore", BITEMPERED_CASES)
def test_bitempered_matches_jax(t1, t2, smoothing, ignore):
    rng = _rng("bitempered", t1, t2)
    x = (2 * rng.standard_normal((B, 9, C))).astype(np.float32)  # classes last in both packages
    y = rng.randint(0, C, size=(B, 9)).astype(np.int32)
    if ignore is not None:
        y[0, 3] = ignore
    j_loss = J.BiTemperedLogisticLoss(t1, t2, smoothing=smoothing, ignore_index=ignore)
    t_loss = T.BiTemperedLogisticLoss(t1, t2, smoothing=smoothing, ignore_index=ignore)
    _assert_parity(j_loss, t_loss, x, [y], [y], channels_last=False)

    # the binary variant: [B, H, W, 1] in JAX, [B, 1, H, W] in the port
    xb = rng.standard_normal((B, 6, 7, 1)).astype(np.float32)
    yb = (rng.rand(B, 6, 7, 1) > 0.5).astype(np.float32)
    j_bin = J.BinaryBiTemperedLogisticLoss(t1, t2, smoothing=smoothing)
    t_bin = T.BinaryBiTemperedLogisticLoss(t1, t2, smoothing=smoothing)
    _assert_parity(j_bin, t_bin, xb, [yb], [_nchw(yb)])

    # tempered_softmax through its own analytic backward
    weights = rng.standard_normal((B, 9, C)).astype(np.float32)
    _assert_parity(lambda a, w: (J.tempered_softmax(a, t2) * w).sum(),
                   lambda a, w: (T.tempered_softmax(a, t2) * w).sum(), x, [weights], [weights], channels_last=False)


def test_bitempered_gradient_finite_where_jax_is_nan():
    """F2: at t2 < t1 the JAX backward's p ** (t2 - t1) is inf where the
    tempered softmax is exactly 0, and the gradient of a zero-label class
    turns NaN.  The port's stays finite and equals JAX's where that is finite."""
    t1, t2 = 0.9, 0.5
    x = np.array([[10.0, -10.0, 0.0, -12.0], [0.5, 0.2, -0.3, 0.1], [-9.0, 9.0, -11.0, 8.0]], np.float32)
    y = np.array([0, 2, 1], np.int32)
    want_v, want_g = _jax_value_and_grad(J.BiTemperedLogisticLoss(t1, t2), x, jnp.asarray(y))
    got_v, got_g = _torch_value_and_grad(T.BiTemperedLogisticLoss(t1, t2), x, torch.from_numpy(y))
    assert np.isnan(want_g).any(), "the inputs no longer reach the F2 case"
    assert np.isfinite(got_g).all()
    np.testing.assert_allclose(got_v, want_v, rtol=RTOL, atol=ATOL)
    finite = np.isfinite(want_g).all(axis=-1)
    assert finite.any()
    np.testing.assert_allclose(got_g[finite], want_g[finite], rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# The slice as a whole
# ---------------------------------------------------------------------------


def test_joint_focal_lovasz_on_softmax_matches_jax():
    """JointLoss(CrossEntropyFocalLoss, LovaszLoss) on softmax probabilities,
    differentiated through the softmax to the logits: B=2, C=19, 32x32."""
    rng = _rng("slice")
    logits = rng.standard_normal((2, 32, 32, 19)).astype(np.float32)
    labels = _labels(rng, 19, 255, shape=(2, 32, 32))
    j_loss = J.JointLoss(J.CrossEntropyFocalLoss(ignore_index=255), J.LovaszLoss(ignore=255), 1.0, 0.5)
    t_loss = T.JointLoss(T.CrossEntropyFocalLoss(ignore_index=255), T.LovaszLoss(ignore=255), 1.0, 0.5)
    _assert_parity(lambda x, y: j_loss(jax.nn.softmax(x, axis=-1), y),
                   lambda x, y: t_loss(torch.softmax(x, dim=1), y), logits, [labels], [labels])


def test_port_losses_cover_the_jax_public_names():
    assert sorted(T.__all__) == sorted(J.__all__)
    for name in J.__all__:
        assert hasattr(T, name), name


def test_bce_gradient_is_right_at_a_zero_logit():
    """At a logit of exactly 0 the gradient of BCE-with-logits is
    sigmoid(0) - t = 0.5 - t.  The JAX function's max/abs form gives -t there
    (jnp.maximum'(0) = 0.5, jnp.abs'(0) = 1); the port's gives 0.5 - t, as
    torch's own BCE does, and so do the focal losses built on it."""
    from pytorch_toolbelt_tpu.losses import functional as JF
    from pytorch_toolbelt_tpu_torch.losses import functional as TF

    t = np.array([0.0, 1.0, 0.0, 1.0], np.float32)
    x = np.array([0.0, 0.0, 1.5, -2.0], np.float32)
    _, j_grad = _jax_value_and_grad(lambda a, b: JF.binary_cross_entropy_with_logits(a, b).sum(), x, jnp.asarray(t))
    _, t_grad = _torch_value_and_grad(lambda a, b: TF.binary_cross_entropy_with_logits(a, b).sum(), x,
                                      torch.from_numpy(t))
    want = 1.0 / (1.0 + np.exp(-x)) - t
    np.testing.assert_allclose(t_grad, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(j_grad[2:], want[2:], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(j_grad[:2], -t[:2])  # the JAX package's value at exactly 0

    xs = torch.tensor([[0.0, 0.3], [-0.7, 0.0]]).requires_grad_(True)
    ts = torch.tensor([[0.0, 1.0], [1.0, 1.0]])
    T.BinaryFocalLoss(alpha=0.25)(xs, ts).backward()
    xr = xs.detach().clone().requires_grad_(True)
    p = torch.sigmoid(xr)
    pt = p * ts + (1 - p) * (1 - ts)
    ce = torch.nn.functional.binary_cross_entropy_with_logits(xr, ts, reduction="none")
    ((1 - pt) ** 2 * ce * (0.25 * ts + 0.75 * (1 - ts))).mean().backward()
    torch.testing.assert_close(xs.grad, xr.grad, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("loss_name", ["DiceLoss", "JaccardLoss"])
def test_iou_losses_reject_bad_modes(loss_name):
    with pytest.raises(ValueError):
        getattr(T, loss_name)(mode="softmax")
    with pytest.raises(ValueError):
        getattr(T, loss_name)(mode="binary", classes=(0,))
