"""Parity of the blocks of the port's CNN encoders (XResNet, Res2Net,
SKResNet, DenseNet, DPN, InceptionV4, WiderResNet) with the JAX package on
the CPU, in eval mode and in train mode, where the running statistics are
held to flax's within 1e-5.

The flax variables are seeded numpy values in the shapes of the flax init
and reach the torch modules through ``load_flax_variables``, as in
``test_torch_mobile_encoders.py``, whose helpers these tests share.
Stride-2 blocks run on even inputs, where flax ``SAME`` pads (0, 1), and on
odd ones, except XResNet's and Res2Net's: their average-pooled paths floor
an odd size where the strided convs round it up, in the JAX package too.

Tolerance: 1e-5 * max|ref| (``TOL``).
"""

import jax
import numpy as np
import pytest
import torch

from pytorch_toolbelt_tpu.zoo.encoders import densenet as jdensenet
from pytorch_toolbelt_tpu.zoo.encoders import dpn as jdpn
from pytorch_toolbelt_tpu.zoo.encoders import inception as jinception
from pytorch_toolbelt_tpu.zoo.encoders import res2net as jres2net
from pytorch_toolbelt_tpu.zoo.encoders import skresnet as jskresnet
from pytorch_toolbelt_tpu.zoo.encoders import wide_resnet as jwide
from pytorch_toolbelt_tpu.zoo.encoders import xresnet as jxresnet
from pytorch_toolbelt_tpu_torch.zoo import (
    DenseBlock,
    DenseLayer,
    DualPathBlock,
    IdentityResidualBlock,
    Res2NetBottleneck,
    SelectiveKernelConv,
    SKBasicBlock,
    SKBottleneck,
    Transition,
    XResNetBlock,
    load_flax_variables,
)
from pytorch_toolbelt_tpu_torch.zoo.encoders import inception as tinception
from test_torch_mobile_encoders import MODES, STATS_TOL, TOL, _close, _init, _input, _run


# (in, expansion, hidden, stride, se, size)
_XRESNET = {"basic-identity": (8, 1, 8, 1, False, 9), "basic-s2-se-even": (8, 1, 12, 2, True, 10),
            "bottleneck-s2-even": (8, 4, 4, 2, False, 10), "bottleneck-se-identity": (16, 4, 4, 1, True, 9)}


@MODES
@pytest.mark.parametrize("name", list(_XRESNET))
def test_xresnet_block_matches_flax(name, training):
    cin, e, hidden, stride, se, size = _XRESNET[name]
    x, tx = _input((2, size, size, cin), seed=1)
    jmod = jxresnet.XResNetBlock(expansion=e, n_hidden=hidden, stride=stride, use_se=se)
    got, want = _run(jmod, XResNetBlock(cin, e, hidden, stride, use_se=se), x, tx, training, seed=2)
    _close(got, want, TOL)


# (in, out, stride, scale, base_width, groups, size)
_RES2NET = {"identity": (64, 64, 1, 4, 26, 1, 9), "s2-even": (32, 64, 2, 4, 26, 1, 10),
            "grouped-scale3": (64, 64, 1, 3, 16, 2, 8)}


@MODES
@pytest.mark.parametrize("name", list(_RES2NET))
def test_res2net_bottleneck_matches_flax(name, training):
    cin, cout, stride, scale, bw, groups, size = _RES2NET[name]
    x, tx = _input((2, size, size, cin), seed=3)
    jmod = jres2net.Res2NetBottleneck(cout, stride=stride, scale=scale, base_width=bw, groups=groups)
    got, want = _run(jmod, Res2NetBottleneck(cin, cout, stride, scale, bw, groups), x, tx, training, seed=4)
    _close(got, want, TOL)


@MODES
@pytest.mark.parametrize("case", [(1, 1, 9), (2, 1, 10), (2, 2, 11)], ids=["s1", "s2-even", "s2-grouped-odd"])
def test_selective_kernel_conv_matches_flax(case, training):
    """Dilation 1 and 2 paths, the Dense squeeze and the softmax over paths."""
    stride, groups, size = case
    x, tx = _input((2, size, size, 8), seed=5)
    jmod = jskresnet.SelectiveKernelConv(16, stride=stride, groups=groups)
    got, want = _run(jmod, SelectiveKernelConv(8, 16, stride, groups=groups), x, tx, training, seed=6)
    _close(got, want, TOL)


# (bottleneck, in, out, stride, groups, base_width, size)
_SK_BLOCKS = {"basic-identity": (False, 8, 8, 1, 1, 64, 9), "basic-s2-odd": (False, 8, 16, 2, 1, 64, 11),
              "bottleneck-identity": (True, 16, 16, 1, 1, 64, 9),
              "bottleneck-grouped-s2-even": (True, 16, 32, 2, 2, 16, 10)}


@MODES
@pytest.mark.parametrize("name", list(_SK_BLOCKS))
def test_sk_blocks_match_flax(name, training):
    bottleneck, cin, cout, stride, groups, bw, size = _SK_BLOCKS[name]
    x, tx = _input((2, size, size, cin), seed=7)
    if bottleneck:
        jmod = jskresnet.SKBottleneck(cout, stride=stride, groups=groups, base_width=bw)
        tmod = SKBottleneck(cin, cout, stride, groups=groups, base_width=bw)
    else:
        jmod, tmod = jskresnet.SKBasicBlock(cout, stride=stride), SKBasicBlock(cin, cout, stride)
    got, want = _run(jmod, tmod, x, tx, training, seed=8)
    _close(got, want, TOL)


@MODES
@pytest.mark.parametrize("kind", ["layer", "block", "transition-even", "transition-odd"])
def test_dense_modules_match_flax(kind, training):
    size = 11 if kind == "transition-odd" else 10
    x, tx = _input((2, size, size, 12), seed=9)
    if kind == "layer":
        jmod, tmod = jdensenet.DenseLayer(4), DenseLayer(12, 4)
    elif kind == "block":
        jmod, tmod = jdensenet.DenseBlock(3, 4), DenseBlock(12, 3, 4)
    else:
        jmod, tmod = jdensenet.Transition(6), Transition(12, 6)
    got, want = _run(jmod, tmod, x, tx, training, seed=10)
    _close(got, want, TOL)


# (b_style, stride, is_first, tuple input, size): a: 8, b: 8, c: 16, inc: 4, groups 2
_DPN = {"first-tensor": (False, 1, True, False, 9), "tuple-no-projection": (False, 1, False, True, 9),
        "tuple-s2-even": (False, 2, True, True, 10), "b-style-first": (True, 1, True, False, 9),
        "b-style-tuple-s2-odd": (True, 2, False, True, 11)}


@MODES
@pytest.mark.parametrize("name", list(_DPN))
def test_dual_path_block_matches_flax(name, training):
    """The residual / dense split of one 1x1 or two (``b_style``), and the
    projection of the state where the block starts a stage, strides or gets
    one tensor."""
    b_style, stride, is_first, as_tuple, size = _DPN[name]
    rng = np.random.RandomState(11)
    res, dense = (rng.randn(2, size, size, c).astype(np.float32) for c in (16, 12))
    kwargs = dict(groups=2, stride=stride, is_first=is_first, b_style=b_style)
    jmod = jdpn.DualPathBlock(8, 8, 16, 4, **kwargs)
    tmod = DualPathBlock(28 if as_tuple else 16, 8, 8, 16, 4, in_res_channels=16 if as_tuple else None, **kwargs)
    assert tmod.project == (name != "tuple-no-projection")
    to_t = lambda a: torch.from_numpy(a.transpose(0, 3, 1, 2).copy())  # noqa: E731
    x, tx = ((res, dense), (to_t(res), to_t(dense))) if as_tuple else (res, to_t(res))
    got, want = _run(jmod, tmod, x, tx, training, seed=12)
    for g, w in zip(got, want):
        _close(g, w, TOL)


_INCEPTION = {"A": (jinception.InceptionA, tinception.InceptionA, 384, 9),
              "ReductionA-even": (jinception.ReductionA, tinception.ReductionA, 384, 10),
              "ReductionA-odd": (jinception.ReductionA, tinception.ReductionA, 384, 11),
              "B": (jinception.InceptionB, tinception.InceptionB, 1024, 9),
              "ReductionB-even": (jinception.ReductionB, tinception.ReductionB, 1024, 8),
              "ReductionB-odd": (jinception.ReductionB, tinception.ReductionB, 1024, 9),
              "C": (jinception.InceptionC, tinception.InceptionC, 1536, 5)}


@pytest.mark.parametrize("compat", [False, True], ids=["same", "torch-compat"])
@pytest.mark.parametrize("name", list(_INCEPTION))
def test_inception_blocks_match_flax(name, compat):
    """Eval mode: VALID reduction convs and pools and count_include_pad=False
    average pools in compat mode, SAME and padding-counting ones else."""
    jcls, tcls, cin, size = _INCEPTION[name]
    x, tx = _input((1, size, size, cin), seed=13)
    got, want = _run(jcls(compat=compat), tcls(compat), x, tx, False, seed=14)
    _close(got, want, TOL)


@pytest.mark.parametrize("name", ["A", "ReductionA-even"])
def test_inception_blocks_match_flax_in_training(name):
    jcls, tcls, cin, size = _INCEPTION[name]
    x, tx = _input((2, size, size, cin), seed=15)
    got, want = _run(jcls(compat=True), tcls(True), x, tx, True, seed=16)
    _close(got, want, TOL)


# (in, channels, stride, dilation, size)
_IDENTITY_RESIDUAL = {"identity": (8, (8, 8), 1, 1, 9), "projection-s2-even": (8, (12, 12), 2, 1, 10),
                      "projection-s2-odd": (8, (12, 12), 2, 1, 11),
                      "bottleneck-dilated": (8, (8, 16, 32), 1, 2, 10),
                      "bottleneck-s2-odd": (32, (8, 16, 32), 2, 1, 9), "dilated-4": (8, (8, 8), 1, 4, 12)}


@MODES
@pytest.mark.parametrize("name", list(_IDENTITY_RESIDUAL))
def test_identity_residual_block_matches_flax(name, training):
    """Pre-activation, the hand-named layers, the projection and dilation."""
    cin, channels, stride, dilation, size = _IDENTITY_RESIDUAL[name]
    x, tx = _input((2, size, size, cin), seed=17)
    jmod = jwide.IdentityResidualBlock(channels, stride=stride, dilation=dilation)
    got, want = _run(jmod, IdentityResidualBlock(cin, channels, stride, dilation), x, tx, training, seed=18)
    _close(got, want, TOL)


def test_identity_residual_block_with_dropout_matches_flax():
    """A2's modules 6 and 7 drop out before the last conv: in eval mode the
    block equals flax's; in train mode (flax draws its own mask) the running
    statistics of ``bn1`` and ``bn2``, which come before the dropout, do."""
    x, tx = _input((2, 9, 9, 8), seed=19)
    jmod = jwide.IdentityResidualBlock((8, 8), dropout_rate=0.5)
    tmod = IdentityResidualBlock(8, (8, 8), dropout_rate=0.5)
    got, want = _run(jmod, tmod, x, tx, False, seed=20)
    _close(got, want, TOL)
    assert type(tmod.dropout) is torch.nn.Dropout and tmod.dropout.p == 0.5
    variables = _init(jmod, x, seed=20)
    load_flax_variables(tmod, variables)
    _, new = jmod.apply(variables, x, training=True, mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(0)})
    got = tmod.train()(tx)
    assert bool(torch.isfinite(got).all()) and float((got == 0).float().mean()) < 0.5
    for bn in ("bn1", "bn2"):
        for buf, key in (("running_mean", "mean"), ("running_var", "var")):
            np.testing.assert_allclose(getattr(tmod, bn).__getattr__(buf).numpy(),
                                       np.asarray(new["batch_stats"][bn][key]), rtol=STATS_TOL, atol=STATS_TOL)
