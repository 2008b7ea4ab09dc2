"""Parity of the port's TResNet, Stacked Hourglass and SqueezeNet encoders
with the JAX package, on the CPU.

The flax variables are seeded numpy values in the shapes of the flax init
and reach the torch modules through ``load_flax_variables`` (the helpers
are ``test_torch_maxvit_nfnet.py``'s).  Each block and encoder runs in eval
mode and in train mode, where the running statistics are held to flax's
(biased variance) within 1e-5.

TResNet's ``space_to_depth`` orders channels ``(c s1 s2)`` and its
``BlurPool`` pads as flax ``SAME`` (an even side (0, 1), an odd one (1, 1)):
both are held bit for bit, and the encoder runs on a 68^2 input, whose
stride-4 map (17) is odd through every blur.  The hourglasses run at depth
2 and 3, so that the recursion's naming (``HGResidualBlock_0``,
``HGResidualBlock_1``, ``HGBlock_0``, ``HGResidualBlock_2``) is exercised,
on maps whose pooling floors (an odd side at some level).  SqueezeNet has no
BatchNorm; it runs on even and odd inputs (its max pools pad (1, 1)).

Tolerances: 1e-5 * max|ref| for one block (``TOL``), 1e-4 * max|ref|
(``MODEL_TOL``) for encoders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_toolbelt_tpu.zoo.encoders import hourglass as jhourglass
from pytorch_toolbelt_tpu.zoo.encoders import squeezenet as jsqueezenet
from pytorch_toolbelt_tpu.zoo.encoders import tresnet as jtresnet
from pytorch_toolbelt_tpu_torch.zoo import (
    BlurPool,
    HGBlock,
    HGResidualBlock,
    SqueezeNetEncoder,
    StackedHGEncoder,
    StackedSupervisedHGEncoder,
    TResNetBasicBlock,
    TResNetBottleneck,
    TResNetEncoder,
    load_flax_variables,
    space_to_depth,
)
from test_torch_maxvit_nfnet import MODEL_TOL, MODES, TOL, _close, _init, _nchw, _nhwc, _run, _spec

# ---------------------------------------------------------------------------
# TResNet
# ---------------------------------------------------------------------------


def test_space_to_depth_orders_channels_as_the_jax_package():
    x = _nhwc((2, 12, 8, 3), seed=1)
    want = np.asarray(jtresnet.space_to_depth(jnp.asarray(x), 4))
    got = space_to_depth(_nchw(x), 4).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("size", [(8, 8), (9, 7), (6, 11)])
def test_blur_pool_equals_the_jax_package(size, dtype):
    """Even sides pad (0, 1), odd ones (1, 1); the kernel is in the input's
    dtype.  Bit for bit in fp32 and in bf16 (the 1/16-multiples are exact)."""
    x = jnp.asarray(_nhwc((2, *size, 5), seed=2)).astype(dtype)
    want = np.asarray(jtresnet.BlurPool().apply({}, x).astype(jnp.float32))
    tx = _nchw(np.asarray(x.astype(jnp.float32)))
    if dtype != np.float32:
        tx = tx.to(torch.bfloat16)
    got = BlurPool()(tx)
    assert got.dtype == tx.dtype
    got = got.float().numpy().transpose(0, 2, 3, 1)
    if dtype == np.float32:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    else:
        assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()


# name: (JAX class, port class, in, out, stride, use_se, size)
_T_BLOCKS = {
    "basic-stride1-se": (jtresnet.TResNetBasicBlock, TResNetBasicBlock, 16, 16, 1, True, (8, 8)),
    "basic-stride2-new-channels-odd": (jtresnet.TResNetBasicBlock, TResNetBasicBlock, 8, 16, 2, True, (9, 7)),
    "bottleneck-stride2-se": (jtresnet.TResNetBottleneck, TResNetBottleneck, 16, 32, 2, True, (8, 10)),
    "bottleneck-stride1-no-se": (jtresnet.TResNetBottleneck, TResNetBottleneck, 32, 32, 1, False, (5, 5)),
}


@MODES
@pytest.mark.parametrize("name", list(_T_BLOCKS))
def test_tresnet_block_matches_flax(name, training):
    jcls, tcls, cin, cout, stride, use_se, size = _T_BLOCKS[name]
    x = _nhwc((2, *size, cin), seed=3)
    got, want = _run(jcls(cout, stride=stride, use_se=use_se), tcls(cin, cout, stride=stride, use_se=use_se), x,
                     training, seed=4)
    _close(got, want, TOL if not training else MODEL_TOL)


_T_NARROW = dict(width_factor=0.25, stage_blocks=(1, 2, 1, 1))


@MODES
@pytest.mark.parametrize("layers", [None, (1, 2, 3, 4)])
def test_tresnet_encoder_matches_flax(layers, training):
    """68^2: the stride-4 map is 17^2, odd through every blur (9, 5, 3)."""
    jenc = jtresnet.TResNetEncoder(**_T_NARROW, layers=layers)
    tenc = TResNetEncoder(**_T_NARROW, layers=layers)
    assert _spec(tenc) == _spec(jenc)
    x = _nhwc((2, 68, 68, 3), seed=5)
    got, want = _run(jenc, tenc, x, training, seed=6)
    assert len(got) == len(want) == len(tenc.get_output_spec())
    for g, w in zip(got, want):
        _close(g, w, MODEL_TOL)


def test_tresnet_odd_width_factor_floors_the_widths():
    """``int(64 * width_factor)``: L is 76 wide, XL 83."""
    assert _spec(TResNetEncoder(width_factor=1.2, stage_blocks=(1, 1, 1, 1)))[0] == (76, 76, 152, 1216, 2432)
    assert _spec(TResNetEncoder(width_factor=1.3, stage_blocks=(1, 1, 1, 1)))[0] == (83, 83, 166, 1328, 2656)


# ---------------------------------------------------------------------------
# Stacked Hourglass
# ---------------------------------------------------------------------------


@MODES
@pytest.mark.parametrize("cin,cout", [(8, 16), (16, 16)])
def test_hg_residual_block_matches_flax(cin, cout, training):
    """Pre-activation; a shortcut conv (``Conv_3``) only where the channels change."""
    x = _nhwc((2, 7, 9, cin), seed=7)
    got, want = _run(jhourglass.HGResidualBlock(cout), HGResidualBlock(cin, cout), x, training, seed=8)
    _close(got, want, TOL if not training else MODEL_TOL)


@MODES
@pytest.mark.parametrize("depth,size", [(1, (6, 6)), (2, (12, 10)), (3, (13, 18))])
def test_hg_block_matches_flax(depth, size, training):
    """Depth 2 and 3 name an inner ``HGBlock_0`` between the residuals; 13 x 18
    floors at the first pool (6 x 9) and at the second (3 x 4); the nearest
    resize goes back up to the skip branch's size."""
    x = _nhwc((2, *size, 8), seed=9)
    got, want = _run(jhourglass.HGBlock(depth, 8), HGBlock(depth, 8), x, training, seed=10)
    _close(got, want, TOL if not training else MODEL_TOL)


_HG_NARROW = dict(stack_level=2, depth=2, features=16)


@MODES
def test_stacked_hg_encoder_matches_flax(training):
    jenc, tenc = jhourglass.StackedHGEncoder(**_HG_NARROW), StackedHGEncoder(**_HG_NARROW)
    assert _spec(tenc) == _spec(jenc)
    x = _nhwc((2, 64, 60, 3), seed=11)
    got, want = _run(jenc, tenc, x, training, seed=12)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _close(g, w, MODEL_TOL)


@MODES
def test_stacked_supervised_hg_encoder_matches_flax(training):
    """The supervision masks (``sup_mask``, then ``sup_features``, then the
    merge conv, per stack) as well as the features."""
    config = dict(_HG_NARROW, stack_level=3, supervision_channels=2)
    jenc, tenc = jhourglass.StackedSupervisedHGEncoder(**config), StackedSupervisedHGEncoder(**config)
    x = _nhwc((2, 64, 64, 3), seed=13)
    (got, got_masks), (want, want_masks) = _run(jenc, tenc, x, training, seed=14)
    assert len(got) == len(want) == 4 and len(got_masks) == len(want_masks) == 2
    for g, w in zip(got + got_masks, want + want_masks):
        assert g.shape[1] in (16, 2)
        _close(g, w, MODEL_TOL)


# ---------------------------------------------------------------------------
# SqueezeNet
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size", [64, 66, 71])
@pytest.mark.parametrize("layers", [None, (1, 3)])
def test_squeezenet_encoder_matches_flax(size, layers):
    jenc = jsqueezenet.SqueezeNetEncoder(layers=layers)
    tenc = SqueezeNetEncoder(layers=layers)
    assert _spec(tenc) == _spec(jenc)
    x = _nhwc((2, size, size, 3), seed=15)
    got, want = _run(jenc, tenc, x, False, seed=16)
    for g, w in zip(got, want):
        _close(g, w, MODEL_TOL)


def test_squeezenet_fire_concatenates_1x1_then_3x3():
    jfire = jsqueezenet.Fire(4, 6, 5)
    x = _nhwc((1, 5, 5, 8), seed=17)
    variables = _init(jfire, x, seed=18)
    from pytorch_toolbelt_tpu_torch.zoo.encoders.squeezenet import Fire

    tfire = load_flax_variables(Fire(8, 4, 6, 5), variables)
    with torch.no_grad():
        got = tfire(_nchw(x))
    _close(got, jfire.apply(variables, x), TOL)
    assert got.shape[1] == 11
