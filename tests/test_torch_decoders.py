"""Parity of the port's decoders and the ``nn`` blocks they are built of
(depthwise-separable convs, the ASPP family) with the JAX package, on the
CPU: DeepLabV3 / V3+, PPM, CAN and BiFPN, a full-depth ResNet-50 with the
full-width DeepLabV3+ decoder, and the slice as a whole (a narrow
DeepLabV3+ on ``resnet18_encoder(layers=(1, 4))`` through both packages'
``tiled_apply_d4_tta``).

The flax variables are seeded numpy values in the shapes of the flax init
(``jax.eval_shape``), and they reach the torch modules through
``load_flax_variables``.  Tensors are NHWC in JAX and NCHW in the port.
Each module runs in eval mode, and in train mode with dropout 0, where the
running statistics the forward leaves behind are held to flax's within 1e-5
(absolute + relative).

Tolerances: 1e-5 * max|ref| for one block, 1e-4 * max|ref| (``MODEL_TOL``)
for decoders and models, where the rounding differences of XLA's and
torch's convolutions add up through the layers.

PPM: the port pools adaptively (``F.adaptive_avg_pool2d``); the JAX package
pools with window and stride ``h // bins``, the same only where every bin
size divides the map (ROADMAP queue 3, F10).  It is compared on a 12 x 12
map, and the difference is pinned on a 16 x 16 one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pytorch_toolbelt_tpu.inference import tiled_apply_d4_tta as j_tiled_apply_d4_tta
from pytorch_toolbelt_tpu.nn import dsconv as jdsconv
from pytorch_toolbelt_tpu.nn import spp as jspp
from pytorch_toolbelt_tpu.zoo import EncoderDecoderModel as JEncoderDecoderModel
from pytorch_toolbelt_tpu.zoo import ResizeHead as JResizeHead
from pytorch_toolbelt_tpu.zoo.decoders import bifpn as jbifpn
from pytorch_toolbelt_tpu.zoo.decoders import can as jcan
from pytorch_toolbelt_tpu.zoo.decoders import deeplab as jdeeplab
from pytorch_toolbelt_tpu.zoo.decoders import ppm as jppm
from pytorch_toolbelt_tpu.zoo.encoders import resnet as jresnet
from pytorch_toolbelt_tpu_torch.core import AbstractDecoder, FeatureMapsSpec, HasOutputFeaturesSpecification
from pytorch_toolbelt_tpu_torch.inference import tiled_apply_d4_tta
from pytorch_toolbelt_tpu_torch.nn import (
    ASPP,
    ASPPModule,
    ASPPPooling,
    DepthwiseSeparableConv2d,
    DepthwiseSeparableConv2dBlock,
    SeparableASPPModule,
)
from pytorch_toolbelt_tpu_torch.zoo import (
    BiFPNDecoder,
    CANDecoder,
    DeeplabV3Decoder,
    DeeplabV3PlusDecoder,
    EncoderDecoderModel,
    PPMDecoder,
    ResizeHead,
    load_flax_variables,
    resnet18_encoder,
    resnet50_encoder,
)
from pytorch_toolbelt_tpu_torch.zoo.porting import _leaves

TOL = 1e-5
MODEL_TOL = 1e-4
STATS_TOL = 1e-5


def _init(jmodule, *args, seed, **kwargs):
    """Seeded numpy values in the shapes of the flax module's variables:
    LeCun-normal kernels, BatchNorm statistics and affine parameters near
    their identity values, BiFPN's raw fusion weights around 1 with some
    below 0 (so their ReLU acts)."""
    shapes = jax.eval_shape(lambda: jmodule.init(jax.random.PRNGKey(seed), *args, **kwargs))
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            return (rng.randn(*shape) * np.sqrt(1.0 / np.prod(shape[:-1]))).astype(np.float32)
        if name == "mean":
            return (0.2 * rng.randn(*shape)).astype(np.float32)
        if name == "var":
            return (0.5 + rng.rand(*shape)).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.2 * rng.randn(*shape)).astype(np.float32)
        if name == "bias":
            return (0.1 * rng.randn(*shape)).astype(np.float32)
        if name == "alpha":
            return (0.25 + 0.05 * rng.randn(*shape)).astype(np.float32)
        if name in ("w1", "w2"):
            return (1.5 * rng.rand(*shape) - 0.25).astype(np.float32)
        raise KeyError(f"no seeded value for the flax leaf {name!r}")

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _maps(shapes_nhwc, seed):
    rng = np.random.RandomState(seed)
    xs = [rng.randn(*s).astype(np.float32) for s in shapes_nhwc]
    return [jnp.asarray(x) for x in xs], [torch.from_numpy(x.transpose(0, 3, 1, 2).copy()) for x in xs]


def _close(got, want, tol):
    want = np.asarray(want)
    got = got.detach().float().numpy()
    if got.ndim == 4:
        got = got.transpose(0, 2, 3, 1)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def _check_running_stats(tmodule, new_stats):
    """Every running statistic of ``tmodule`` against flax's updated one."""
    checked = 0
    for collection, path, tensor, _ in _leaves(tmodule, ()):
        if collection != "batch_stats":
            continue
        want = new_stats
        for key in path:
            want = want[key]
        np.testing.assert_allclose(tensor.detach().numpy(), np.asarray(want), rtol=STATS_TOL, atol=STATS_TOL)
        checked += 1
    return checked


def _run(jmodule, tmodule, jargs, targs, training, seed):
    """(torch output, flax output) of the pair on the same variables; in
    train mode the running statistics are checked too."""
    variables = _init(jmodule, *jargs, seed=seed)
    load_flax_variables(tmodule, variables)
    if training:
        want, new = jmodule.apply(variables, *jargs, training=True, mutable=["batch_stats"])
        got = tmodule.train()(*targs)
        assert _check_running_stats(tmodule, new.get("batch_stats", {})) == len(
            jax.tree_util.tree_leaves(variables.get("batch_stats", {})))
    else:
        want = jmodule.apply(variables, *jargs)
        with torch.no_grad():
            got = tmodule.eval()(*targs)
    return got, want


MODES = pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])


# ---------------------------------------------------------------------------
# nn blocks: depthwise-separable convs and the ASPP family
# ---------------------------------------------------------------------------

# (kernel, stride, dilation, groups, size): stride 2 on an even and an odd map (flax SAME pads (0, 1) and (1, 1))
_DSCONV = [(3, 1, 1, 1, 10), (3, 2, 1, 1, 10), (3, 2, 1, 2, 11), (5, 1, 2, 1, 9), (7, 1, 1, 4, 8)]


@pytest.mark.parametrize("case", _DSCONV, ids=[f"k{c[0]}s{c[1]}d{c[2]}g{c[3]}-{c[4]}" for c in _DSCONV])
def test_depthwise_separable_conv_matches_flax(case):
    k, stride, dilation, groups, size = case
    jx, tx = _maps([(2, size, size + 1, 8)], seed=k + stride)
    jmod = jdsconv.DepthwiseSeparableConv2d(12, kernel_size=k, stride=stride, dilation=dilation, groups=groups)
    tmod = DepthwiseSeparableConv2d(8, 12, kernel_size=k, stride=stride, dilation=dilation, groups=groups)
    variables = _init(jmod, jx[0], seed=1)
    load_flax_variables(tmod, variables)
    with torch.no_grad():
        _close(tmod(tx[0]), jmod.apply(variables, jx[0]), TOL)


@MODES
@pytest.mark.parametrize("stride", [1, 2])
def test_depthwise_separable_block_matches_flax(stride, training):
    jx, tx = _maps([(2, 10, 10, 6)], seed=3)
    jmod = jdsconv.DepthwiseSeparableConv2dBlock(10, activation="relu", stride=stride, dilation=1)
    tmod = DepthwiseSeparableConv2dBlock(6, 10, activation="relu", stride=stride)
    got, want = _run(jmod, tmod, jx, tx, training, seed=2)
    _close(got, want, TOL)


_ASPP_BLOCKS = {
    "aspp_module_d2": (lambda: jspp.ASPPModule(8, dilation=2), lambda: ASPPModule(6, 8, dilation=2)),
    "aspp_module_d5_prelu": (lambda: jspp.ASPPModule(8, dilation=5, activation="prelu"),
                             lambda: ASPPModule(6, 8, dilation=5, activation="prelu")),
    "separable_d3": (lambda: jspp.SeparableASPPModule(8, dilation=3), lambda: SeparableASPPModule(6, 8, dilation=3)),
    "pooling": (lambda: jspp.ASPPPooling(8), lambda: ASPPPooling(6, 8)),
    "aspp": (lambda: jspp.ASPP(8, atrous_rates=(1, 2, 3), dropout=0.0),
             lambda: ASPP(6, 8, atrous_rates=(1, 2, 3), dropout=0.0)),
    "aspp_separable": (lambda: jspp.ASPP(8, atrous_rates=(1, 2, 3), dropout=0.0, separable=True),
                       lambda: ASPP(6, 8, atrous_rates=(1, 2, 3), dropout=0.0, separable=True)),
}


@MODES
@pytest.mark.parametrize("name", list(_ASPP_BLOCKS))
def test_aspp_blocks_match_flax(name, training):
    jfactory, tfactory = _ASPP_BLOCKS[name]
    jx, tx = _maps([(2, 9, 10, 6)], seed=4)
    got, want = _run(jfactory(), tfactory(), jx, tx, training, seed=5)
    _close(got, want, TOL)


def test_aspp_pooling_broadcasts_on_the_inputs_device_and_dtype():
    pool = ASPPPooling(4, 3).eval().to(torch.float64)
    out = pool(torch.randn(2, 4, 5, 7, dtype=torch.float64))
    assert out.shape == (2, 3, 5, 7) and out.dtype == torch.float64
    assert torch.equal(out, out[:, :, :1, :1].expand_as(out))


# ---------------------------------------------------------------------------
# Decoders
# ---------------------------------------------------------------------------

_SPEC3 = FeatureMapsSpec((6, 10, 12), (4, 8, 16))
_SHAPES3 = [(2, 16, 16, 6), (2, 8, 8, 10), (2, 4, 4, 12)]
_DECODERS = {
    "deeplab_v3": (lambda s: jdeeplab.DeeplabV3Decoder(s, 5, aspp_channels=8, atrous_rates=(1, 2, 3), dropout=0.0),
                   lambda s: DeeplabV3Decoder(s, 5, aspp_channels=8, atrous_rates=(1, 2, 3), dropout=0.0)),
    "deeplab_v3_plus": (lambda s: jdeeplab.DeeplabV3PlusDecoder(s, 7, aspp_channels=8, low_level_channels=4,
                                                                atrous_rates=(1, 2, 3), dropout=0.0),
                        lambda s: DeeplabV3PlusDecoder(s, 7, aspp_channels=8, low_level_channels=4,
                                                       atrous_rates=(1, 2, 3), dropout=0.0)),
    "can": (lambda s: jcan.CANDecoder(s, out_channels=4), lambda s: CANDecoder(s, out_channels=4)),
    "bifpn": (lambda s: jbifpn.BiFPNDecoder(s, out_channels=6, num_layers=2),
              lambda s: BiFPNDecoder(s, out_channels=6, num_layers=2)),
    "bifpn_separable_gn": (lambda s: jbifpn.BiFPNDecoder(s, out_channels=32, num_layers=1, separable=True,
                                                         normalization="group_norm", activation="silu"),
                           lambda s: BiFPNDecoder(s, out_channels=32, num_layers=1, separable=True,
                                                  normalization="group_norm", activation="silu")),
}


@MODES
@pytest.mark.parametrize("name", list(_DECODERS))
def test_decoder_matches_flax(name, training):
    jfactory, tfactory = _DECODERS[name]
    jdec, tdec = jfactory(_SPEC3), tfactory(_SPEC3)
    assert isinstance(tdec, AbstractDecoder) and isinstance(tdec, HasOutputFeaturesSpecification)
    assert tdec.get_output_spec() == FeatureMapsSpec(*_spec(jdec))
    jmaps, tmaps = _maps(_SHAPES3, seed=6)
    got, want = _run(jdec, tdec, (jmaps,), (tmaps,), training, seed=7)
    assert len(got) == len(want) == len(tdec.get_output_spec())
    for g, w in zip(got, want):
        _close(g, w, MODEL_TOL)


def _spec(module):
    spec = module.get_output_spec()
    return tuple(spec.channels), tuple(spec.strides)


@MODES
def test_ppm_decoder_matches_flax_where_the_bins_divide_the_map(training):
    spec = FeatureMapsSpec((4, 8), (16, 32))
    jdec = jppm.PPMDecoder(spec, out_channels=8, pool_sizes=(1, 2, 3, 6), dropout=0.0)
    tdec = PPMDecoder(spec, out_channels=8, pool_sizes=(1, 2, 3, 6), dropout=0.0)
    jmaps, tmaps = _maps([(2, 24, 24, 4), (2, 12, 12, 8)], seed=8)
    got, want = _run(jdec, tdec, (jmaps,), (tmaps,), training, seed=9)
    _close(got[0], want[0], MODEL_TOL)


def test_ppm_decoder_pools_adaptively_where_the_jax_package_does_not():
    """F10 pinned on a 16 x 16 map with bins (1, 2, 3, 6): the port equals a
    plain path written here with ``F.adaptive_avg_pool2d``; the JAX package,
    whose pools are 8 x 8 bins at 6 and drop row and column 15 at 3, does
    not."""
    spec = FeatureMapsSpec((8,), (32,))
    jdec = jppm.PPMDecoder(spec, out_channels=8, pool_sizes=(1, 2, 3, 6), dropout=0.0)
    tdec = PPMDecoder(spec, out_channels=8, pool_sizes=(1, 2, 3, 6), dropout=0.0).eval()
    jmaps, tmaps = _maps([(2, 16, 16, 8)], seed=10)
    variables = _init(jdec, jmaps, seed=11)
    load_flax_variables(tdec, variables)
    with torch.no_grad():
        got = tdec(tmaps)[0]
        x = tmaps[0]
        branches = [x]
        for bins, (conv, bn) in zip((1, 2, 3, 6), tdec.stages):
            pooled = F.relu(bn(conv(F.adaptive_avg_pool2d(x, bins))))
            branches.append(F.interpolate(pooled, size=(16, 16), mode="bilinear", align_corners=False))
        plain = F.relu(tdec.fuse_bn(tdec.fuse_conv(torch.cat(branches, dim=1))))
    _close(got, plain.numpy().transpose(0, 2, 3, 1), TOL)
    want = np.asarray(jdec.apply(variables, jmaps)[0])
    got_nhwc = got.numpy().transpose(0, 2, 3, 1)
    assert np.abs(got_nhwc - want).max() > 1e-2 * np.abs(want).max()


# ---------------------------------------------------------------------------
# Full depth, and the slice as a whole
# ---------------------------------------------------------------------------


def test_resnet50_with_full_width_deeplab_v3_plus_matches_flax():
    """The chip run's model (``resnet50_encoder(layers=(1, 4))``, DeepLabV3+
    at smp's widths: ASPP 256, low level 48, rates (12, 24, 36), out 256) on
    a 64^2 input, where the ASPP sees a 2 x 2 map."""
    jenc = jresnet.resnet50_encoder(layers=(1, 4))
    tenc = resnet50_encoder(layers=(1, 4))
    kwargs = dict(out_channels=256, aspp_channels=256, low_level_channels=48, atrous_rates=(12, 24, 36))
    jdec = jdeeplab.DeeplabV3PlusDecoder(jenc.get_output_spec(), **kwargs)
    tdec = DeeplabV3PlusDecoder(tenc.get_output_spec(), **kwargs)
    jmodel = JEncoderDecoderModel(encoder=jenc, decoder=jdec, head=JResizeHead(jdec.get_output_spec(), num_classes=19))
    tmodel = EncoderDecoderModel(tenc, tdec, ResizeHead(tdec.get_output_spec(), num_classes=19))
    (jx,), (tx,) = _maps([(2, 64, 64, 3)], seed=12)
    got, want = _run(jmodel, tmodel, (jx,), (tx,), False, seed=13)
    assert tuple(got.shape) == (2, 19, 64, 64)
    _close(got, want, MODEL_TOL)


@pytest.fixture(scope="module")
def narrow_deeplab():
    """``resnet18_encoder(layers=(1, 4))`` + DeepLabV3+ (out 16, ASPP 16, low
    level 8, rates (1, 2, 3)) + ResizeHead(3), bridged; eval mode."""
    jenc, tenc = jresnet.resnet18_encoder(layers=(1, 4)), resnet18_encoder(layers=(1, 4))
    kwargs = dict(out_channels=16, aspp_channels=16, low_level_channels=8, atrous_rates=(1, 2, 3))
    jdec = jdeeplab.DeeplabV3PlusDecoder(jenc.get_output_spec(), **kwargs)
    tdec = DeeplabV3PlusDecoder(tenc.get_output_spec(), **kwargs)
    jmodel = JEncoderDecoderModel(encoder=jenc, decoder=jdec, head=JResizeHead(jdec.get_output_spec(), num_classes=3))
    tmodel = EncoderDecoderModel(tenc, tdec, ResizeHead(tdec.get_output_spec(), num_classes=3))
    variables = _init(jmodel, jnp.zeros((1, 32, 32, 3)), seed=14)
    load_flax_variables(tmodel, variables)
    return jmodel, variables, tmodel.eval()


@pytest.mark.parametrize("mode", ["distributed", "full"])
def test_narrow_deeplab_v3_plus_through_tiled_d4_matches_jax(narrow_deeplab, mode):
    jmodel, variables, tmodel = narrow_deeplab
    image = np.random.RandomState(15).rand(64, 64, 3).astype(np.float32)
    want = np.asarray(j_tiled_apply_d4_tta(lambda x: jmodel.apply(variables, x), jnp.asarray(image), tile_size=32,
                                           tile_step=16, batch_size=16, mode=mode))
    with torch.no_grad():
        got = tiled_apply_d4_tta(tmodel, torch.from_numpy(image.transpose(2, 0, 1).copy()), tile_size=32,
                                 tile_step=16, batch_size=16, mode=mode)
    assert got.shape == (3, 64, 64) and got.dtype == torch.float32
    assert np.abs(got.numpy().transpose(1, 2, 0) - want).max() <= MODEL_TOL * np.abs(want).max()
