"""Parity of the port's building blocks of the residual UNet slice with the
JAX package, on the CPU: activations, ``PReLU``, ``ABN``, ``AGN``,
``DropPath``, ``UnetResidualBlock``, the upsample layers and their factory,
the two initialisers they use, the SCSE gates, bicubic ``resize_2d`` and the
residual UNet with every upsample type.  Also: every name of the JAX
modules of this slice exists in the port.

The same seeded numpy inputs go through both packages; flax variables are
initialised from a seed, their BatchNorm statistics and affine parameters
replaced by seeded values, and they reach the torch modules through
``load_flax_variables``.  Tensors are NHWC in JAX and NCHW in the port.

Tolerances: 1e-5 * max|ref| for single layers (fp32; XLA and torch add in
other orders), 1e-4 * max|ref| for whole models (the rounding differences
grow through the layers, as ``test_torch_senet_fpn.py`` argues), bit for
bit where no arithmetic differs (the pixel shuffle without its conv, the
ICNR repetition).
"""

import importlib

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_toolbelt_tpu.nn import activations as JA
from pytorch_toolbelt_tpu.nn import functional as JNF
from pytorch_toolbelt_tpu.nn import initialization as JI
from pytorch_toolbelt_tpu.nn import scse as JS
from pytorch_toolbelt_tpu.nn import unet as JU
from pytorch_toolbelt_tpu.nn import upsample as JUP
from pytorch_toolbelt_tpu.zoo import EncoderDecoderModel as JEncoderDecoderModel
from pytorch_toolbelt_tpu.zoo import ResizeHead as JResizeHead
from pytorch_toolbelt_tpu.zoo import UNetDecoder as JUNetDecoder
from pytorch_toolbelt_tpu.zoo import UnetEncoder as JUnetEncoder
from pytorch_toolbelt_tpu_torch.nn import activations as TA
from pytorch_toolbelt_tpu_torch.nn import functional as TNF
from pytorch_toolbelt_tpu_torch.nn import initialization as TI
from pytorch_toolbelt_tpu_torch.nn import scse as TS
from pytorch_toolbelt_tpu_torch.nn import upsample as TUP
from pytorch_toolbelt_tpu_torch.nn import DropPath, UnetBlock, UnetResidualBlock, drop_path
from pytorch_toolbelt_tpu_torch.zoo import EncoderDecoderModel, ResizeHead, UNetDecoder, UnetEncoder
from pytorch_toolbelt_tpu_torch.zoo import load_flax_variables

TOL = 1e-5
MODEL_TOL = 1e-4


def _numpy_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, dtype=np.float32), tree)


def _init(jmodule, jinputs, seed, **kwargs):
    """Flax variables with seeded BatchNorm statistics, affine parameters,
    biases and PReLU slopes."""
    variables = _numpy_tree(jmodule.init(jax.random.PRNGKey(seed), *jinputs, **kwargs))
    rng = np.random.RandomState(seed)

    def perturb(path, leaf):
        name = path[-1].key
        if name == "mean":
            return (0.2 * rng.randn(*leaf.shape)).astype(np.float32)
        if name == "var":
            return (0.5 + rng.rand(*leaf.shape)).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.2 * rng.randn(*leaf.shape)).astype(np.float32)
        if name == "bias":
            return (0.1 * rng.randn(*leaf.shape)).astype(np.float32)
        if name == "alpha":
            return rng.uniform(0.05, 0.5, leaf.shape).astype(np.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(perturb, variables)


def _input(shape_nhwc, seed):
    x = np.random.RandomState(seed).randn(*shape_nhwc).astype(np.float32)
    return x, torch.from_numpy(x.transpose(0, 3, 1, 2).copy())


def _nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    got = _nhwc(got)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def _run_pair(jmodule, tmodule, x_nhwc, seed, training=False, **call_kwargs):
    """The flax module and the bridged torch module on the same input."""
    x, xt = _input(x_nhwc, seed)
    variables = _init(jmodule, [jnp.asarray(x)], seed, **call_kwargs)
    load_flax_variables(tmodule, variables)
    if training:
        want, _ = jmodule.apply(variables, jnp.asarray(x), training=True, mutable=["batch_stats"], **call_kwargs)
        got = tmodule.train()(xt, **call_kwargs)
    else:
        want = jmodule.apply(variables, jnp.asarray(x), **call_kwargs)
        with torch.no_grad():
            got = tmodule.eval()(xt, **call_kwargs)
    return got, want


# ---------------------------------------------------------------------------
# Every name of the slice's JAX modules exists in the port
# ---------------------------------------------------------------------------

_SLICE_MODULES = [
    "nn.activations", "nn.drop_path", "nn.functional", "nn.scse", "nn.simple", "nn.unet", "nn.upsample",
    "zoo.encoders.common", "zoo.encoders.resnet", "zoo.encoders.unet", "zoo.decoders.unet",
    "inference.functional", "inference.tta",
]


@pytest.mark.parametrize("module", _SLICE_MODULES)
def test_port_has_every_name_of_the_jax_module(module):
    jmod = importlib.import_module(f"pytorch_toolbelt_tpu.{module}")
    tmod = importlib.import_module(f"pytorch_toolbelt_tpu_torch.{module}")
    missing = [name for name in jmod.__all__ if not hasattr(tmod, name)]
    assert not missing
    assert set(jmod.__all__) <= set(tmod.__all__)


def test_port_has_the_upsample_initialisers():
    for name in ("icnr_init", "bilinear_upsample_initializer"):
        assert name in JI.__all__ and name in TI.__all__


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------

_ELEMENTWISE = [name for name in JA._ACTIVATIONS]


@pytest.mark.parametrize("name", _ELEMENTWISE)
def test_activation_matches_jax(name):
    """glu and softmax act on the channels: axis -1 in JAX, dim 1 here."""
    x, xt = _input((2, 5, 7, 6), seed=1)
    want = JA.get_activation_fn(name)(jnp.asarray(3 * x))
    got = TA.get_activation_fn(name)(3 * xt)
    _close(got, want)
    assert TA.get_activation_block(name) is TA.get_activation_fn(name)


@pytest.mark.parametrize("name", ["swish", "mish", "hard_sigmoid", "hard_swish", "relu6", "identity", "mish_naive",
                                  "swish_naive"])
def test_activation_function_exports_match_jax(name):
    x, xt = _input((2, 4, 4, 3), seed=2)
    _close(getattr(TA, name)(4 * xt), getattr(JA, name)(jnp.asarray(4 * x)))


def test_instantiate_activation_block_kwargs_match_jax():
    x, xt = _input((2, 4, 4, 6), seed=3)
    _close(TA.instantiate_activation_block("leaky_relu", slope=0.2)(xt),
           JA.instantiate_activation_block("leaky_relu", slope=0.2)(jnp.asarray(x)))
    _close(TA.instantiate_activation_block("softmax")(xt), JA.instantiate_activation_block("softmax")(jnp.asarray(x)))
    assert isinstance(TA.instantiate_activation_block("prelu", num_parameters=6), TA.PReLU)
    with pytest.raises(ValueError):
        TA.get_activation_fn("prelu")
    for name in ("mish", "swish", "swish_naive", "mish_naive", "relu", "gelu"):
        assert TA.sanitize_activation_name(name) == JA.sanitize_activation_name(name)


@pytest.mark.parametrize("num_parameters", [1, 5])
def test_prelu_matches_jax(num_parameters):
    got, want = _run_pair(JA.PReLU(num_parameters=num_parameters), TA.PReLU(num_parameters), (2, 6, 6, 5), seed=4)
    _close(got, want)


@pytest.mark.parametrize("activation", ["relu", "leaky_relu", "prelu", "swish"])
@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
def test_abn_matches_jax(activation, training):
    got, want = _run_pair(JA.ABN(activation=activation, slope=0.1), TA.ABN(8, activation=activation, slope=0.1),
                          (2, 6, 6, 8), seed=5, training=training)
    _close(got, want)


@pytest.mark.parametrize("activation", ["relu", "prelu", "mish"])
def test_agn_matches_jax(activation):
    got, want = _run_pair(JA.AGN(num_groups=4, activation=activation), TA.AGN(16, num_groups=4, activation=activation),
                          (2, 5, 5, 16), seed=6)
    _close(got, want)


# ---------------------------------------------------------------------------
# DropPath: JAX draws from its own rng stream, so the rule is tested here
# ---------------------------------------------------------------------------


def test_drop_path_is_identity_in_eval_and_at_rate_0():
    x = torch.randn(8, 3, 4, 4)
    assert DropPath(0.5).eval()(x) is x
    assert DropPath(0.0).train()(x) is x
    assert drop_path(x, 0.0) is x


@pytest.mark.parametrize("scale_by_keep", [True, False])
def test_drop_path_drops_whole_samples_and_scales_by_keep(scale_by_keep):
    x = torch.ones(256, 3, 4, 4)
    y = DropPath(0.25, scale_by_keep=scale_by_keep, generator=torch.Generator().manual_seed(0)).train()(x)
    per_sample = y.flatten(1)
    assert torch.equal(per_sample, per_sample[:, :1].expand_as(per_sample))  # whole samples
    kept = per_sample[:, 0] != 0
    assert 0 < int(kept.sum()) < 256
    assert abs(float(kept.float().mean()) - 0.75) < 0.1
    assert torch.equal(per_sample[kept, 0], torch.full((int(kept.sum()),), 1 / 0.75 if scale_by_keep else 1.0))


def test_drop_path_repeats_under_a_fixed_generator():
    x = torch.randn(64, 2, 3, 3)
    a = drop_path(x, 0.5, generator=torch.Generator().manual_seed(7))
    b = drop_path(x, 0.5, generator=torch.Generator().manual_seed(7))
    c = drop_path(x, 0.5, generator=torch.Generator().manual_seed(8))
    assert torch.equal(a, b) and not torch.equal(a, c)


# ---------------------------------------------------------------------------
# UNet blocks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cin,cout", [(6, 8), (8, 8)], ids=["shortcut", "identity"])
@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
def test_unet_residual_block_matches_jax(cin, cout, training):
    got, want = _run_pair(JU.UnetResidualBlock(out_channels=cout), UnetResidualBlock(cin, cout), (2, 9, 9, cin),
                          seed=7, training=training)
    _close(got, want)
    assert (UnetResidualBlock(cin, cout).shortcut is None) == (cin == cout)


def test_unet_residual_block_with_drop_path_in_eval_matches_jax():
    got, want = _run_pair(JU.UnetResidualBlock(out_channels=8, drop_path_rate=0.3),
                          UnetResidualBlock(6, 8, drop_path_rate=0.3), (2, 8, 8, 6), seed=8)
    _close(got, want)


@pytest.mark.parametrize("block", ["UnetBlock", "UnetResidualBlock"])
@pytest.mark.parametrize("normalization", ["batch_norm", "group_norm"])
def test_unet_blocks_share_one_prelu_as_flax_does(block, normalization):
    """One PReLU_0/alpha serves both activations (and the residual add's)."""
    jblock = getattr(JU, block)(out_channels=32, activation="prelu", normalization=normalization)
    tblock = {"UnetBlock": UnetBlock, "UnetResidualBlock": UnetResidualBlock}[block](
        16, 32, activation="prelu", normalization=normalization)
    assert sum(isinstance(m, torch.nn.PReLU) for m in tblock.modules()) == 1
    got, want = _run_pair(jblock, tblock, (2, 6, 6, 16), seed=9)
    _close(got, want)


# ---------------------------------------------------------------------------
# Upsample layers
# ---------------------------------------------------------------------------

# (type, scale): deconvolutions support scale 2 only, in JAX too
_UPSAMPLE_CASES = [(t.value, s) for t in JUP.UpsampleLayerType for s in (2, 4)
                   if not (t.value in ("deconv", "residual_deconv") and s != 2)]


@pytest.mark.parametrize("kind,scale", _UPSAMPLE_CASES, ids=[f"{k}-x{s}" for k, s in _UPSAMPLE_CASES])
def test_upsample_layer_matches_jax(kind, scale):
    cin = 20  # divides by 4 but not by 16: PixelShuffle x4 gets its fix-up conv
    jlayer = JUP.instantiate_upsample_block(kind, scale_factor=scale)
    tlayer = TUP.instantiate_upsample_block(kind, scale_factor=scale, in_channels=cin)
    got, want = _run_pair(jlayer, tlayer, (2, 5, 6, cin), seed=10)
    assert tuple(got.shape[2:]) == (5 * scale, 6 * scale)
    assert got.shape[1] == TUP.upsample_out_channels(kind, cin, scale) == JUP.upsample_out_channels(kind, cin, scale)
    _close(got, want)


@pytest.mark.parametrize("kind", ["nearest", "bilinear"])
def test_resize_layers_take_output_size_like_jax(kind):
    got, want = _run_pair(JUP.instantiate_upsample_block(kind), TUP.instantiate_upsample_block(kind), (2, 5, 6, 3),
                          seed=11, output_size=(11, 13))
    _close(got, want)


@pytest.mark.parametrize("scale,output_size", [(2, None), (4, None), (2, (11, 13))])
def test_bilinear_additive_upsample_matches_jax(scale, output_size):
    got, want = _run_pair(JUP.BilinearAdditiveUpsample2d(scale_factor=scale), TUP.BilinearAdditiveUpsample2d(scale),
                          (2, 5, 6, 32), seed=12, output_size=output_size)
    assert got.shape[1] == 32 // 2**scale
    _close(got, want)
    with pytest.raises(ValueError):
        TUP.BilinearAdditiveUpsample2d(scale)(torch.zeros(1, 6, 2, 2))


@pytest.mark.parametrize("scale", [2, 4])
def test_pixel_shuffle_without_its_conv_is_bit_equal(scale):
    layer = TUP.PixelShuffle(2**scale * 3, scale)
    assert layer.conv is None
    x, xt = _input((2, 4, 5, 2**scale * 3), seed=13)
    want = JUP.PixelShuffle(scale_factor=scale).apply({}, jnp.asarray(x))
    np.testing.assert_array_equal(_nhwc(layer(xt)), np.asarray(want))


def test_deconvolutions_need_scale_2_and_ignore_output_size():
    for cls in (TUP.DeconvolutionUpsample2d, TUP.ResidualDeconvolutionUpsample2d):
        with pytest.raises(NotImplementedError):
            cls(8, scale_factor=4)
    layer = TUP.DeconvolutionUpsample2d(4)
    assert tuple(layer(torch.zeros(1, 4, 3, 5), output_size=(7, 7)).shape) == (1, 4, 6, 10)
    with pytest.raises(ValueError, match="in_channels"):
        TUP.instantiate_upsample_block("deconv")


@pytest.mark.parametrize("size", [8, 9])
def test_flax_conv_transpose_same_is_the_cut_full_transposed_conv(size):
    """flax ConvTranspose(3x3, stride 2, SAME) = the full transposed conv with
    the flipped kernel, its last row and column cut; not torch's
    ConvTranspose2d(3, 2, padding=1, output_padding=1)."""
    conv = fnn.ConvTranspose(4, (3, 3), strides=(2, 2), padding="SAME")
    x, xt = _input((1, size, size, 3), seed=14)
    variables = _numpy_tree(conv.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    want = conv.apply(variables, jnp.asarray(x))
    kernel = torch.from_numpy(variables["params"]["kernel"][::-1, ::-1].transpose(2, 3, 0, 1).copy())
    bias = torch.from_numpy(variables["params"]["bias"].copy())
    full = torch.nn.functional.conv_transpose2d(xt, kernel, bias, stride=2)[:, :, : 2 * size, : 2 * size]
    _close(full, want)
    symmetric = torch.nn.functional.conv_transpose2d(xt, kernel, bias, stride=2, padding=1, output_padding=1)
    assert np.abs(_nhwc(symmetric) - np.asarray(want)).max() > 1e-2 * np.abs(np.asarray(want)).max()


# ---------------------------------------------------------------------------
# Initialisers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scale", [2, 3])
def test_icnr_init_repeats_each_subfilter_consecutively_as_jax(scale):
    n = scale * scale
    sub = np.random.RandomState(15).randn(3, 3, 4, 5).astype(np.float32)  # HWIO, O = out / n
    want = JI.icnr_init(scale, base_init=lambda key, shape, dtype: jnp.asarray(sub))(None, (3, 3, 4, 5 * n))
    weight = torch.empty(5 * n, 4, 3, 3)
    TI.icnr_init(scale, base_init=lambda t: t.copy_(torch.from_numpy(sub.transpose(3, 2, 0, 1).copy())))(weight)
    np.testing.assert_array_equal(weight.numpy(), np.asarray(want).transpose(3, 2, 0, 1))
    layer = TUP.PixelShuffleWithLinear(4, scale)
    assert torch.equal(layer.conv.weight, layer.conv.weight[::n].repeat_interleave(n, dim=0))


@pytest.mark.parametrize("size", [(3, 3), (4, 4), (2, 5)])
def test_bilinear_upsample_initializer_matches_jax(size):
    want = np.asarray(JI.bilinear_upsample_initializer(jax.random.PRNGKey(0), size + (2, 3)))
    got = TI.bilinear_upsample_initializer(torch.empty(3, 2, *size))
    np.testing.assert_allclose(got.numpy(), want.transpose(3, 2, 0, 1), rtol=TOL, atol=0)


# ---------------------------------------------------------------------------
# SCSE gates
# ---------------------------------------------------------------------------

_GATES = [
    (JS.ChannelGate2d(), lambda c: TS.ChannelGate2d(c)),
    (JS.SpatialGate2d(reduction=4), lambda c: TS.SpatialGate2d(c, reduction=4)),
    (JS.SpatialGate2d(squeeze_channels=3), lambda c: TS.SpatialGate2d(c, squeeze_channels=3)),
    (JS.ChannelSpatialGate2d(reduction=4), lambda c: TS.ChannelSpatialGate2d(c, reduction=4)),
    (JS.SpatialGate2dV2(reduction=4), lambda c: TS.SpatialGate2dV2(c, reduction=4)),
    (JS.ChannelSpatialGate2dV2(reduction=2), lambda c: TS.ChannelSpatialGate2dV2(c, reduction=2)),
]


@pytest.mark.parametrize("case", range(len(_GATES)),
                         ids=["channel", "spatial", "spatial-squeeze", "scse", "spatial-v2", "scse-v2"])
def test_scse_gate_matches_jax(case):
    jgate, tgate = _GATES[case]
    got, want = _run_pair(jgate, tgate(16), (2, 11, 10, 16), seed=16)
    _close(got, want)


def test_spatial_gate_needs_one_of_reduction_and_squeeze_channels():
    for kwargs in ({}, {"reduction": 2, "squeeze_channels": 4}):
        with pytest.raises(ValueError):
            TS.SpatialGate2d(8, **kwargs)


# ---------------------------------------------------------------------------
# Bicubic resize: jax.image.resize's cubic, antialiased when it shrinks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size_in,size_out", [((16, 12), (40, 30)), ((40, 33), (16, 12)), ((17, 20), (23, 11)),
                                              ((9, 9), (9, 27))], ids=["up", "down", "mixed", "one-axis"])
def test_resize_bicubic_matches_jax(size_in, size_out):
    x, xt = _input((2,) + size_in + (3,), seed=17)
    want = JNF.resize_2d(jnp.asarray(x), size_out, mode="bicubic")
    got = TNF.resize_2d(xt, size_out, mode="bicubic")
    _close(got, want)


def test_resize_bicubic_is_not_torchs_bicubic():
    x, xt = _input((1, 16, 16, 1), seed=18)
    want = np.asarray(JNF.resize_2d(jnp.asarray(x), (40, 40), mode="bicubic"))
    torchs = _nhwc(torch.nn.functional.interpolate(xt, size=(40, 40), mode="bicubic", align_corners=False))
    assert np.abs(torchs - want).max() > 1e-2 * np.abs(want).max()


# ---------------------------------------------------------------------------
# The residual UNet with every upsample type
# ---------------------------------------------------------------------------


def _residual_unet_pair(upsample):
    channels = (8, 16, 32, 64)
    jencoder = JUnetEncoder(out_channels=8, num_layers=4, residual=True)
    jdecoder = JUNetDecoder(input_spec=jencoder.get_output_spec(), out_channels=channels[:-1],
                            block_type="unet_residual", upsample_block=upsample)
    jmodel = JEncoderDecoderModel(encoder=jencoder, decoder=jdecoder,
                                  head=JResizeHead(input_spec=jdecoder.get_output_spec(), num_classes=3))
    encoder = UnetEncoder(out_channels=8, num_layers=4, residual=True)
    decoder = UNetDecoder(encoder.get_output_spec(), channels[:-1], block_type="unet_residual",
                          upsample_block=upsample)
    return jmodel, EncoderDecoderModel(encoder, decoder, ResizeHead(decoder.get_output_spec(), num_classes=3))


@pytest.mark.parametrize("upsample", [t.value for t in TUP.UpsampleLayerType])
def test_residual_unet_with_each_upsample_type_matches_jax(upsample):
    jmodel, tmodel = _residual_unet_pair(upsample)
    got, want = _run_pair(jmodel, tmodel, (2, 32, 32, 3), seed=19)
    assert tuple(got.shape) == (2, 3, 32, 32)
    _close(got, want, MODEL_TOL)


def test_residual_unet_encoder_in_train_mode_matches_jax():
    x, xt = _input((2, 16, 16, 3), seed=20)
    jenc = JUnetEncoder(out_channels=8, num_layers=3, residual=True)
    variables = _init(jenc, [jnp.asarray(x)], seed=20)
    tenc = load_flax_variables(UnetEncoder(out_channels=8, num_layers=3, residual=True), variables)
    want, _ = jenc.apply(variables, jnp.asarray(x), training=True, mutable=["batch_stats"])
    for g, w in zip(tenc.train()(xt), want):
        _close(g, w, MODEL_TOL)


def test_unet_decoder_rejects_an_unknown_block_type():
    encoder = UnetEncoder(out_channels=8, num_layers=3)
    with pytest.raises(ValueError, match="block_type"):
        UNetDecoder(encoder.get_output_spec(), (8, 16), block_type="resnet")
