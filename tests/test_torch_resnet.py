"""Parity of the port's ResNet encoders, the stem surgery and the
ResNet34-UNet with the JAX package, on the CPU.

The flax variables are seeded numpy values in the shapes of the flax init,
and they reach the torch modules through ``load_flax_variables``.  Tensors are NHWC in JAX
and NCHW in the port.

Every stride-2 3x3 conv of the JAX ResNets is flax ``SAME``, which pads an
even input (0, 1) and an odd one (1, 1): the full-depth encoders run at 64^2
and at 65^2 so that both cases are held.  ``avg_down`` needs even sizes in
JAX (its shortcut would not match the branch), so the ResNet-D encoder runs
at 64^2 only.

Tolerances: 1e-5 * max|ref| for one conv or block, 1e-4 * max|ref| for the
full-depth encoders and the model (the rounding differences of XLA's and
torch's convolutions grow through the layers, as ``test_torch_senet_fpn.py``
argues); bit for bit for the stem-kernel tiling, which only copies.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_toolbelt_tpu.zoo import EncoderDecoderModel as JEncoderDecoderModel
from pytorch_toolbelt_tpu.zoo import ResizeHead as JResizeHead
from pytorch_toolbelt_tpu.zoo import UNetDecoder as JUNetDecoder
from pytorch_toolbelt_tpu.zoo.encoders import common as jcommon
from pytorch_toolbelt_tpu.zoo.encoders import resnet as jresnet
from pytorch_toolbelt_tpu_torch.nn import Conv2dSame
from pytorch_toolbelt_tpu_torch.zoo import EncoderDecoderModel, ResizeHead, UNetDecoder, load_flax_variables
from pytorch_toolbelt_tpu_torch.zoo.encoders import common as tcommon
from pytorch_toolbelt_tpu_torch.zoo.encoders import resnet as tresnet

TOL = 1e-5
MODEL_TOL = 1e-4
FACTORIES = jresnet.__all__[1:]


def _numpy_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, dtype=np.float32), tree)


def _init(jmodule, jinput, seed, **kwargs):
    """Seeded numpy values in the shapes of the flax module's variables:
    LeCun-normal kernels (flax's default init), BatchNorm statistics and affine parameters near their
    identity values.  The shapes come from ``jax.eval_shape`` of the flax
    init: traced, not run, which saves compiling each of a deep encoder's
    ops on the CPU."""
    shapes = jax.eval_shape(lambda: jmodule.init(jax.random.PRNGKey(seed), jinput, **kwargs))
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
        raise KeyError(f"no seeded value for the flax leaf {name!r}")

    return jax.tree_util.tree_map_with_path(fill, shapes)


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


def _spec(module):
    spec = module.get_output_spec()
    return tuple(spec.channels), tuple(spec.strides)


def _encoder_pair(jenc, tenc, size, seed, training=False):
    x, xt = _input((2, size, size, 3), seed)
    variables = _init(jenc, jnp.asarray(x), seed)
    load_flax_variables(tenc, variables)
    if training:
        want, _ = jenc.apply(variables, jnp.asarray(x), training=True, mutable=["batch_stats"])
        got = tenc.train()(xt)
    else:
        want = jenc.apply(variables, jnp.asarray(x))
        with torch.no_grad():
            got = tenc.eval()(xt)
    assert len(got) == len(want)
    return got, want


# ---------------------------------------------------------------------------
# flax SAME padding
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size", [8, 9])
@pytest.mark.parametrize("kernel,stride,dilation", [(3, 2, 1), (3, 1, 1), (1, 2, 1), (7, 2, 1), (3, 2, 2)])
def test_conv2d_same_matches_flax_same(size, kernel, stride, dilation):
    conv = fnn.Conv(5, (kernel, kernel), strides=(stride, stride), kernel_dilation=(dilation, dilation),
                    padding="SAME")
    x, xt = _input((2, size, size + 1, 3), seed=size + kernel)
    variables = _numpy_tree(conv.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    tconv = load_flax_variables(Conv2dSame(3, 5, kernel, stride=stride, dilation=dilation), variables)
    _close(tconv(xt), conv.apply(variables, jnp.asarray(x)))


def test_flax_same_at_stride_2_is_not_torchvisions_padding_on_even_inputs():
    conv = fnn.Conv(4, (3, 3), strides=(2, 2), padding="SAME", use_bias=False)
    x, xt = _input((1, 8, 8, 3), seed=1)
    variables = _numpy_tree(conv.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    want = np.asarray(conv.apply(variables, jnp.asarray(x)))
    weight = torch.from_numpy(variables["params"]["kernel"].transpose(3, 2, 0, 1).copy())
    symmetric = _nhwc(torch.nn.functional.conv2d(xt, weight, stride=2, padding=1))
    assert np.abs(symmetric - want).max() > 1e-2 * np.abs(want).max()
    _close(torch.nn.functional.conv2d(torch.nn.functional.pad(xt, (0, 1, 0, 1)), weight, stride=2), want)


# ---------------------------------------------------------------------------
# Blocks and encoders
# ---------------------------------------------------------------------------

# in, out, stride, extra
_BLOCKS = [
    ("basic", 8, 8, 1, {}),
    ("basic", 8, 16, 2, {}),
    ("basic", 8, 16, 2, {"use_se": True}),
    ("bottleneck", 16, 32, 1, {}),
    ("bottleneck", 16, 32, 2, {"groups": 4, "base_width": 8}),
    ("bottleneck", 16, 32, 2, {"avg_down": True, "use_se": True}),
]


@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("case", _BLOCKS, ids=[f"{c[0]}-s{c[3]}-{'-'.join(c[4]) or 'plain'}" for c in _BLOCKS])
def test_resnet_block_matches_flax(case, training):
    kind, cin, cout, stride, extra = case
    jcls, tcls = (jresnet.BasicBlock, tresnet.BasicBlock) if kind == "basic" else (jresnet.Bottleneck,
                                                                                    tresnet.Bottleneck)
    jblock = jcls(out_channels=cout, stride=stride, **extra)
    x, xt = _input((2, 10, 10, cin), seed=cin + stride)
    variables = _init(jblock, jnp.asarray(x), seed=2)
    tblock = load_flax_variables(tcls(cin, cout, stride, **extra), variables)
    if training:
        want, _ = jblock.apply(variables, jnp.asarray(x), training=True, mutable=["batch_stats"])
        got = tblock.train()(xt)
    else:
        want = jblock.apply(variables, jnp.asarray(x))
        with torch.no_grad():
            got = tblock.eval()(xt)
    _close(got, want)


@pytest.mark.parametrize("size", [64, 65])
@pytest.mark.parametrize("factory", ["resnet34_encoder", "seresnext50_encoder"])
def test_full_depth_encoder_matches_flax(factory, size):
    got, want = _encoder_pair(getattr(jresnet, factory)(), getattr(tresnet, factory)(), size, seed=3)
    for g, w in zip(got, want):
        _close(g, w, MODEL_TOL)
    side = [-(-size // s) for s in (2, 4, 8, 16, 32)]
    assert [tuple(g.shape[2:]) for g in got] == [(s, s) for s in side]


def test_resnet26d_encoder_matches_flax():
    got, want = _encoder_pair(jresnet.resnet26d_encoder(), tresnet.resnet26d_encoder(), 64, seed=4)
    for g, w in zip(got, want):
        _close(g, w, MODEL_TOL)


@pytest.mark.parametrize("layers", [(1, 2, 4), (0, 3)])
def test_reduced_encoder_layers_in_train_mode_match_flax(layers):
    kwargs = dict(stage_blocks=(1, 1, 1, 1), bottleneck=True, groups=2, base_width=32, use_se=True,
                  deep_stem=True, avg_down=True, stem_channels=32, layers=layers)
    jenc, tenc = jresnet.ResNetEncoder(**kwargs), tresnet.ResNetEncoder(**kwargs)
    assert _spec(tenc) == _spec(jenc)
    got, want = _encoder_pair(jenc, tenc, 64, seed=5, training=True)
    for g, w in zip(got, want):
        _close(g, w, MODEL_TOL)


@pytest.mark.parametrize("factory", FACTORIES)
def test_factory_spec_and_parameter_counts_match_flax(factory):
    """Output spec, parameter and BatchNorm-statistic counts against the flax
    init's shapes (``jax.eval_shape``: traced, not compiled)."""
    jenc = getattr(jresnet, factory)()
    shapes = jax.eval_shape(lambda: jenc.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
    with torch.device("meta"):
        tenc = getattr(tresnet, factory)()
    assert _spec(tenc) == _spec(jenc)

    def count(tree):
        return sum(int(np.prod(leaf.shape)) for leaf in jax.tree_util.tree_leaves(tree))

    assert sum(p.numel() for p in tenc.parameters()) == count(shapes["params"])
    stats = sum(b.numel() for name, b in tenc.named_buffers() if not name.endswith("num_batches_tracked"))
    assert stats == count(shapes["batch_stats"])


# ---------------------------------------------------------------------------
# The ResNet34-UNet of the chip run: resnet34 encoder, residual decoder with
# deconvolution upsampling, ResizeHead(19); decoder widths cut by 4
# ---------------------------------------------------------------------------


def test_resnet34_unet_matches_flax():
    decoder_channels = (8, 16, 32, 64)
    jencoder = jresnet.resnet34_encoder()
    jdecoder = JUNetDecoder(input_spec=jencoder.get_output_spec(), out_channels=decoder_channels,
                            block_type="unet_residual", upsample_block="deconv")
    jmodel = JEncoderDecoderModel(encoder=jencoder, decoder=jdecoder,
                                  head=JResizeHead(input_spec=jdecoder.get_output_spec(), num_classes=19))
    encoder = tresnet.resnet34_encoder()
    decoder = UNetDecoder(encoder.get_output_spec(), decoder_channels, block_type="unet_residual",
                          upsample_block="deconv")
    tmodel = EncoderDecoderModel(encoder, decoder, ResizeHead(decoder.get_output_spec(), num_classes=19))
    x, xt = _input((2, 64, 64, 3), seed=6)
    variables = _init(jmodel, jnp.asarray(x), seed=6)
    load_flax_variables(tmodel, variables)
    want = jmodel.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tmodel.eval()(xt)
    assert tuple(got.shape) == (2, 19, 64, 64)
    _close(got, want, MODEL_TOL)
    extra = {"params": dict(variables["params"], Stray_0={"kernel": np.zeros((1,), np.float32)}),
             "batch_stats": variables["batch_stats"]}
    with pytest.raises(ValueError, match="unused"):
        load_flax_variables(tmodel, extra)


# ---------------------------------------------------------------------------
# Stem surgery and GenericEncoder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("in_channels", [1, 3, 5, 7])
def test_make_n_channel_input_kernel_is_jax_transposed(in_channels):
    kernel = np.random.RandomState(7).randn(7, 7, 3, 8).astype(np.float32)  # HWIO
    want = np.asarray(jcommon.make_n_channel_input_kernel(jnp.asarray(kernel), in_channels))
    got = tcommon.make_n_channel_input_kernel(torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()), in_channels)
    np.testing.assert_array_equal(got.numpy(), want.transpose(3, 2, 0, 1))


@pytest.mark.parametrize("factory,key", [("resnet18_encoder", "conv1.weight"), ("resnet26d_encoder", "conv1.0.weight")])
def test_change_stem_input_channels_matches_jax(factory, key):
    """The stem is found in both trees, tiled to 5 inputs, and the encoders
    still agree on a 5-channel image."""
    jenc, tenc = getattr(jresnet, factory)(), getattr(tresnet, factory)()
    x3, _ = _input((2, 32, 32, 3), seed=8)
    variables = _init(jenc, jnp.asarray(x3), seed=8)
    load_flax_variables(tenc, variables)
    path = jcommon.find_stem_kernel_path(variables)
    assert tcommon.find_stem_kernel_path(tenc.state_dict()) == key
    new_variables = jcommon.change_stem_input_channels(variables, path, 5)
    assert tcommon.change_stem_input_channels(tenc, None, 5) is tenc
    x, xt = _input((2, 32, 32, 5), seed=9)
    want = jenc.apply(new_variables, jnp.asarray(x))
    with torch.no_grad():
        got = tenc.eval()(xt)
    for g, w in zip(got, want):
        _close(g, w, MODEL_TOL)
    with pytest.raises(ValueError):
        tcommon.find_stem_kernel_path(tenc.state_dict(), in_channels=3)


def test_generic_encoder_wraps_a_backbone_like_jax():
    jbackbone = jresnet.ResNetEncoder(stage_blocks=(1, 1, 1, 1), layers=(1, 3))
    jenc = jcommon.GenericEncoder(backbone=jbackbone, spec=jbackbone.get_output_spec())
    tbackbone = tresnet.ResNetEncoder(stage_blocks=(1, 1, 1, 1), layers=(1, 3))
    tenc = tcommon.GenericEncoder(tbackbone, tbackbone.get_output_spec())
    assert _spec(tenc) == _spec(jenc) == ((64, 256), (4, 16))
    got, want = _encoder_pair(jenc, tenc, 32, seed=10)
    for g, w in zip(got, want):
        _close(g, w, MODEL_TOL)
