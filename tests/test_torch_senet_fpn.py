"""Parity of the port's SENet encoders, FPN decoder and the config-3 model
(SEResNeXt50-FPN(128), 19 classes) with the JAX package, on the CPU.

The flax modules are initialised from a seed; their BatchNorm statistics and
affine parameters are then replaced by seeded numpy values, and the weights
reach the torch modules through ``load_flax_variables``.  Tensors are NHWC in
JAX and NCHW in the port.

Tolerance: 1e-4 * max|ref| in fp32.  XLA and torch's CPU convolutions add in
another order, and the rounding differences (~1e-7 relative per op) grow
through the up to 50 conv/BN layers; a wrong weight or layout shows as an
error of the order of the output itself.  The full-depth encoder in train
mode is held to 5e-4 * max|ref|: each of its 53 BatchNorms divides by a
batch standard deviation, which scales the accumulated rounding up again
(measured 2.1e-4 at stride 32, 5e-7 at stride 2).
"""

import copy

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_toolbelt_tpu.zoo import EncoderDecoderModel as JEncoderDecoderModel
from pytorch_toolbelt_tpu.zoo import FPNDecoder as JFPNDecoder
from pytorch_toolbelt_tpu.zoo import ResizeHead as JResizeHead
from pytorch_toolbelt_tpu.zoo.encoders import senet as jsenet
from pytorch_toolbelt_tpu_torch.core import FeatureMapsSpec
from pytorch_toolbelt_tpu_torch.zoo import EncoderDecoderModel, FPNDecoder, ResizeHead, SENetEncoder
from pytorch_toolbelt_tpu_torch.zoo import load_flax_variables, se_resnext50_encoder
from pytorch_toolbelt_tpu_torch.zoo.encoders import senet
from pytorch_toolbelt_tpu_torch.zoo.porting import _leaves

TOL = 1e-4
TRAIN_TOL = 5e-4  # full depth, train mode (see above)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, dtype=np.float32), tree)


def _init(jmodule, jinput, seed, **kwargs):
    """Flax variables with seeded BatchNorm statistics and affine parameters."""
    variables = _numpy_tree(jmodule.init(jax.random.PRNGKey(seed), jinput, **kwargs))
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
        return leaf

    return jax.tree_util.tree_map_with_path(perturb, variables)


def _input(shape_nhwc, seed):
    x = np.random.RandomState(seed).randn(*shape_nhwc).astype(np.float32)
    return x, torch.from_numpy(x.transpose(0, 3, 1, 2).copy())


def _nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def _spec(module):
    spec = module.get_output_spec()
    return tuple(spec.channels), tuple(spec.strides)


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("size", [7, 8, 33, 64])
def test_max_pool_ceil_matches_jax(size):
    x, xt = _input((2, size, size + 1, 3), seed=size)
    want = jsenet.max_pool_ceil(jnp.asarray(x), 3, 2)
    np.testing.assert_array_equal(_nhwc(senet.max_pool_ceil(xt, 3, 2)), np.asarray(want))


def test_grouped_kernel_transpose_matches_flax():
    """HWIO with I = in / groups, transposed (3, 2, 0, 1), is torch's
    [O, I / groups, kh, kw] with the same grouping of channels."""
    conv = fnn.Conv(12, (3, 3), feature_group_count=4, padding=((1, 1), (1, 1)), use_bias=False)
    x, xt = _input((1, 9, 9, 8), seed=1)
    variables = _numpy_tree(conv.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    kernel = variables["params"]["kernel"]
    assert kernel.shape == (3, 3, 2, 12)
    tconv = torch.nn.Conv2d(8, 12, 3, padding=1, groups=4, bias=False)
    load_flax_variables(tconv, variables)
    _close(_nhwc(tconv(xt)), conv.apply(variables, jnp.asarray(x)))


# kind, in_channels, planes, groups, reduction, stride, downsample_kernel, base_width
_BOTTLENECKS = [
    ("senet", 64, 16, 4, 4, 1, 0, 4),
    ("senet", 32, 16, 4, 4, 2, 3, 4),
    ("seresnet", 64, 16, 1, 4, 1, 0, 4),
    ("seresnet", 32, 16, 1, 4, 2, 1, 4),
    ("seresnext", 64, 16, 4, 4, 1, 0, 16),
    ("seresnext", 32, 16, 4, 4, 2, 1, 16),
]


@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("case", _BOTTLENECKS, ids=[f"{c[0]}-s{c[5]}-ds{c[6]}" for c in _BOTTLENECKS])
def test_senet_bottleneck_matches_flax(case, training):
    kind, cin, planes, groups, reduction, stride, dk, base_width = case
    jblock = jsenet.SENetBottleneck(kind=kind, planes=planes, groups=groups, reduction=reduction, stride=stride,
                                    downsample_kernel=dk, base_width=base_width)
    x, xt = _input((2, 15, 15, cin), seed=stride + dk)
    variables = _init(jblock, jnp.asarray(x), seed=3)
    tblock = senet.SENetBottleneck(cin, kind, planes, groups, reduction, stride=stride, downsample_kernel=dk,
                                   base_width=base_width)
    load_flax_variables(tblock, variables)
    if training:
        want, _ = jblock.apply(variables, jnp.asarray(x), training=True, mutable=["batch_stats"])
        got = tblock.train()(xt)
    else:
        want = jblock.apply(variables, jnp.asarray(x))
        with torch.no_grad():
            got = tblock.eval()(xt)
    _close(_nhwc(got), want)


@pytest.mark.parametrize("layers", [None, (1, 2, 4)])
def test_reduced_seresnext_encoder_matches_flax_in_eval_and_train(layers):
    kwargs = dict(kind="seresnext", stage_blocks=(1, 1, 1, 1), groups=32, base_width=4, layers=layers)
    jenc = jsenet.SENetEncoder(**kwargs)
    x, xt = _input((2, 64, 64, 3), seed=4)
    variables = _init(jenc, jnp.asarray(x), seed=4)
    tenc = load_flax_variables(SENetEncoder(**kwargs), variables)
    assert _spec(tenc) == _spec(jenc)

    want = jenc.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tenc.eval()(xt)
    assert len(got) == len(want) == (5 if layers is None else 3)
    for g, w in zip(got, want):
        _close(_nhwc(g), w)

    # train mode: batch statistics, and the running means move as flax's do
    # (momentum 0.01 in torch's convention is flax's 0.99)
    want, new_stats = jenc.apply(variables, jnp.asarray(x), training=True, mutable=["batch_stats"])
    got = tenc.train()(xt)
    for g, w in zip(got, want):
        _close(_nhwc(g), w)
    new_means = {}
    jax.tree_util.tree_map_with_path(
        lambda p, a: new_means.__setitem__(tuple(k.key for k in p), np.asarray(a)), new_stats["batch_stats"])
    means = [(path, t) for col, path, t, _ in _leaves(tenc, ()) if col == "batch_stats" and path[-1] == "mean"]
    assert len(means) == len([m for m in tenc.modules() if isinstance(m, torch.nn.BatchNorm2d)])
    for path, tensor in means:
        np.testing.assert_allclose(tensor.detach().numpy(), new_means[path], rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def config3_pair():
    """The whole config-3 model at its published widths (SEResNeXt50 +
    FPN(128) + ResizeHead(19)), at 64^2."""
    jencoder = jsenet.se_resnext50_encoder()
    jdecoder = JFPNDecoder(input_spec=jencoder.get_output_spec(), out_channels=128)
    jmodel = JEncoderDecoderModel(encoder=jencoder, decoder=jdecoder,
                                  head=JResizeHead(input_spec=jdecoder.get_output_spec(), num_classes=19))
    variables = _init(jmodel, jnp.zeros((1, 64, 64, 3)), seed=6)
    return jmodel, variables, load_flax_variables(_torch_config3(), variables).eval()


def _torch_config3():
    encoder = se_resnext50_encoder()
    decoder = FPNDecoder(encoder.get_output_spec(), out_channels=128)
    return EncoderDecoderModel(encoder, decoder, ResizeHead(decoder.get_output_spec(), num_classes=19))


@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
def test_full_se_resnext50_encoder_matches_flax(config3_pair, training):
    jmodel, variables, tmodel = config3_pair
    x, xt = _input((2, 64, 64, 3), seed=7)
    enc_vars = {k: v["encoder"] for k, v in variables.items()}
    if training:
        want, _ = jmodel.encoder.apply(enc_vars, jnp.asarray(x), training=True, mutable=["batch_stats"])
        got = copy.deepcopy(tmodel.encoder).train()(xt)  # the fixture's running statistics stay as they are
    else:
        want = jmodel.encoder.apply(enc_vars, jnp.asarray(x))
        with torch.no_grad():
            got = tmodel.encoder(xt)
    assert [tuple(g.shape[1:]) for g in got] == [(64, 32, 32), (256, 16, 16), (512, 8, 8), (1024, 4, 4), (2048, 2, 2)]
    for g, w in zip(got, want):
        _close(_nhwc(g), w, TRAIN_TOL if training else TOL)


def test_fpn_decoder_matches_flax():
    spec = FeatureMapsSpec((64, 256, 512, 1024, 2048), (2, 4, 8, 16, 32))
    jdec = JFPNDecoder(input_spec=jsenet.se_resnext50_encoder().get_output_spec(), out_channels=128)
    maps = [np.random.RandomState(8 + i).randn(2, 64 // s, 64 // s, c).astype(np.float32)
            for i, (c, s) in enumerate(zip(spec.channels, spec.strides))]
    variables = _init(jdec, [jnp.asarray(m) for m in maps], seed=8)
    tdec = load_flax_variables(FPNDecoder(spec, out_channels=128), variables)
    want = jdec.apply(variables, [jnp.asarray(m) for m in maps])
    with torch.no_grad():
        got = tdec([torch.from_numpy(m.transpose(0, 3, 1, 2).copy()) for m in maps])
    assert _spec(tdec) == _spec(jdec)
    assert len(got) == 5
    for g, w in zip(got, want):
        _close(_nhwc(g), w)


def test_config3_model_matches_flax(config3_pair):
    jmodel, variables, tmodel = config3_pair
    x, xt = _input((2, 64, 64, 3), seed=9)
    want = jmodel.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tmodel(xt)
    assert tuple(got.shape) == (2, 19, 64, 64)
    _close(_nhwc(got), want)


def test_bridge_raises_on_unused_senet_leaf(config3_pair):
    _, variables, _ = config3_pair
    extra = {"params": dict(variables["params"], Stray_0={"kernel": np.zeros((1,), np.float32)}),
             "batch_stats": variables["batch_stats"]}
    with pytest.raises(ValueError, match="unused"):
        load_flax_variables(_torch_config3(), extra)
