"""Parity of the port's mobile encoders (EfficientNet, EfficientNet-V2,
MixNet, MobileNet V2 / V3) and their blocks with the JAX package, on the CPU.

The flax variables are seeded numpy values in the shapes of the flax init
(``jax.eval_shape``), and they reach the torch modules through
``load_flax_variables``.  Tensors are NHWC in JAX and NCHW in the port.
Each module runs in eval mode, and in train mode, where the running
statistics the forward leaves behind are held to flax's within 1e-5
(absolute + relative).  The encoders run at reduced width and depth
(``width_mult``, ``depth_mult`` or a short stage table); every factory's
module is checked against the flax tree of the same factory.

EfficientNet and MixNet pad their strided convs as flax ``SAME``; MobileNet
pads symmetrically.  The stride-2 blocks run on even inputs, where the two
differ, and on odd ones.

Tolerances: 1e-5 * max|ref| for one block (``TOL``), 1e-4 * max|ref|
(``MODEL_TOL``) for encoders, where the rounding differences of XLA's and
torch's convolutions add up through the layers.  In train mode the encoders
run at twice the size (128^2 and 132^2): at 64^2 the stride-32 BatchNorms
normalise over 2 x 2 x 2 values, and there MobileNetV2's last map is
conditioned to no better than ~3e-4 (against a float64 run of the port,
flax's fp32 result is 2.6e-4 * max off, the port's 5.7e-5; at 128^2 7.2e-5
and 2.3e-5).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_toolbelt_tpu.nn import activations as jact
from pytorch_toolbelt_tpu.zoo.encoders import efficientnet as jeff
from pytorch_toolbelt_tpu.zoo.encoders import efficientnet_v2 as jeff2
from pytorch_toolbelt_tpu.zoo.encoders import mixnet as jmixnet
from pytorch_toolbelt_tpu.zoo.encoders import mobilenet as jmobilenet
from pytorch_toolbelt_tpu_torch import zoo
from pytorch_toolbelt_tpu_torch.nn import hard_sigmoid, hard_swish
from pytorch_toolbelt_tpu_torch.zoo import (
    EfficientNetEncoder,
    EfficientNetV2Encoder,
    FusedMBConv,
    InvertedResidual,
    MBConv,
    MixBlock,
    MixConv,
    MixNetEncoder,
    MobileNetV2Encoder,
    MobileNetV3Encoder,
    load_flax_variables,
)
from pytorch_toolbelt_tpu_torch.zoo.porting import _leaves

TOL = 1e-5
MODEL_TOL = 1e-4
STATS_TOL = 1e-5


def _init(jmodule, *args, seed, **kwargs):
    """Seeded numpy values in the shapes of the flax module's variables:
    LeCun-normal kernels, BatchNorm statistics and affine parameters near
    their identity values."""
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
        raise KeyError(f"no seeded value for the flax leaf {name!r}")

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _input(shape_nhwc, seed):
    x = np.random.RandomState(seed).randn(*shape_nhwc).astype(np.float32)
    return x, torch.from_numpy(x.transpose(0, 3, 1, 2).copy())


def _close(got, want, tol):
    want = np.asarray(want)
    got = got.detach().numpy().transpose(0, 2, 3, 1)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def _spec(encoder):
    spec = encoder.get_output_spec()
    return tuple(spec.channels), tuple(spec.strides)


def _check_running_stats(tmodule, new_stats):
    """Every running statistic of ``tmodule`` against flax's updated one;
    returns how many were checked."""
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


def _run(jmodule, tmodule, x, tx, training, seed):
    """(torch output, flax output) of the pair on the same variables, the
    flax apply jitted; in train mode the running statistics are checked
    too."""
    variables = _init(jmodule, x, seed=seed)
    load_flax_variables(tmodule, variables)
    if training:
        apply = jax.jit(functools.partial(jmodule.apply, training=True, mutable=["batch_stats"]))
        want, new = apply(variables, x)
        got = tmodule.train()(tx)
        assert _check_running_stats(tmodule, new["batch_stats"]) == len(
            jax.tree_util.tree_leaves(variables["batch_stats"]))
    else:
        want = jax.jit(jmodule.apply)(variables, x)
        with torch.no_grad():
            got = tmodule.eval()(tx)
    return got, want


def _assert_fits_the_flax_tree(tmodule, jmodule, jinput):
    """Every leaf of the flax init's tree (shapes from ``jax.eval_shape``)
    has one tensor of ``tmodule`` at the bridge's path, of the shape the
    bridge's layout change gives, and every tensor has a leaf: the checks of
    ``load_flax_variables``, without data (``tmodule`` lives on the meta
    device)."""
    shapes = jax.eval_shape(lambda: jmodule.init(jax.random.PRNGKey(0), jinput))
    flat = {tuple(k.key for k in path): leaf.shape for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    leaves = list(_leaves(tmodule, ()))
    assert sorted((collection,) + path for collection, path, _, _ in leaves) == sorted(flat)
    for collection, path, tensor, transform in leaves:
        assert transform(np.broadcast_to(np.float32(0), flat[(collection,) + path])).shape == tuple(tensor.shape)
    assert len(leaves) == len(list(tmodule.parameters())) + len(
        [b for name, b in tmodule.named_buffers() if not name.endswith("num_batches_tracked")])


MODES = pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])


def test_hard_sigmoid_and_hard_swish_equal_jax_bit_for_bit():
    """``relu6(x + 3) / 6`` and ``x * relu6(x + 3) / 6`` on values around
    the kinks at -3 and 3 and far from them."""
    x = np.concatenate([np.linspace(-8, 8, 4001), [-3.0, 3.0, -3.0000002, 2.9999998, 0.0]]).astype(np.float32)
    np.testing.assert_array_equal(hard_sigmoid(torch.from_numpy(x)).numpy(), np.asarray(jact.hard_sigmoid(x)))
    np.testing.assert_array_equal(hard_swish(torch.from_numpy(x)).numpy(), np.asarray(jact.hard_swish(x)))


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

# (in, out, stride, expand, kernel, size): the residual case, then stride 2 on even and odd maps
_MBCONV = [(8, 8, 1, 1, 3, 9), (8, 12, 2, 6, 5, 10), (8, 12, 2, 6, 3, 11), (6, 6, 1, 4, 5, 8)]


@MODES
@pytest.mark.parametrize("case", _MBCONV, ids=[f"{c[0]}-{c[1]}s{c[2]}e{c[3]}k{c[4]}@{c[5]}" for c in _MBCONV])
def test_mbconv_matches_flax(case, training):
    cin, cout, stride, expand, k, size = case
    x, tx = _input((2, size, size, cin), seed=1)
    jmod = jeff.MBConv(cout, stride=stride, expand_ratio=expand, kernel_size=k)
    got, want = _run(jmod, MBConv(cin, cout, stride, expand, k), x, tx, training, seed=2)
    _close(got, want, TOL)


@MODES
@pytest.mark.parametrize("case", [(8, 8, 1, 1, 9), (8, 12, 2, 4, 10), (8, 12, 2, 1, 11)],
                         ids=["residual", "expand-s2-even", "plain-s2-odd"])
def test_fused_mbconv_matches_flax(case, training):
    cin, cout, stride, expand, size = case
    x, tx = _input((2, size, size, cin), seed=3)
    jmod = jeff2.FusedMBConv(cout, stride=stride, expand_ratio=expand)
    got, want = _run(jmod, FusedMBConv(cin, cout, stride, expand), x, tx, training, seed=4)
    _close(got, want, TOL)


@pytest.mark.parametrize("stride,size", [(1, 9), (2, 10), (2, 11)])
def test_mixconv_matches_flax(stride, size):
    """10 channels over kernels (3, 5, 7): the first group takes the remainder (4, 3, 3)."""
    x, tx = _input((2, size, size, 10), seed=5)
    jmod = jmixnet.MixConv((3, 5, 7), stride=stride)
    tmod = MixConv(10, (3, 5, 7), stride=stride)
    assert tmod.split == [4, 3, 3]
    got, want = _run(jmod, tmod, x, tx, False, seed=6)
    _close(got, want, TOL)


@MODES
@pytest.mark.parametrize("case", [(8, 8, 1, 1, (3,), True), (8, 12, 2, 6, (3, 5, 7), True),
                                  (8, 16, 2, 3, (3, 5, 7, 9), False)], ids=["residual-se", "s2-se", "s2-no-se"])
def test_mix_block_matches_flax(case, training):
    cin, cout, stride, expand, ks, se = case
    x, tx = _input((2, 10, 10, cin), seed=7)
    jmod = jmixnet.MixBlock(cout, stride=stride, expand_ratio=expand, kernel_sizes=ks, use_se=se)
    got, want = _run(jmod, MixBlock(cin, cout, stride, expand, ks, use_se=se), x, tx, training, seed=8)
    _close(got, want, TOL)


# (in, out, stride, expand, kernel, se, hs, divisible, activation, size)
_INVERTED = {
    "v2-residual": (16, 16, 1, 6, 3, False, False, False, "relu6", 9),
    "v2-s2-even": (16, 24, 2, 6, 3, False, False, False, "relu6", 10),
    "v3-se-hs-k5-s2": (24, 40, 2, 72 / 24, 5, True, True, True, None, 10),
    "v3-no-expand": (16, 16, 1, 1.0, 3, True, False, True, None, 7),
    "v3-relu-s1": (24, 24, 1, 72 / 24, 3, False, False, True, None, 9),
}


@MODES
@pytest.mark.parametrize("name", list(_INVERTED))
def test_inverted_residual_matches_flax(name, training):
    cin, cout, stride, expand, k, se, hs, divisible, activation, size = _INVERTED[name]
    x, tx = _input((2, size, size, cin), seed=9)
    jmod = jmobilenet.InvertedResidual(cout, stride=stride, expand_ratio=expand, kernel_size=k, use_se=se,
                                       use_hs=hs, divisible_hidden=divisible, activation=activation)
    tmod = InvertedResidual(cin, cout, stride, expand, kernel_size=k, use_se=se, use_hs=hs,
                            divisible_hidden=divisible, activation=activation)
    got, want = _run(jmod, tmod, x, tx, training, seed=10)
    _close(got, want, TOL)


# ---------------------------------------------------------------------------
# Encoders at reduced width and depth
# ---------------------------------------------------------------------------

_V2_SHORT = (("fused", 1, 8, 1, 1), ("fused", 4, 16, 2, 2), ("fused", 4, 16, 1, 2), ("mb", 4, 24, 2, 2),
             ("mb", 6, 32, 1, 1), ("mb", 6, 40, 1, 2))

_ENCODERS = {
    "efficientnet": (lambda: jeff.EfficientNetEncoder(width_mult=0.5, depth_mult=0.3),
                     lambda: EfficientNetEncoder(width_mult=0.5, depth_mult=0.3)),
    "efficientnet_layers": (lambda: jeff.EfficientNetEncoder(width_mult=0.5, depth_mult=0.5, layers=(1, 4)),
                            lambda: EfficientNetEncoder(width_mult=0.5, depth_mult=0.5, layers=(1, 4))),
    "efficientnet_v2": (lambda: jeff2.EfficientNetV2Encoder(config_override=_V2_SHORT),
                        lambda: EfficientNetV2Encoder(config_override=_V2_SHORT)),
    "mixnet": (lambda: jmixnet.MixNetEncoder(width_mult=0.5, depth_mult=0.3),
               lambda: MixNetEncoder(width_mult=0.5, depth_mult=0.3)),
    "mobilenet_v2": (lambda: jmobilenet.MobileNetV2Encoder(width_mult=0.5), lambda: MobileNetV2Encoder(width_mult=0.5)),
    "mobilenet_v2_hard_swish": (lambda: jmobilenet.MobileNetV2Encoder(width_mult=0.35, activation="hard_swish",
                                                                      layers=(0, 2, 4)),
                                lambda: MobileNetV2Encoder(width_mult=0.35, activation="hard_swish",
                                                           layers=(0, 2, 4))),
    "mobilenet_v3_large": (lambda: jmobilenet.MobileNetV3Encoder(), lambda: MobileNetV3Encoder()),
    "mobilenet_v3_small": (lambda: jmobilenet.MobileNetV3Encoder(small=True), lambda: MobileNetV3Encoder(small=True)),
}


@MODES
@pytest.mark.parametrize("size", [64, 66])
@pytest.mark.parametrize("name", list(_ENCODERS))
def test_encoder_matches_flax(name, size, training):
    jfactory, tfactory = _ENCODERS[name]
    jenc, tenc = jfactory(), tfactory()
    assert _spec(tenc) == _spec(jenc)
    if training:
        size *= 2
    x, tx = _input((2, size, size, 3), seed=11)
    got, want = _run(jenc, tenc, x, tx, training, seed=12)
    assert len(got) == len(want) == len(tenc.get_output_spec())
    for g, w, c in zip(got, want, tenc.get_output_spec().channels):
        assert g.shape[1] == c
        _close(g, w, MODEL_TOL)


_FACTORIES = [f"efficientnet_b{i}_encoder" for i in range(8)] + [
    "efficientnet_v2_s_encoder", "efficientnet_v2_m_encoder", "efficientnet_v2_l_encoder", "mixnet_s_encoder",
    "mixnet_m_encoder", "mixnet_xl_encoder", "MobileNetV2Encoder", "mobilenet_v3_large_encoder",
    "mobilenet_v3_small_encoder"]
_JAX_MODULES = (jeff, jeff2, jmixnet, jmobilenet)


@pytest.mark.parametrize("name", _FACTORIES)
def test_factories_fit_the_jax_parameter_tree(name):
    """Each published width and depth: the port's module fits the flax tree
    of the JAX factory of the same name, and the specs agree."""
    jenc = next(getattr(m, name) for m in _JAX_MODULES if hasattr(m, name))()
    with torch.device("meta"):
        tenc = getattr(zoo, name)()
    _assert_fits_the_flax_tree(tenc, jenc, jnp.zeros((1, 32, 32, 3)))
    assert _spec(tenc) == _spec(jenc)
