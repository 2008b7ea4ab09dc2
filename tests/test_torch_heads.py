"""Parity of the port's heads, global pools, FPN fusion blocks and
initialisers with the JAX package, on the CPU; the weight bridge's new
leaves (``Dense``, raw parameters) and its failures; the slice's names.

The flax variables are seeded numpy values in the shapes of the flax init
(``jax.eval_shape``), and they reach the torch modules through
``load_flax_variables``.  Tensors are NHWC in JAX and NCHW in the port.
Modules with batch norms or dropout run in eval mode, and in train mode
with dropout 0, where the running statistics are held to flax's within
1e-5 (absolute + relative).

Tolerances: 1e-5 * max|ref| for pools and single blocks, 1e-4 * max|ref|
(``MODEL_TOL``) for heads; bit for bit for the pixel shuffle, which only
moves values.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from einops import rearrange

from pytorch_toolbelt_tpu.nn import fpn as jfpn
from pytorch_toolbelt_tpu.nn import initialization as jinit
from pytorch_toolbelt_tpu.nn import pooling as jpool
from pytorch_toolbelt_tpu.zoo import EncoderDecoderModel as JEncoderDecoderModel
from pytorch_toolbelt_tpu.zoo.decoders import bifpn as jbifpn
from pytorch_toolbelt_tpu.zoo.heads import classification as jcls
from pytorch_toolbelt_tpu.zoo.heads import deep_supervision as jds
from pytorch_toolbelt_tpu.zoo.heads import hypercolumn as jhc
from pytorch_toolbelt_tpu.zoo.heads import progressive_shuffle as jps
from pytorch_toolbelt_tpu.zoo.heads import segformer as jsf
from pytorch_toolbelt_tpu.zoo.encoders import resnet as jresnet
from pytorch_toolbelt_tpu_torch import modules as tmodules
from pytorch_toolbelt_tpu_torch import nn as tnn
from pytorch_toolbelt_tpu_torch.core import AbstractHead, FeatureMapsSpec
from pytorch_toolbelt_tpu_torch.zoo import (
    BiFPNDecoder,
    DeepSupervisionHead,
    EncoderDecoderModel,
    FullyConnectedClassificationHead,
    GeneralizedMeanPoolingClassificationHead,
    GenericPoolingClassificationHead,
    GlobalAveragePoolingClassificationHead,
    GlobalMaxAvgPoolingClassificationHead,
    GlobalMaxAvgSumPoolingClassificationHead,
    GlobalMaxPoolingClassificationHead,
    HypercolumnHead,
    ProgressiveShuffleHead,
    SegFormerHead,
    flax_name_map,
    ResNetEncoder,
    load_flax_variables,
)
from pytorch_toolbelt_tpu_torch.zoo.porting import _leaves

TOL = 1e-5
MODEL_TOL = 1e-4
STATS_TOL = 1e-5


def _init(jmodule, *args, seed, **kwargs):
    """Seeded numpy values in the shapes of the flax module's variables:
    LeCun-normal kernels, BatchNorm statistics and affine parameters near
    their identity values; GeM's raw exponent near 3, the pools' weights
    and BiFPN's fusion weights around 1."""
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
        if name == "p":
            return (3.0 + 0.1 * rng.randn(*shape)).astype(np.float32)
        if name in ("weights", "w1", "w2"):
            return (1.0 + 0.3 * rng.randn(*shape)).astype(np.float32)
        raise KeyError(f"no seeded value for the flax leaf {name!r}")

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _maps(shapes_nhwc, seed, positive=False):
    rng = np.random.RandomState(seed)
    xs = [(rng.rand(*s) if positive else rng.randn(*s)).astype(np.float32) for s in shapes_nhwc]
    return [jnp.asarray(x) for x in xs], [torch.from_numpy(x.transpose(0, 3, 1, 2).copy()) for x in xs]


def _close(got, want, tol):
    """Tensor, list, tuple or dict outputs; 4-D tensors are NCHW here and
    NHWC in JAX."""
    if isinstance(want, dict):
        assert set(got) == set(want)
        for key in want:
            _close(got[key], want[key], tol)
        return
    if isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, tol)
        return
    want = np.asarray(want)
    got = got.detach().float().numpy()
    if got.ndim == 4:
        got = got.transpose(0, 2, 3, 1)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def _check_running_stats(tmodule, new_stats):
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


def _run(jmodule, tmodule, jargs, targs, training, seed, jkwargs=None, tkwargs=None):
    """(torch output, flax output) of the pair on the same variables; in
    train mode the running statistics are checked too."""
    jkwargs, tkwargs = jkwargs or {}, tkwargs or {}
    variables = _init(jmodule, *jargs, seed=seed, **jkwargs)
    load_flax_variables(tmodule, variables)
    if training:
        want, new = jmodule.apply(variables, *jargs, training=True, mutable=["batch_stats"], **jkwargs)
        got = tmodule.train()(*targs, **tkwargs)
        assert _check_running_stats(tmodule, new.get("batch_stats", {})) == len(
            jax.tree_util.tree_leaves(variables.get("batch_stats", {})))
    else:
        want = jmodule.apply(variables, *jargs, **jkwargs)
        with torch.no_grad():
            got = tmodule.eval()(*targs, **tkwargs)
    return got, want


MODES = pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])


# ---------------------------------------------------------------------------
# The nine global pools (and the GWAP alias)
# ---------------------------------------------------------------------------

_POOLS = {
    "avg": (lambda: jpool.GlobalAvgPool2d(), lambda c: tnn.GlobalAvgPool2d()),
    "avg_flat": (lambda: jpool.GlobalAvgPool2d(flatten=True), lambda c: tnn.GlobalAvgPool2d(flatten=True)),
    "max": (lambda: jpool.GlobalMaxPool2d(), lambda c: tnn.GlobalMaxPool2d()),
    "kmax": (lambda: jpool.GlobalKMaxPool2d(k=3), lambda c: tnn.GlobalKMaxPool2d(k=3)),
    "kmax_fixed_flat": (lambda: jpool.GlobalKMaxPool2d(k=5, trainable=False, flatten=True),
                        lambda c: tnn.GlobalKMaxPool2d(k=5, trainable=False, flatten=True)),
    "gwap": (lambda: jpool.GlobalWeightedAvgPool2d(), lambda c: tnn.GlobalWeightedAvgPool2d(c)),
    "gwap_alias_flat": (lambda: jpool.GWAP(flatten=True), lambda c: tnn.GWAP(c, flatten=True)),
    "rms": (lambda: jpool.RMSPool(), lambda c: tnn.RMSPool()),
    "rank": (lambda: jpool.GlobalRankPooling(spatial_size=42), lambda c: tnn.GlobalRankPooling(c, 42)),
    "rank_flat": (lambda: jpool.GlobalRankPooling(spatial_size=42, flatten=True),
                  lambda c: tnn.GlobalRankPooling(c, 42, flatten=True)),
    "gem": (lambda: jpool.GeneralizedMeanPooling2d(), lambda c: tnn.GeneralizedMeanPooling2d()),
    "gem_l2_flat": (lambda: jpool.GeneralizedMeanPooling2d(p=2.0, l2_normalize=True, flatten=True),
                    lambda c: tnn.GeneralizedMeanPooling2d(p=2.0, l2_normalize=True, flatten=True)),
    "max_avg": (lambda: jpool.GlobalMaxAvgPooling2d(), lambda c: tnn.GlobalMaxAvgPooling2d()),
}


@pytest.mark.parametrize("name", list(_POOLS))
def test_global_pool_matches_flax(name):
    jfactory, tfactory = _POOLS[name]
    (jx,), (tx,) = _maps([(3, 6, 7, 5)], seed=1, positive=name.startswith("gem"))
    got, want = _run(jfactory(), tfactory(5), (jx,), (tx,), False, seed=2)
    _close(got, want, TOL)


@MODES
def test_mil_pooling_matches_flax(training):
    (jx,), (tx,) = _maps([(3, 6, 7, 8)], seed=3)
    got, want = _run(jpool.MILCustomPoolingModule(4, reduction=2), tnn.MILCustomPoolingModule(8, 4, reduction=2),
                     (jx,), (tx,), training, seed=4, jkwargs={})
    _close(got, want, TOL)


# ---------------------------------------------------------------------------
# FPN fusion blocks
# ---------------------------------------------------------------------------


@MODES
@pytest.mark.parametrize("size", [16, 17])
def test_fpn_context_block_matches_flax(size, training):
    """Pools of 2, 4 and 8 floor as flax's VALID pools do; 17 leaves a row."""
    (jx,), (tx,) = _maps([(2, size, size, 16)], seed=5)
    got, want = _run(jfpn.FPNContextBlock(8), tnn.FPNContextBlock(16, 8), (jx,), (tx,), training, seed=6)
    _close(got, want, TOL)


@MODES
def test_fpn_bottleneck_block_matches_flax(training):
    (jx,), (tx,) = _maps([(2, 9, 10, 6)], seed=7)
    got, want = _run(jfpn.FPNBottleneckBlock(8, activation="leaky_relu"),
                     tnn.FPNBottleneckBlock(6, 8, activation="leaky_relu"), (jx,), (tx,), training, seed=8)
    _close(got, want, TOL)


_FUSE = {
    "fuse": (lambda: jfpn.FPNFuse(), lambda: tnn.FPNFuse()),
    "fuse_nearest": (lambda: jfpn.FPNFuse(mode="nearest"), lambda: tnn.FPNFuse(mode="nearest")),
    "fuse_sum_aligned": (lambda: jfpn.FPNFuseSum(align_corners=True), lambda: tnn.FPNFuseSum(align_corners=True)),
    "hff": (lambda: jfpn.HFF(), lambda: tnn.HFF()),
    "hff_bilinear_sizes": (lambda: jfpn.HFF(mode="bilinear", sizes=[(12, 10), (6, 5)]),
                           lambda: tnn.HFF(mode="bilinear", sizes=[(12, 10), (6, 5)])),
}


@pytest.mark.parametrize("name", list(_FUSE))
def test_fpn_fusion_matches_flax(name):
    jfactory, tfactory = _FUSE[name]
    jmaps, tmaps = _maps([(2, 12, 10, 4), (2, 6, 5, 4), (2, 3, 3, 4)], seed=9)
    _close(tfactory()(tmaps), jfactory().apply({}, jmaps), TOL)


# ---------------------------------------------------------------------------
# Heads
# ---------------------------------------------------------------------------

_SPEC4 = FeatureMapsSpec((4, 6, 8, 10), (4, 8, 16, 32))
_SHAPES4 = [(2, 16, 16, 4), (2, 8, 8, 6), (2, 4, 4, 8), (2, 2, 2, 10)]


def _max_avg_jax(x):  # NHWC -> [B, 2C]
    return jnp.concatenate([x.max(axis=(1, 2)), x.mean(axis=(1, 2))], axis=-1)


def _max_avg_torch(x):  # NCHW -> [B, 2C]
    return torch.cat([x.amax(dim=(2, 3)), x.mean(dim=(2, 3))], dim=1)


_CLS = {
    "generic": (lambda s: jcls.GenericPoolingClassificationHead(s, 5),
                lambda s: GenericPoolingClassificationHead(s, 5)),
    "generic_pool_fn": (lambda s: jcls.GenericPoolingClassificationHead(s, 5, pool_fn=_max_avg_jax),
                        lambda s: GenericPoolingClassificationHead(s, 5, pool_fn=_max_avg_torch)),
    "avg": (lambda s: jcls.GlobalAveragePoolingClassificationHead(s, 5),
            lambda s: GlobalAveragePoolingClassificationHead(s, 5)),
    "max_index_1": (lambda s: jcls.GlobalMaxPoolingClassificationHead(s, 5, feature_map_index=1),
                    lambda s: GlobalMaxPoolingClassificationHead(s, 5, feature_map_index=1)),
    "gem": (lambda s: jcls.GeneralizedMeanPoolingClassificationHead(s, 5),
            lambda s: GeneralizedMeanPoolingClassificationHead(s, 5)),
    "fully_connected": (lambda s: jcls.FullyConnectedClassificationHead(s, 5, feature_map_index=2),
                        lambda s: FullyConnectedClassificationHead(s, 5, feature_map_index=2)),
    "max_avg": (lambda s: jcls.GlobalMaxAvgPoolingClassificationHead(s, 5),
                lambda s: GlobalMaxAvgPoolingClassificationHead(s, 5)),
    "max_avg_sum": (lambda s: jcls.GlobalMaxAvgSumPoolingClassificationHead(s, 5),
                    lambda s: GlobalMaxAvgSumPoolingClassificationHead(s, 5)),
}


@MODES
@pytest.mark.parametrize("name", list(_CLS))
def test_classification_head_matches_flax(name, training):
    jfactory, tfactory = _CLS[name]
    jhead, thead = jfactory(_SPEC4), tfactory(_SPEC4)
    assert isinstance(thead, AbstractHead)
    assert thead.get_output_spec() == FeatureMapsSpec(jhead.get_output_spec().channels, (-1,))
    jmaps, tmaps = _maps(_SHAPES4, seed=10, positive=name == "gem")
    got, want = _run(jhead, thead, (jmaps,), (tmaps,), training, seed=11)
    _close(got, want, MODEL_TOL)


_HEADS = {
    "hypercolumn": (lambda s: jhc.HypercolumnHead(s, 3, mid_channels=8),
                    lambda s: HypercolumnHead(s, 3, mid_channels=8), True),
    "hypercolumn_named_nearest": (
        lambda s: jhc.HypercolumnHead(s, 3, mid_channels=8, output_name="mask", interpolation_mode="nearest",
                                      activation="prelu"),
        lambda s: HypercolumnHead(s, 3, mid_channels=8, output_name="mask", interpolation_mode="nearest",
                                  activation="prelu"), True),
    "deep_supervision": (lambda s: jds.DeepSupervisionHead(s, 3), lambda s: DeepSupervisionHead(s, 3), False),
    "deep_supervision_dict": (lambda s: jds.DeepSupervisionHead(s, 3, output_name_prefix="mask"),
                              lambda s: DeepSupervisionHead(s, 3, output_name_prefix="mask"), False),
    "progressive_shuffle": (lambda s: jps.ProgressiveShuffleHead(s, 3), lambda s: ProgressiveShuffleHead(s, 3),
                            False),
    "progressive_shuffle_named": (lambda s: jps.ProgressiveShuffleHead(s, 2, output_name="mask", reduction_factor=4),
                                  lambda s: ProgressiveShuffleHead(s, 2, output_name="mask", reduction_factor=4),
                                  False),
    "segformer": (lambda s: jsf.SegFormerHead(s, 3, embedding_dim=8), lambda s: SegFormerHead(s, 3, embedding_dim=8),
                  True),
    "segformer_supervision": (lambda s: jsf.SegFormerHead(s, 3, embedding_dim=8, with_supervision=True),
                              lambda s: SegFormerHead(s, 3, embedding_dim=8, with_supervision=True), True),
    "segformer_supervision_named": (
        lambda s: jsf.SegFormerHead(s, 3, embedding_dim=8, with_supervision=True, output_name="mask"),
        lambda s: SegFormerHead(s, 3, embedding_dim=8, with_supervision=True, output_name="mask"), True),
}


@MODES
@pytest.mark.parametrize("name", list(_HEADS))
def test_segmentation_head_matches_flax(name, training):
    jfactory, tfactory, sized = _HEADS[name]
    jhead, thead = jfactory(_SPEC4), tfactory(_SPEC4)
    assert isinstance(thead, AbstractHead)
    assert thead.get_output_spec() == FeatureMapsSpec(jhead.get_output_spec().channels,
                                                      jhead.get_output_spec().strides)
    jmaps, tmaps = _maps(_SHAPES4, seed=12)
    size = {"output_size": (64, 64)} if sized else {}
    got, want = _run(jhead, thead, (jmaps,), (tmaps,), training, seed=13, jkwargs=size, tkwargs=size)
    _close(got, want, MODEL_TOL)


def test_progressive_shuffle_rearrange_is_torch_pixel_shuffle():
    x = np.random.RandomState(14).randn(2, 3, 5, 12).astype(np.float32)  # NHWC, 12 = 3 channels x 2 x 2
    want = rearrange(x, "b h w (c s1 s2) -> b (h s1) (w s2) c", s1=2, s2=2)
    got = F.pixel_shuffle(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()), 2)
    np.testing.assert_array_equal(got.numpy().transpose(0, 2, 3, 1), want)


def test_heads_and_pools_run_in_float64_on_the_inputs_device():
    """Nothing in a forward is made on a fixed device or dtype: the heads
    that broadcast or make constants follow their input."""
    maps = [torch.randn(s[0], s[3], s[1], s[2], dtype=torch.float64) for s in _SHAPES4]
    for thead in (SegFormerHead(_SPEC4, 3, embedding_dim=8), HypercolumnHead(_SPEC4, 3, mid_channels=8)):
        out = thead.eval().to(torch.float64)(maps, output_size=(32, 32))
        assert out.dtype == torch.float64 and out.shape == (2, 3, 32, 32)
    out = tnn.GlobalKMaxPool2d(k=2, trainable=False).to(torch.float64)(maps[0])
    assert out.dtype == torch.float64 and out.shape == (2, 4, 1, 1)


# ---------------------------------------------------------------------------
# Initialisers
# ---------------------------------------------------------------------------


def test_zeros_kernel_init_and_background_bias_match_jax():
    weight = torch.randn(6, 4, 3, 3)
    assert tnn.zeros_kernel_init(weight) is weight and not weight.any()
    np.testing.assert_array_equal(np.asarray(jinit.zeros_kernel_init(None, (3, 3, 4, 6))),
                                  weight.numpy().transpose(2, 3, 1, 0))
    for p in (0.95, 0.6):
        bias = torch.empty(5)
        assert tnn.first_class_background_init_bias(p)(bias) is bias
        want = np.asarray(jinit.first_class_background_init_bias(p)(None, (5,)))
        np.testing.assert_allclose(bias.numpy(), want, rtol=1e-6)


# ---------------------------------------------------------------------------
# The weight bridge: Dense, raw parameters, failures
# ---------------------------------------------------------------------------


def _bifpn_gem_dense_pair():
    """A one-block-per-stage ResNet (layers 1-4) + BiFPN + GeM classification
    head (GeM's ``p`` and BiFPN's ``w1``/``w2`` are raw parameters, the head
    a Dense)."""
    kwargs = dict(stage_blocks=(1, 1, 1, 1), layers=(1, 2, 3, 4))
    jenc, tenc = jresnet.ResNetEncoder(**kwargs), ResNetEncoder(**kwargs)
    jdec = jbifpn.BiFPNDecoder(jenc.get_output_spec(), out_channels=8, num_layers=1)
    tdec = BiFPNDecoder(tenc.get_output_spec(), out_channels=8, num_layers=1)
    jmodel = JEncoderDecoderModel(encoder=jenc, decoder=jdec,
                                  head=jcls.GeneralizedMeanPoolingClassificationHead(jdec.get_output_spec(), 4))
    tmodel = EncoderDecoderModel(tenc, tdec, GeneralizedMeanPoolingClassificationHead(tdec.get_output_spec(), 4))
    (jx,), (tx,) = _maps([(2, 32, 32, 3)], seed=15)
    return jmodel, tmodel, jx, tx


def test_bridge_fills_bifpn_gem_and_dense_and_raises_on_stray_or_missing_leaves():
    jmodel, tmodel, jx, tx = _bifpn_gem_dense_pair()
    variables = _init(jmodel, jx, seed=16)
    load_flax_variables(tmodel, variables)
    names = flax_name_map(tmodel)
    assert names["head.fc.weight"] == ("params", ("head", "Dense_0", "kernel"))
    assert names["head.pool.p"] == ("params", ("head", "GeneralizedMeanPooling2d_0", "p"))
    assert names["decoder.layers.0.w2"] == ("params", ("decoder", "BiFPNBlock_0", "w2"))
    want = jmodel.apply(variables, jx)
    with torch.no_grad():
        _close(tmodel.eval()(tx), want, MODEL_TOL)

    params = variables["params"]
    stray = {"params": dict(params, head=dict(params["head"], Dense_1={"kernel": np.zeros((8, 4), np.float32)})),
             "batch_stats": variables["batch_stats"]}
    with pytest.raises(ValueError, match="unused"):
        load_flax_variables(tmodel, stray)
    block = {k: v for k, v in params["decoder"]["BiFPNBlock_0"].items() if k != "w1"}
    missing = {"params": dict(params, decoder=dict(params["decoder"], BiFPNBlock_0=block)),
               "batch_stats": variables["batch_stats"]}
    with pytest.raises(KeyError, match="w1"):
        load_flax_variables(tmodel, missing)
    head = {k: v for k, v in params["head"].items() if k != "GeneralizedMeanPooling2d_0"}
    with pytest.raises(KeyError, match="GeneralizedMeanPooling2d_0"):
        load_flax_variables(tmodel, {"params": dict(params, head=head), "batch_stats": variables["batch_stats"]})
    wrong = dict(params, head=dict(params["head"], Dense_0={"kernel": np.zeros((4, 8), np.float32),
                                                           "bias": np.zeros((4,), np.float32)}))
    with pytest.raises(ValueError, match="shape"):
        load_flax_variables(tmodel, {"params": wrong, "batch_stats": variables["batch_stats"]})


# ---------------------------------------------------------------------------
# Every name of the slice's JAX modules exists in the port
# ---------------------------------------------------------------------------

_SLICE_MODULES = [
    "core.interfaces", "nn.dsconv", "nn.spp", "nn.pooling", "nn.fpn", "nn.initialization",
    "zoo.decoders.deeplab", "zoo.decoders.ppm", "zoo.decoders.can", "zoo.decoders.bifpn",
    "zoo.heads.classification", "zoo.heads.hypercolumn", "zoo.heads.deep_supervision",
    "zoo.heads.progressive_shuffle", "zoo.heads.segformer",
]


@pytest.mark.parametrize("module", _SLICE_MODULES)
def test_port_has_every_name_of_the_jax_module(module):
    jmod = importlib.import_module(f"pytorch_toolbelt_tpu.{module}")
    tmod = importlib.import_module(f"pytorch_toolbelt_tpu_torch.{module}")
    assert set(jmod.__all__) <= set(tmod.__all__)
    assert all(hasattr(tmod, name) for name in jmod.__all__)


def test_modules_namespace_has_the_decoders_heads_and_blocks():
    from pytorch_toolbelt_tpu import zoo as jzoo

    slice_names = [n for n in jzoo.__all__ if n.endswith(("Decoder", "Head")) or n.startswith("BiFPN")]
    assert len(slice_names) >= 15
    for name in slice_names + ["ASPP", "GeneralizedMeanPooling2d", "FPNFuse", "DepthwiseSeparableConv2d",
                               "FeatureMapsSpec", "FeatureMapsSpecification"]:
        assert hasattr(tmodules, name), name
