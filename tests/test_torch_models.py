"""Parity of the PyTorch port's UNet with the JAX package's flax UNet, on
the CPU: the weight bridge, the module forward in eval and train mode, and
the fused inference forward (the K2 path, here through its plain version).

The flax model is initialised from a seed; its BatchNorm statistics and
affine parameters are then replaced by seeded numpy values so the folding
and the running statistics are exercised.  Tensors are NHWC in JAX and NCHW
in the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_toolbelt_tpu.nn import activations as JA
from pytorch_toolbelt_tpu.zoo import UNetSegmentationModel as JUNet
from pytorch_toolbelt_tpu_torch.core import FeatureMapsSpec
from pytorch_toolbelt_tpu_torch.nn import Normalization, instantiate_upsample_block
from pytorch_toolbelt_tpu_torch.nn import activations as TA
from pytorch_toolbelt_tpu_torch.zoo import UnetEncoder
from pytorch_toolbelt_tpu_torch.zoo import UNetSegmentationModel, fuse_unet_inference, load_flax_variables
from pytorch_toolbelt_tpu_torch.zoo.porting import _leaves

CHANNELS, LAYERS = 8, 3


def _numpy_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, dtype=np.float32), tree)


def _perturbed_variables(jmodel, size, seed):
    variables = _numpy_tree(jmodel.init(jax.random.PRNGKey(seed), jnp.zeros((1, size, size, 3))))
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


def _pair(num_classes=2, size=32, seed=0, output_name=None):
    jmodel = JUNet(num_classes=num_classes, encoder_channels=CHANNELS, num_layers=LAYERS, output_name=output_name)
    variables = _perturbed_variables(jmodel, size, seed)
    tmodel = UNetSegmentationModel(num_classes=num_classes, encoder_channels=CHANNELS, num_layers=LAYERS,
                                   output_name=output_name)
    load_flax_variables(tmodel, variables)
    return jmodel, variables, tmodel


def _input(batch, size, seed):
    x = np.random.RandomState(seed).rand(batch, size, size, 3).astype(np.float32)
    return x, torch.from_numpy(x.transpose(0, 3, 1, 2).copy())


def _nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def test_bridged_unet_eval_matches_flax():
    jmodel, variables, tmodel = _pair()
    x, xt = _input(2, 32, 1)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = _nhwc(tmodel.eval()(xt))
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_bridged_unet_train_matches_flax():
    """Train mode: the outputs agree directly.  Running means agree
    directly; torch updates running_var with the unbiased batch variance and
    flax with the biased one, so the variances agree after n/(n-1)."""
    jmodel, variables, tmodel = _pair(seed=1)
    x, xt = _input(2, 32, 2)
    want, new_stats = jmodel.apply(variables, jnp.asarray(x), training=True, mutable=["batch_stats"])
    new_vars = {"batch_stats": _numpy_tree(new_stats["batch_stats"])}

    counts = {}

    def record(module, inputs, _):
        counts[id(module.running_var)] = inputs[0].shape[0] * inputs[0].shape[2] * inputs[0].shape[3]

    hooks = [m.register_forward_hook(record) for m in tmodel.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    got = _nhwc(tmodel.train()(xt))
    for h in hooks:
        h.remove()
    want = np.asarray(want)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()

    checked = 0
    for collection, path, tensor, _ in _leaves(tmodel, ()):
        if collection != "batch_stats":
            continue
        node_old, node_new = variables["batch_stats"], new_vars["batch_stats"]
        for key in path:
            node_old, node_new = node_old[key], node_new[key]
        old, new = node_old, node_new
        got_stat = tensor.detach().numpy()
        if path[-1] == "mean":
            np.testing.assert_allclose(got_stat, new, rtol=1e-4, atol=1e-5)
        else:
            n = counts[id(tensor)]
            torch_batch = (got_stat - 0.9 * old) / 0.1
            flax_batch = (new - 0.9 * old) / 0.1
            np.testing.assert_allclose(torch_batch * (n - 1) / n, flax_batch, rtol=1e-4, atol=1e-5)
        checked += 1
    assert checked == 4 * (2 * LAYERS - 1)


def test_fused_unet_cpu_matches_flax():
    jmodel, variables, tmodel = _pair(num_classes=3, size=64, seed=2)
    x, xt = _input(2, 64, 3)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x)))
    got = fuse_unet_inference(tmodel.eval())(xt)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 3, 64, 64)
    assert np.abs(_nhwc(got) - want).max() <= 2e-2 * np.abs(want).max()


def test_fused_unet_output_name_dict():
    _, _, tmodel = _pair(num_classes=1, output_name="mask")
    out = fuse_unet_inference(tmodel.eval())(torch.zeros(1, 3, 32, 32))
    assert set(out) == {"mask"} and out["mask"].shape == (1, 1, 32, 32)


def test_fuse_unet_inference_rejects_unsupported_config():
    with pytest.raises(NotImplementedError):
        fuse_unet_inference(UNetSegmentationModel(num_classes=1, encoder_channels=8, num_layers=2, activation="silu"))
    with pytest.raises(NotImplementedError):
        fuse_unet_inference(UNetSegmentationModel(num_classes=1, encoder_channels=8, num_layers=2,
                                                  normalization="instance_norm"))


def test_bridge_raises_on_unused_and_missing_leaves():
    jmodel = JUNet(num_classes=1, encoder_channels=CHANNELS, num_layers=LAYERS)
    variables = _numpy_tree(jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))
    tmodel = UNetSegmentationModel(num_classes=1, encoder_channels=CHANNELS, num_layers=LAYERS)
    extra = {"params": dict(variables["params"], Stray_0={"kernel": np.zeros((1,), np.float32)}),
             "batch_stats": variables["batch_stats"]}
    with pytest.raises(ValueError, match="unused"):
        load_flax_variables(tmodel, extra)
    missing = {"params": variables["params"]}
    with pytest.raises(KeyError):
        load_flax_variables(tmodel, missing)
    wrong = UNetSegmentationModel(num_classes=2, encoder_channels=CHANNELS, num_layers=LAYERS)
    with pytest.raises(ValueError, match="shape"):
        load_flax_variables(wrong, variables)


@pytest.mark.parametrize("kind,cls", [("bn", torch.nn.BatchNorm2d), ("BatchNorm2d", torch.nn.BatchNorm2d),
                                      ("gn", torch.nn.GroupNorm), ("instance", torch.nn.InstanceNorm2d)])
def test_normalization_aliases(kind, cls):
    assert isinstance(Normalization(kind, 32).norm, cls)
    with pytest.raises(KeyError):
        Normalization("unknown", 32)


def test_group_norm_unet_bridges_and_matches_flax():
    # both packages default to 32 groups, so the narrowest stage has 32 channels
    jmodel = JUNet(num_classes=1, encoder_channels=32, num_layers=2, normalization="group_norm")
    variables = _numpy_tree(jmodel.init(jax.random.PRNGKey(3), jnp.zeros((1, 16, 16, 3))))
    tmodel = UNetSegmentationModel(num_classes=1, encoder_channels=32, num_layers=2, normalization="group_norm")
    load_flax_variables(tmodel, variables)
    x, xt = _input(1, 16, 4)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = _nhwc(tmodel.eval()(xt))
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("name", sorted(TA._ACTIVATIONS))
def test_activations_match_jax(name):
    x = np.linspace(-6.0, 6.0, 97, dtype=np.float32)
    want = np.asarray(JA.instantiate_activation_block(name)(jnp.asarray(x)))
    got = TA.instantiate_activation_block(name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_leaky_relu_slope_and_unknown_names():
    x = np.linspace(-2.0, 2.0, 9, dtype=np.float32)
    want = np.asarray(JA.instantiate_activation_block("leaky_relu", slope=0.2)(jnp.asarray(x)))
    got = TA.instantiate_activation_block("leaky_relu", slope=0.2)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    with pytest.raises(KeyError):
        TA.get_activation_fn("prelu")


def test_feature_maps_spec_and_encoder_spec():
    spec = FeatureMapsSpec(channels=[8, 16, 32], strides=[1, 2, 4])
    assert len(spec) == 3 and spec.get_index_of_largest_feature_map() == 0
    assert [tuple(t.shape) for t in spec.get_dummy_input((16, 8))] == [(1, 8, 16, 8), (1, 16, 8, 4), (1, 32, 4, 2)]
    with pytest.raises(ValueError):
        FeatureMapsSpec(channels=[8, 16], strides=[1])
    encoder = UnetEncoder(out_channels=8, num_layers=3)
    assert encoder.channels == (8, 16, 32) and encoder.strides == (1, 2, 4)
    maps = encoder(torch.zeros(1, 3, 16, 16))
    assert [tuple(m.shape) for m in maps] == [(1, 8, 16, 16), (1, 16, 8, 8), (1, 32, 4, 4)]
    with pytest.raises(NotImplementedError):
        UnetEncoder(residual=True)
    with pytest.raises(NotImplementedError):
        instantiate_upsample_block("nearest")
