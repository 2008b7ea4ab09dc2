"""The port's ``compat`` module and the name check of the whole port.

The name check reads only in-repo names: the public names of every module of
``pytorch_toolbelt_tpu_torch`` (its ``__all__``, or else the names it
defines) together with ``pytorch_toolbelt_tpu_torch.compat.__all__`` must
cover those of ``pytorch_toolbelt_tpu`` together with its
``compat.__all__``, apart from the names left out on purpose (ROADMAP.md,
queue 1, "Left out on purpose"), which ``LEFT_OUT`` spells out.  Then the
aliases resolve to the port's objects and the torch-native adapters work,
the Conv-BN blocks and the depthwise conv against their flax twins."""

import importlib
import pkgutil
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

import pytorch_toolbelt_tpu.compat as jcompat
import pytorch_toolbelt_tpu_torch.compat as compat
from pytorch_toolbelt_tpu_torch import zoo as tzoo
from pytorch_toolbelt_tpu_torch.zoo import WSConv, load_flax_variables
from test_torch_maxvit_nfnet import TOL, _close, _init, _nchw, _nhwc

# ROADMAP.md queue 1, "Left out on purpose": XLA / TPU-only surface that the
# port does not carry (Lovasz's ``COMPACT_SORT_KEYS`` / ``USE_CHUNKED_SORT`` and
# bi-tempered's ``_static_half_pow`` are not public names of the JAX package)
LEFT_OUT = {
    "fuse_unet_inference_s2d",
    "quantize_unet_inference_s2d",
    "COMPACT_SORT_KEYS",
    "USE_CHUNKED_SORT",
    "_static_half_pow",
    "enable_compile_cache",
    "describe_compile",
    "pallas_available",
    "pallas_grid_merge",
    "pallas_accumulate_tiles",
    "conv3x3_hcw",
    "conv3x3_eligible",
    "grid_merge_supported",
    "pallas_merge_supported",
    "chunked_sort_supported",
    "split_sort_supported",
    "convert_torch_tensor",
}


def _public_names(package: str) -> set:
    """Every module's ``__all__``, or else the non-underscore names it
    binds to objects of the package itself (and to plain values), modules
    left out."""
    root = importlib.import_module(package)
    modules = [root] + [importlib.import_module(m.name) for m in pkgutil.walk_packages(root.__path__, package + ".")]
    names = set()
    for module in modules:
        declared = getattr(module, "__all__", None)
        for name in declared if declared is not None else [n for n in vars(module) if not n.startswith("_")]:
            obj = getattr(module, name)
            if isinstance(obj, types.ModuleType):
                continue
            owner = getattr(obj, "__module__", None)
            if declared is None and owner is not None and not str(owner).startswith(package):
                continue
            names.add(name)
    return names


def test_the_port_covers_the_jax_package_apart_from_the_left_out_names():
    want = _public_names("pytorch_toolbelt_tpu") | set(jcompat.__all__)
    have = _public_names("pytorch_toolbelt_tpu_torch") | set(compat.__all__)
    missing = want - have
    assert missing <= LEFT_OUT, sorted(missing - LEFT_OUT)
    assert missing == LEFT_OUT & want  # the list names nothing the port has


def test_every_compat_name_resolves():
    assert set(jcompat.__all__) <= set(compat.__all__)
    assert dir(compat) == compat.__all__
    for name in compat.__all__:
        assert getattr(compat, name) is not None, name
    with pytest.raises(AttributeError, match="no attribute 'no_such_name'"):
        compat.no_such_name


def test_aliases_point_at_the_port():
    from pytorch_toolbelt_tpu_torch.inference import functional as tf
    from pytorch_toolbelt_tpu_torch.optimization import poly_schedule

    assert compat.TResNetMEncoder is tzoo.tresnet_m_encoder
    assert compat.MaxVitEncoder is tzoo.MaxViTEncoder
    assert compat.NFNetF0Encoder is tzoo.nfnet_f0_encoder
    assert compat.SqueezenetEncoder is tzoo.squeezenet_encoder
    assert compat.PolyLR is poly_schedule
    assert compat.torch_rot90 is tf.image_rot90_ccw
    x = torch.arange(2 * 3 * 4 * 5, dtype=torch.float32).reshape(2, 3, 4, 5)
    assert torch.equal(compat.torch_rot90_ccw(x), torch.rot90(x, 1, (2, 3)))
    assert torch.equal(compat.torch_fliplr(x), x.flip(3))
    assert torch.equal(compat.torch_transpose(x), x.transpose(2, 3))
    encoder = compat.SqueezenetEncoder(layers=(1, 2))
    assert isinstance(encoder, nn.Module) and tuple(encoder.get_output_spec().channels) == (128, 256)


def test_adapters_work_the_torch_way():
    model = nn.Sequential(nn.Conv2d(3, 4, 3), nn.BatchNorm2d(4))
    assert compat.get_non_wrapped_model(nn.DataParallel(model)) is model
    assert compat.get_non_wrapped_model(model) is model
    t = torch.zeros(2)
    assert compat.maybe_cuda(t).is_cuda == torch.cuda.is_available()
    model[0].weight.requires_grad_(False)
    assert [p is model[0].bias or p is model[1].weight or p is model[1].bias
            for p in compat.get_optimizable_parameters(model)] == [True, True, True]
    model.train()
    compat.freeze_model(model)
    assert not any(p.requires_grad for p in model.parameters()) and not model[1].training
    x = torch.randn(2, 5, 7, 7)
    assert torch.equal(compat.Mish()(x), F.mish(x)) and torch.equal(compat.Swish()(x), F.silu(x))
    assert torch.equal(compat.argmax_over_dim_1(x), x.argmax(1))
    assert torch.equal(compat.softmax_over_dim_3(x), x.softmax(3))
    assert compat.argmax_over_dim_2.__name__ == "argmax_over_dim_2"
    assert torch.equal(compat.container_to_tensor({"a": [np.ones(2)]})["a"][0], torch.ones(2, dtype=torch.float64))


@pytest.mark.parametrize("stride,size", [(1, 9), (2, 10), (2, 9)])
def test_conv_bn_matches_the_flax_twin(stride, size):
    """Conv (flax SAME) -> BatchNorm -> ReLU6, loaded through the bridge."""
    x = _nhwc((2, size, size, 4), seed=1)
    jblock, tblock = jcompat.conv_bn(4, 6, stride), compat.conv_bn(4, 6, stride)
    variables = _init(jblock, x, seed=2)
    load_flax_variables(tblock, variables)
    with torch.no_grad():
        _close(tblock.eval()(_nchw(x)), jblock.apply(variables, x), TOL)
    jblock, tblock = jcompat.conv_1x1_bn(4, 6), compat.conv_1x1_bn(4, 6)
    variables = _init(jblock, x, seed=3)
    load_flax_variables(tblock, variables)
    with torch.no_grad():
        _close(tblock.eval()(_nchw(x)), jblock.apply(variables, x), TOL)


def test_dwconv_matches_the_flax_twin():
    x = _nhwc((2, 6, 7, 8), seed=4)
    jconv, tconv = jcompat.DWConv(8), compat.DWConv(8)
    variables = _init(jconv, x, seed=5)
    load_flax_variables(tconv, variables)
    with torch.no_grad():
        _close(tconv(_nchw(x)), jconv.apply(variables, x), TOL)


def test_make_n_channel_input_tiles_the_kernel_as_the_jax_package():
    """The weight's input channels are tiled then cut, as the JAX package
    tiles an HWIO kernel's; for a module the result is a new conv."""
    conv = nn.Conv2d(3, 4, 3)
    kernel = conv.weight.detach().numpy().transpose(2, 3, 1, 0)  # OIHW -> HWIO
    want = np.asarray(jcompat.make_n_channel_input(jnp.asarray(kernel), 5)).transpose(3, 2, 0, 1)
    new = compat.make_n_channel_input(conv, 5)
    assert new is not conv and new.in_channels == 5 and new.weight.shape == (4, 5, 3, 3)
    np.testing.assert_array_equal(new.weight.detach().numpy(), want)
    assert torch.equal(compat.make_n_channel_input(conv.weight, 5), new.weight)
    assert new(torch.randn(1, 5, 8, 8)).shape == (1, 4, 6, 6)
    ws = compat.make_n_channel_input_std_conv(WSConv(3, 4), 6)
    assert ws.weight.shape == (4, 6, 3, 3) and ws.fan_in == 54
    assert ws(torch.randn(1, 6, 5, 5)).shape == (1, 4, 5, 5)
