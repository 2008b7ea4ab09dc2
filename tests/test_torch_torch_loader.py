"""The port's ``port_torch_state_dict`` and its mapping builders against the
JAX package's, on the CPU.

For each mapping a state dict in the reference's torch layout is built
from the mapping's torch keys, with seeded values in the shapes of the
port's tensors (OIHW convs, BatchNorm weights and statistics); no file is
read or downloaded.  The JAX package's ``port_torch_state_dict`` loads it
into the flax variables, the port's into the port's model, whose other
tensors come from the same flax variables through ``load_flax_variables``.
Both forwards must agree within 1e-4 * max|ref|, and the port's model must
equal, tensor for tensor and bit for bit, the model that
``load_flax_variables`` fills from the JAX-ported variables.  The models:
MobileNetV2, a SE-ResNet and a SE-ResNeXt, a SENet154-style FPN model whose
decoder and ResizeHead compose under ``prefix_mapping``, InceptionV4 at
(1, 1, 1) in ``torch_compat`` mode, and WiderResNet16 and its A2.
The loaders' errors are pinned against each other.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_toolbelt_tpu.zoo import EncoderDecoderModel as JEncoderDecoderModel
from pytorch_toolbelt_tpu.zoo import porting as jporting
from pytorch_toolbelt_tpu.zoo.decoders.fpn import FPNDecoder as JFPNDecoder
from pytorch_toolbelt_tpu.zoo.encoders import inception as jinception
from pytorch_toolbelt_tpu.zoo.encoders import mobilenet as jmobilenet
from pytorch_toolbelt_tpu.zoo.encoders import senet as jsenet
from pytorch_toolbelt_tpu.zoo.encoders import wide_resnet as jwide
from pytorch_toolbelt_tpu.zoo.heads.resize import ResizeHead as JResizeHead
from pytorch_toolbelt_tpu_torch import zoo
from pytorch_toolbelt_tpu_torch.zoo import EncoderDecoderModel, FPNDecoder, ResizeHead, load_flax_variables
from pytorch_toolbelt_tpu_torch.zoo import porting
from pytorch_toolbelt_tpu_torch.zoo.porting import _leaves
from test_torch_mobile_encoders import MODEL_TOL, _init

_SENET = dict(kind="senet", stage_blocks=(1, 1, 1, 1), groups=4, reduction=16, inplanes=32, input_3x3=True,
              downsample_kernel_size=3)


def _fpn_model(encoder_module, decoder_module, head_module, model_module):
    encoder = encoder_module.SENetEncoder(**_SENET)
    decoder = decoder_module(encoder.get_output_spec(), out_channels=16)
    head = head_module(decoder.get_output_spec(), num_classes=3)
    return model_module(encoder, decoder, head)


def _fpn_mapping(m):
    mapping = m.prefix_mapping(m.senet_mapping((1, 1, 1, 1), input_3x3=True), ("encoder",))
    mapping.update(m.prefix_mapping(m.fpn_decoder_mapping(num_levels=5), ("decoder",)))
    mapping.update(m.prefix_mapping(m.resize_head_mapping(), ("head",)))
    return mapping


class _PortSENet:
    SENetEncoder = zoo.SENetEncoder


# name: (JAX model, port model, mapping builder (given a porting module), input size)
_MODELS = {
    "mobilenet_v2": (lambda: jmobilenet.MobileNetV2Encoder(), lambda: zoo.MobileNetV2Encoder(),
                     lambda m: m.mobilenet_v2_mapping(), 64),
    "se_resnet": (lambda: jsenet.SENetEncoder(kind="seresnet", stage_blocks=(1, 1, 1, 1)),
                  lambda: zoo.SENetEncoder(kind="seresnet", stage_blocks=(1, 1, 1, 1)),
                  lambda m: m.senet_mapping((1, 1, 1, 1)), 64),
    "se_resnext": (lambda: jsenet.SENetEncoder(kind="seresnext", stage_blocks=(1, 1, 1, 1), groups=32),
                   lambda: zoo.SENetEncoder(kind="seresnext", stage_blocks=(1, 1, 1, 1), groups=32),
                   lambda m: m.senet_mapping((1, 1, 1, 1)), 64),
    "senet_fpn_resize_head": (
        lambda: JEncoderDecoderModel(*_fpn_model(jsenet, JFPNDecoder, JResizeHead, lambda *a: a)),
        lambda: _fpn_model(_PortSENet, FPNDecoder, ResizeHead, EncoderDecoderModel),
        _fpn_mapping, 64),
    "inception_v4": (lambda: jinception.InceptionV4Encoder(torch_compat=True, stage_repeats=(1, 1, 1)),
                     lambda: zoo.InceptionV4Encoder(torch_compat=True, stage_repeats=(1, 1, 1)),
                     lambda m: m.inception_v4_mapping((1, 1, 1)), 96),
    "wider_resnet16": (lambda: jwide.wider_resnet16_encoder(), lambda: zoo.wider_resnet16_encoder(),
                       lambda m: m.wider_resnet_mapping((1, 1, 1, 1, 1, 1)), 64),
    "wider_resnet16_a2": (lambda: jwide.wider_resnet16_a2_encoder(), lambda: zoo.wider_resnet16_a2_encoder(),
                          lambda m: m.wider_resnet_mapping((1, 1, 1, 1, 1, 1), a2=True), 64),
}


def _state_dict(tmodel, mapping, seed):
    """{torch key: tensor} for every entry of ``mapping``, in the shape of
    the port's tensor at the entry's flax path (torch layout)."""
    tensors = {(c,) + p: t for c, p, t, _ in _leaves(tmodel, ())}
    rng = np.random.RandomState(seed)
    out = {}
    for path, key in mapping.items():
        shape, name = tuple(tensors[path].shape), path[-1]
        if name == "kernel":
            value = rng.randn(*shape) * np.sqrt(1.0 / np.prod(shape[1:]))
        elif name == "mean":
            value = 0.2 * rng.randn(*shape)
        elif name == "var":
            value = 0.5 + rng.rand(*shape)
        elif name == "scale":
            value = 1.0 + 0.2 * rng.randn(*shape)
        else:
            value = 0.1 * rng.randn(*shape)
        out[key] = torch.from_numpy(value.astype(np.float32))
    return out


def _outputs(out):
    if isinstance(out, (list, tuple)):
        return list(out)
    return [out]


@pytest.mark.parametrize("name", list(_MODELS))
def test_port_torch_state_dict_matches_jax(name):
    jfactory, tfactory, builder, size = _MODELS[name]
    jmodel, tmodel = jfactory(), tfactory().eval()
    mapping = builder(porting)
    assert mapping == builder(jporting)
    x = np.random.RandomState(30).rand(1, size, size, 3).astype(np.float32)
    variables = _init(jmodel, x, seed=31)
    load_flax_variables(tmodel, variables)
    state_dict = _state_dict(tmodel, mapping, seed=32)

    ported = jporting.port_torch_state_dict(variables, state_dict, mapping)
    assert porting.port_torch_state_dict(tmodel, state_dict, mapping) is tmodel
    want = _outputs(jax.jit(jmodel.apply)(ported, x))
    with torch.no_grad():
        got = _outputs(tmodel(torch.from_numpy(x.transpose(0, 3, 1, 2).copy())))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().transpose(0, 2, 3, 1).shape == w.shape
        assert np.abs(g.numpy().transpose(0, 2, 3, 1) - w).max() <= MODEL_TOL * np.abs(w).max()

    bridged = load_flax_variables(tfactory(), jax.tree_util.tree_map(np.asarray, ported))
    for (n, a), (m, b) in zip(tmodel.state_dict().items(), bridged.state_dict().items()):
        assert n == m
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _tiny():
    """A ResizeHead on a 4-channel map: one biased conv, Conv_0."""
    from pytorch_toolbelt_tpu.core.interfaces import FeatureMapsSpec as JSpec
    from pytorch_toolbelt_tpu_torch.core.interfaces import FeatureMapsSpec

    jhead, thead = JResizeHead(JSpec((4,), (1,)), num_classes=2), ResizeHead(FeatureMapsSpec((4,), (1,)), num_classes=2)
    maps = [np.random.RandomState(33).rand(1, 6, 6, 4).astype(np.float32)]
    variables = _init(jhead, maps, (6, 6), seed=34)
    load_flax_variables(thead, variables)
    mapping = porting.resize_head_mapping("head")
    return jhead, thead, variables, mapping, _state_dict(thead, mapping, seed=35)


def test_a_missing_torch_key_raises_under_strict_and_is_skipped_else():
    jhead, thead, variables, mapping, state_dict = _tiny()
    del state_dict["head.final.bias"]
    for port in (lambda: jporting.port_torch_state_dict(variables, state_dict, mapping),
                 lambda: porting.port_torch_state_dict(thead, state_dict, mapping)):
        with pytest.raises(KeyError, match="head.final.bias"):
            port()
    ported = jporting.port_torch_state_dict(variables, state_dict, mapping, strict=False)
    bias = thead.conv.bias.detach().clone()
    porting.port_torch_state_dict(thead, state_dict, mapping, strict=False)
    np.testing.assert_array_equal(np.asarray(ported["params"]["Conv_0"]["bias"]), variables["params"]["Conv_0"]["bias"])
    torch.testing.assert_close(thead.conv.bias, bias, rtol=0, atol=0)  # unmapped: kept
    torch.testing.assert_close(thead.conv.weight, state_dict["head.final.weight"], rtol=0, atol=0)
    np.testing.assert_array_equal(np.asarray(ported["params"]["Conv_0"]["kernel"]),
                                  state_dict["head.final.weight"].numpy().transpose(2, 3, 1, 0))


def test_an_unknown_flax_path_raises():
    jhead, thead, variables, mapping, state_dict = _tiny()
    mapping = {**mapping, ("params", "Conv_1", "kernel"): "head.final.weight"}
    with pytest.raises(KeyError, match="Conv_1"):
        jporting.port_torch_state_dict(variables, state_dict, mapping)
    with pytest.raises(KeyError, match="Conv_1"):
        porting.port_torch_state_dict(thead, state_dict, mapping)


def test_a_tensor_of_another_shape_raises():
    jhead, thead, variables, mapping, state_dict = _tiny()
    state_dict["head.final.weight"] = torch.zeros(2, 4, 1, 1)
    with pytest.raises(ValueError):
        jporting.port_torch_state_dict(variables, state_dict, mapping)
    with pytest.raises(ValueError, match="head.final.weight"):
        porting.port_torch_state_dict(thead, state_dict, mapping)


def test_mapping_builders_equal_the_jax_package():
    """conv_mapping, bn_mapping, prefix_mapping and the model builders at
    their published depths and options."""
    cases = [("conv_mapping", (("Conv_0",), "stem.conv"), {"bias": True}), ("bn_mapping", (("BatchNorm_0",), "bn"), {}),
             ("mobilenet_v2_mapping", (), {}), ("senet_mapping", ((3, 8, 36, 3),), {"input_3x3": True}),
             ("senet_mapping", ((3, 4, 6, 3),), {}), ("fpn_decoder_mapping", (5, "decoder"), {}),
             ("resize_head_mapping", ("head",), {}), ("inception_v4_mapping", (), {}),
             ("wider_resnet_mapping", ((3, 3, 6, 3, 1, 1),), {}),
             ("wider_resnet_mapping", ((3, 3, 6, 3, 1, 1),), {"a2": True}),
             ("wider_resnet_mapping", ((3, 3, 6, 3, 1, 1),), {"a2": True, "dilation": True})]
    for name, args, kwargs in cases:
        assert getattr(porting, name)(*args, **kwargs) == getattr(jporting, name)(*args, **kwargs), name
    m = jporting.senet_mapping((1, 1, 1, 1))
    assert porting.prefix_mapping(m, ("encoder",)) == jporting.prefix_mapping(m, ("encoder",))
    assert zoo.port_torch_state_dict is porting.port_torch_state_dict


def test_published_mappings_fit_the_port_models():
    """The full-depth mappings name tensors of the full-depth port models of
    the right kind: SENet154, InceptionV4 (4, 7, 3) in torch_compat,
    WiderResNet38 and its A2 (meta device)."""
    with torch.device("meta"):
        cases = [(zoo.senet154_encoder(), porting.senet_mapping((3, 8, 36, 3), input_3x3=True)),
                 (zoo.inception_v4_encoder(torch_compat=True), porting.inception_v4_mapping()),
                 (zoo.wider_resnet38_encoder(), porting.wider_resnet_mapping((3, 3, 6, 3, 1, 1))),
                 (zoo.wider_resnet38_a2_encoder(), porting.wider_resnet_mapping((3, 3, 6, 3, 1, 1), a2=True))]
    for model, mapping in cases:
        paths = {(c,) + p for c, p, _, _ in _leaves(model, ())}
        assert set(mapping) <= paths
        assert len(set(mapping.values())) == len(mapping)


def test_a_square_linear_weight_loads_transposed_where_the_jax_package_copies_it():
    """F11 (ROADMAP): the JAX package's ``convert_torch_tensor`` returns a
    torch tensor as it is whenever its shape equals the flax leaf's, so a
    square ``Linear`` weight ([out, in]) lands untransposed in a Dense
    kernel ([in, out]). The port's modules keep torch's layout and copy it
    as it is, which is right; the JAX package's result is its transpose."""
    weight = torch.randn(6, 6, generator=torch.Generator().manual_seed(36))
    kernel = jporting.convert_torch_tensor(weight, jnp.zeros((6, 6)), "kernel")
    np.testing.assert_array_equal(kernel, weight.numpy())  # the JAX package: not transposed
    linear = torch.nn.Linear(6, 6)
    porting.port_torch_state_dict(linear, {"fc.weight": weight}, {("params", "kernel"): "fc.weight"})
    torch.testing.assert_close(linear.weight, weight, rtol=0, atol=0)
    x = torch.randn(2, 6, generator=torch.Generator().manual_seed(37))
    torch.testing.assert_close(linear(x), x @ weight.T + linear.bias)
    assert not np.allclose(x.numpy() @ kernel, (x @ weight.T).numpy())  # flax's Dense with that kernel is x @ W
