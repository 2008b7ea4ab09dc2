"""Parity of the port's ``optimization/`` with the JAX package's, on the CPU.

* every learning-rate schedule equals JAX's at steps 0-50;
* param groups: names, labels and counts equal JAX's through the reverse
  name map (``flax_name_map``), the ``_default_`` errors and the display-name
  collision case;
* ``make_optimizer``'s AdamW against ``optax.adamw`` under
  ``optax.multi_transform`` on identical params and given gradients, 3 steps,
  within 1e-6.

The JAX package tells norm parameters by flax's auto-names (``BatchNorm_0``
in the path), the port by module type.  The SENet names its BatchNorms by
hand (``bn1``, ``layer0_bn1``, ``downsample_bn``), so JAX does not see them as
norms; the SENet case compares with JAX on the same tree with those names
marked, and a separate test pins the difference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from pytorch_toolbelt_tpu import optimization as JO
from pytorch_toolbelt_tpu.zoo import EncoderDecoderModel as JEncoderDecoderModel
from pytorch_toolbelt_tpu.zoo import FPNDecoder as JFPNDecoder
from pytorch_toolbelt_tpu.zoo import ResizeHead as JResizeHead
from pytorch_toolbelt_tpu.zoo import UNetSegmentationModel as JUNetSegmentationModel
from pytorch_toolbelt_tpu.zoo.encoders import senet as jsenet
from pytorch_toolbelt_tpu_torch import optimization as O
from pytorch_toolbelt_tpu_torch.zoo import EncoderDecoderModel, FPNDecoder, ResizeHead, SENetEncoder
from pytorch_toolbelt_tpu_torch.zoo import UNetSegmentationModel, flax_name_map

ADAMW_TOL = 1e-6

_SENET = dict(kind="seresnext", stage_blocks=(1, 1, 1, 1), groups=32, base_width=4)

_SCHEDULES = [
    ("once_cycle", lambda m: m.once_cycle_schedule(1e-3, 40)),
    ("once_cycle_factors", lambda m: m.once_cycle_schedule(0.1, 51, min_lr_factor=0.1, max_lr=2.0)),
    ("cosine_decay", lambda m: m.cosine_annealing_with_decay_schedule(1e-3, 10, 0.9, eta_min=1e-5)),
    ("warm_restarts", lambda m: m.cosine_annealing_warm_restarts_with_decay_schedule(1e-3, 7)),
    ("warm_restarts_mult", lambda m: m.cosine_annealing_warm_restarts_with_decay_schedule(1e-3, 5, t_mult=2)),
    ("poly", lambda m: m.poly_schedule(1e-2, 60, gamma=0.9)),
    ("flat_cosine", lambda m: m.flat_cosine_annealing_schedule(1e-3, t_max=50, t_flat=20, eta_min=1e-6)),
    ("warmup", lambda m: m.gradual_warmup_schedule(1e-3, 1.0, 5)),
    ("warmup_mult", lambda m: m.gradual_warmup_schedule(1e-3, 4.0, 10)),
    ("warmup_then_flat_cosine", lambda m: m.gradual_warmup_schedule(
        1e-3, 1.0, 5, after_schedule=m.flat_cosine_annealing_schedule(1e-3, t_max=20, t_flat=10))),
]


@pytest.mark.parametrize("factory", [s[1] for s in _SCHEDULES], ids=[s[0] for s in _SCHEDULES])
def test_schedule_matches_jax(factory):
    want, got = factory(JO), factory(O)
    assert [got(step) for step in range(51)] == [want(step) for step in range(51)]


def test_warmup_rejects_multiplier_below_one():
    with pytest.raises(ValueError):
        JO.gradual_warmup_schedule(1e-3, 0.5, 5)
    with pytest.raises(ValueError):
        O.gradual_warmup_schedule(1e-3, 0.5, 5)


def _unet():
    jmodel = JUNetSegmentationModel(num_classes=2, encoder_channels=16, num_layers=3)
    params = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))["params"]
    return params, UNetSegmentationModel(num_classes=2, encoder_channels=16, num_layers=3)


def _seresnext_fpn():
    jencoder = jsenet.SENetEncoder(**_SENET)
    jdecoder = JFPNDecoder(input_spec=jencoder.get_output_spec(), out_channels=32)
    jmodel = JEncoderDecoderModel(jencoder, jdecoder, JResizeHead(input_spec=jdecoder.get_output_spec(), num_classes=5))
    params = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))["params"]
    encoder = SENetEncoder(**_SENET)
    decoder = FPNDecoder(encoder.get_output_spec(), out_channels=32)
    return params, EncoderDecoderModel(encoder, decoder, ResizeHead(decoder.get_output_spec(), num_classes=5))


def _mark_hand_named_norms(params, model):
    """The flax tree with every BatchNorm's module name suffixed
    '_BatchNorm', so that JAX's name markers see it."""
    norms = {path[:-1] for name, (collection, path) in flax_name_map(model).items()
             if collection == "params" and isinstance(model.get_submodule(name.rsplit(".", 1)[0]), nn.BatchNorm2d)}
    norms = {p for p in norms if not any("BatchNorm" in k for k in p)}

    def rename(node, prefix):
        if not isinstance(node, dict):
            return node
        return {(f"{k}_BatchNorm" if prefix + (k,) in norms else k): rename(v, prefix + (k,)) for k, v in node.items()}

    return rename(params, ())


def _jax_labels(params) -> dict:
    labels, groups, defaults = params
    return {".".join(str(k.key) for k in path): label for path, label in jax.tree_util.tree_leaves_with_path(labels)}


_GROUP_CASES = [
    ("scalar", 1e-3, 1e-4, True, True),
    ("no_wd_on_bias_and_norm", 1e-3, 1e-4, False, False),
    ("no_wd_on_norm", 1e-3, 1e-4, True, False),
    ("layerwise", {"encoder": 1e-4, "decoder": 5e-4, "_default_": 1e-3}, {"head": 0.0, "_default_": 1e-4}, False, False),
]


# the flax names of the torch prefixes: the UNet's children are auto-named, the SENet-FPN's by attribute
_FLAX_PREFIX = {"unet": {"encoder": "UnetEncoder_0", "decoder": "UNetDecoder_0", "head": "ResizeHead_0"},
                "seresnext_fpn": {}}


@pytest.mark.parametrize("case", _GROUP_CASES, ids=[c[0] for c in _GROUP_CASES])
@pytest.mark.parametrize("model_kind", ["unet", "seresnext_fpn"])
def test_param_groups_match_jax(model_kind, case):
    _, lr, wd, on_bias, on_norm = case
    params, model = _unet() if model_kind == "unet" else _seresnext_fpn()
    if model_kind == "seresnext_fpn":
        params = _mark_hand_named_norms(params, model)
    prefix = _FLAX_PREFIX[model_kind]

    def to_flax(spec):
        return {prefix.get(k, k): v for k, v in spec.items()} if isinstance(spec, dict) else spec

    def to_torch(group: str) -> str:
        for t, f in prefix.items():
            group = group.replace(f, t)
        return group

    kwargs = dict(apply_weight_decay_on_bias=on_bias, apply_weight_decay_on_norm=on_norm)
    jlabels, jgroups, jdefaults = JO.build_optimizer_param_groups(params, to_flax(lr), to_flax(wd), **kwargs)
    labels, groups, defaults = O.build_optimizer_param_groups(model, lr, wd, **kwargs)
    assert {to_torch(k): v for k, v in jgroups.items()} == groups
    assert jdefaults == defaults
    torch_name = {".".join(path): name for name, (_, path) in flax_name_map(model).items()}
    want = {torch_name[path.replace("_BatchNorm", "")]: to_torch(label)
            for path, label in _jax_labels((jlabels, jgroups, jdefaults)).items()}
    assert want == labels


def test_seresnext_hand_named_batchnorms_are_not_norms_in_jax():
    """The JAX package's name markers miss the SENet's hand-named BatchNorms:
    their scales take weight decay and their biases fall under
    no_wd_on_bias, where the port puts both under no_wd_on_norm."""
    params, model = _seresnext_fpn()
    _, jgroups, _ = JO.build_optimizer_param_groups(params, 1e-3, 1e-4, apply_weight_decay_on_bias=False,
                                                    apply_weight_decay_on_norm=False)
    _, groups, _ = O.build_optimizer_param_groups(model, 1e-3, 1e-4, apply_weight_decay_on_bias=False,
                                                  apply_weight_decay_on_norm=False)
    bn_scale = sum(m.weight.numel() for m in model.modules() if isinstance(m, nn.BatchNorm2d))
    bn_bias = sum(m.bias.numel() for m in model.modules() if isinstance(m, nn.BatchNorm2d))
    assert "default_no_wd_on_norm" not in jgroups
    assert groups["default_no_wd_on_norm"]["count"] == bn_scale + bn_bias
    assert jgroups["default"]["count"] - groups["default"]["count"] == bn_scale
    assert jgroups["default_no_wd_on_bias"]["count"] - groups["default_no_wd_on_bias"]["count"] == bn_bias


class _Named(nn.Module):
    """Parameters named as the flax tree ``_named_params`` names them."""

    def __init__(self, names):
        super().__init__()
        for name in names:
            module = nn.Module()
            module.weight = nn.Parameter(torch.zeros(3, 2))
            module.bias = nn.Parameter(torch.zeros(2))
            self.add_module(name, module)


def _named_params(names):
    return {name: {"bias": np.zeros((2,), np.float32), "weight": np.zeros((3, 2), np.float32)} for name in names}


@pytest.mark.parametrize("extra", [[], ["zz"]], ids=["two_groups", "with_default"])
def test_group_name_collision_matches_jax(extra):
    """Two (lr prefix, wd prefix) keys whose joined display names clash:
    'a_bX' takes lr 'a' and wd 'a_b' ('a' + '_' + 'a_b' = 'a_a_b'), 'a_a_bY'
    takes lr 'a_a_b' and wd 'a_a_b' (one index: 'a_a_b').  They stay two
    groups, the second met is renamed 'a_a_b~2', as in the JAX package."""
    lr = {"a_a_b": 1e-2, "a": 1e-3, "_default_": 1e-4}
    wd = {"a_b": 0.5, "a_a_b": 0.25, "_default_": 0.0}
    names = sorted(["a_bX", "a_a_bY"] + extra)  # the flax tree's order: sorted keys
    want = JO.build_optimizer_param_groups(_named_params(names), lr, wd)
    got = O.build_optimizer_param_groups(_Named(names), lr, wd)
    assert want[1] == got[1] and _jax_labels(want) == got[0]
    assert got[1]["a_a_b"] == {"lr": 1e-2, "weight_decay": 0.25, "count": 8}
    assert got[1]["a_a_b~2"] == {"lr": 1e-3, "weight_decay": 0.5, "count": 8}
    optimizer = O.make_optimizer(_Named(names), lr, wd, torch.optim.SGD)
    assert [(g["name"], g["lr"], g["weight_decay"]) for g in optimizer.param_groups][:2] == [
        ("a_a_b", 1e-2, 0.25), ("a_a_b~2", 1e-3, 0.5)]


@pytest.mark.parametrize("which", ["learning_rate", "weight_decay"])
def test_layerwise_without_default_raises_like_jax(which):
    params, model = _unet()
    kwargs = {"learning_rate": 1e-3, "weight_decay": 1e-4, which: {"encoder": 1e-3}}
    with pytest.raises(RuntimeError, match="_default_") as want:
        JO.build_optimizer_param_groups(params, **kwargs)
    with pytest.raises(RuntimeError, match="_default_") as got:
        O.build_optimizer_param_groups(model, **kwargs)
    assert str(got.value) == str(want.value)


def test_frozen_parameters_are_left_out_of_the_groups():
    _, model = _unet()
    mask = O.freeze_parameters("encoder")(model)
    for name, p in model.named_parameters():
        p.requires_grad_(not mask[name])
    labels, groups, _ = O.build_optimizer_param_groups(model, 1e-3, 1e-4)
    assert labels and not any(name.startswith("encoder") for name in labels)
    assert sum(g["count"] for g in groups.values()) == O.count_optimizable_parameters(model)
    assert O.count_optimizable_parameters(model) == sum(p.numel() for n, p in model.named_parameters()
                                                        if not n.startswith("encoder"))
    optimizer = O.make_optimizer(model, 1e-3, 1e-4)
    assert sum(len(g["params"]) for g in optimizer.param_groups) == len(labels)


def test_freeze_parameters_matches_jax():
    params, model = _unet()
    want = {".".join(str(k.key) for k in path): bool(v) for path, v in
            jax.tree_util.tree_leaves_with_path(JO.freeze_parameters(["UnetEncoder_0", "ResizeHead_0"])(params))}
    got = O.freeze_parameters(["encoder", "head"])(model)
    names = flax_name_map(model)
    assert {".".join(names[n][1]): v for n, v in got.items()} == want
    assert O.freeze_parameters("encoder")(model) == {n: n.startswith("encoder") for n, _ in model.named_parameters()}


def test_count_optimizable_parameters_matches_jax():
    for params, model in (_unet(), _seresnext_fpn()):
        assert O.count_optimizable_parameters(model) == JO.count_optimizable_parameters(params)


def test_scale_learning_rate_for_ddp():
    assert O.scale_learning_rate_for_ddp(1e-3, 4) == JO.scale_learning_rate_for_ddp(1e-3, 4) == 4e-3
    assert O.scale_learning_rate_for_ddp(1e-3) == 1e-3  # no process group: world size 1


@pytest.mark.parametrize("layerwise", [False, True], ids=["scalar", "layerwise"])
def test_make_optimizer_adamw_matches_optax(layerwise):
    """Identical params and given gradients, three steps of AdamW on both
    sides: each group's lr and weight decay, and AdamW's update rule
    (p <- p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p))."""
    _, model = _unet()
    rng = np.random.RandomState(0)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.from_numpy(rng.randn(*p.shape).astype(np.float32)))
    names = flax_name_map(model)
    params = {}
    for name, p in model.named_parameters():
        node = params
        for key in names[name][1][:-1]:
            node = node.setdefault(key, {})
        node[names[name][1][-1]] = jnp.asarray(p.detach().numpy())  # layout is irrelevant here: elementwise
    lr = {"UnetEncoder_0": 2e-3, "_default_": 1e-3} if layerwise else 1e-3
    torch_lr = {"encoder": 2e-3, "_default_": 1e-3} if layerwise else 1e-3
    kwargs = dict(apply_weight_decay_on_bias=False, apply_weight_decay_on_norm=False)
    tx = JO.make_optimizer(params, lr, 0.05, optax.adamw, **kwargs)
    state = tx.init(params)
    optimizer = O.make_optimizer(model, torch_lr, 0.05, torch.optim.AdamW, betas=(0.9, 0.999), eps=1e-8, **kwargs)
    assert len(optimizer.param_groups) == (5 if layerwise else 3)
    for step in range(3):
        grads_np = {name: rng.randn(*p.shape).astype(np.float32) for name, p in model.named_parameters()}
        grads = jax.tree_util.tree_map(lambda a: a, params)
        for name, g in grads_np.items():
            node = grads
            for key in names[name][1][:-1]:
                node = node[key]
            node[names[name][1][-1]] = jnp.asarray(g)
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        for name, p in model.named_parameters():
            p.grad = torch.from_numpy(grads_np[name])
        optimizer.step()
        for name, p in model.named_parameters():
            want = params
            for key in names[name][1]:
                want = want[key]
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(want), rtol=0, atol=ADAMW_TOL,
                                       err_msg=f"{name} at step {step}")
