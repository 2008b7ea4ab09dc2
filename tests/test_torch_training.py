"""Parity of the port's training path with the JAX package's, on the CPU.

One training step -- forward in train mode, loss, gradients, the updated
BatchNorm running statistics -- of the example's UNet (``encoder_channels=16,
num_layers=3``) and of a narrow SEResNeXt-FPN (one bottleneck per stage,
FPN(32), five classes), under dice + CE-focal and under CE-focal + Lovasz
(JAX: ``lax.sort``; the port: its kernel wrappers' plain ``torch.sort``),
against ``jax.value_and_grad`` with ``mutable=["batch_stats"]``; three AdamW
steps of each model; the port's example at its test size.

The flax variables are initialised from a seed, with seeded BatchNorm
statistics and affine parameters, and reach the torch modules through
``load_flax_variables``; ``flax_name_map`` pairs each torch gradient and
running statistic with its flax leaf.  Tensors are NHWC in JAX, NCHW here.

Tolerances: the loss within 1e-5 relative; each parameter's gradient within
1e-4 * max|g| over the model's gradients; running means and variances within
1e-5 (absolute and relative, of values of order one); three AdamW steps'
losses within 1e-4 relative.  XLA and torch's CPU convolutions add in another
order (~1e-7 relative per op).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_toolbelt_tpu import losses as JL
from pytorch_toolbelt_tpu.optimization import make_optimizer as jmake_optimizer
from pytorch_toolbelt_tpu.zoo import EncoderDecoderModel as JEncoderDecoderModel
from pytorch_toolbelt_tpu.zoo import FPNDecoder as JFPNDecoder
from pytorch_toolbelt_tpu.zoo import ResizeHead as JResizeHead
from pytorch_toolbelt_tpu.zoo import UNetSegmentationModel as JUNetSegmentationModel
from pytorch_toolbelt_tpu.zoo.encoders import senet as jsenet
from pytorch_toolbelt_tpu_torch import losses as L
from pytorch_toolbelt_tpu_torch.examples import train_segmentation
from pytorch_toolbelt_tpu_torch.optimization import make_optimizer
from pytorch_toolbelt_tpu_torch.zoo import EncoderDecoderModel, FPNDecoder, ResizeHead, SENetEncoder
from pytorch_toolbelt_tpu_torch.zoo import UNetSegmentationModel, flax_name_map, load_flax_variables

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4  # relative to max|g| over the model
STATS_TOL = 1e-5
ADAMW_LOSS_RTOL = 1e-4

_SENET = dict(kind="seresnext", stage_blocks=(1, 1, 1, 1), groups=32, base_width=4)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, dtype=np.float32), tree)


def _init(jmodule, shape, seed):
    """Flax variables with seeded BatchNorm statistics and affine parameters."""
    variables = _numpy_tree(jmodule.init(jax.random.PRNGKey(seed), jnp.zeros(shape)))
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


def _pair(kind: str, seed: int):
    """(flax module, variables, torch module, input size, classes)."""
    if kind == "unet":
        jmodel = JUNetSegmentationModel(num_classes=2, encoder_channels=16, num_layers=3)
        tmodel = UNetSegmentationModel(num_classes=2, encoder_channels=16, num_layers=3)
        size, classes = 32, 2
    else:
        jencoder = jsenet.SENetEncoder(**_SENET)
        jdecoder = JFPNDecoder(input_spec=jencoder.get_output_spec(), out_channels=32)
        jmodel = JEncoderDecoderModel(jencoder, jdecoder, JResizeHead(input_spec=jdecoder.get_output_spec(),
                                                                      num_classes=5))
        encoder = SENetEncoder(**_SENET)
        decoder = FPNDecoder(encoder.get_output_spec(), out_channels=32)
        tmodel = EncoderDecoderModel(encoder, decoder, ResizeHead(decoder.get_output_spec(), num_classes=5))
        size, classes = 64, 5
    variables = _init(jmodel, (1, size, size, 3), seed)
    return jmodel, variables, load_flax_variables(tmodel, variables), size, classes


def _batch(size: int, classes: int, seed: int, batch: int = 2):
    rng = np.random.RandomState(seed)
    x = rng.randn(batch, size, size, 3).astype(np.float32)
    y = rng.randint(0, classes, size=(batch, size, size)).astype(np.int32)
    return x, y, torch.from_numpy(x.transpose(0, 3, 1, 2).copy()), torch.from_numpy(y)


def _losses(kind: str):
    """(JAX loss on NHWC logits, port loss on NCHW logits)."""
    if kind == "dice_ce":
        return (JL.JointLoss(JL.DiceLoss(mode="multiclass"), JL.CrossEntropyFocalLoss(), 1.0, 0.5),
                L.JointLoss(L.DiceLoss(mode="multiclass"), L.CrossEntropyFocalLoss(), 1.0, 0.5))
    jlovasz, lovasz = JL.LovaszLoss(per_image=False), L.LovaszLoss(per_image=False)
    return (JL.JointLoss(JL.CrossEntropyFocalLoss(), lambda x, y: jlovasz(jax.nn.softmax(x, axis=-1), y), 1.0, 0.5),
            L.JointLoss(L.CrossEntropyFocalLoss(), lambda x, y: lovasz(torch.softmax(x, 1), y), 1.0, 0.5))


def _jax_step(jmodel, variables, jloss, x, y):
    def compute(params):
        out, updates = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]}, x, training=True,
                                    mutable=["batch_stats"])
        return jloss(out, y), updates["batch_stats"]

    (loss, stats), grads = jax.jit(jax.value_and_grad(compute, has_aux=True))(variables["params"])
    return float(loss), _numpy_tree(grads), _numpy_tree(stats)


def _leaf(tree, path):
    for key in path:
        tree = tree[key]
    return np.asarray(tree)


def _to_torch_layout(a: np.ndarray) -> np.ndarray:
    return a.transpose(3, 2, 0, 1) if a.ndim == 4 else a  # HWIO -> OIHW (no transposed convs here)


@pytest.mark.parametrize("loss_kind", ["dice_ce", "ce_lovasz"])
@pytest.mark.parametrize("model_kind", ["unet", "seresnext_fpn"])
def test_training_step_matches_jax(model_kind, loss_kind):
    jmodel, variables, tmodel, size, classes = _pair(model_kind, seed=11)
    x, y, xt, yt = _batch(size, classes, seed=12)
    jloss, tloss = _losses(loss_kind)
    want_loss, want_grads, want_stats = _jax_step(jmodel, variables, jloss, jnp.asarray(x), jnp.asarray(y))

    loss = tloss(tmodel.train()(xt), yt)
    loss.backward()
    assert abs(loss.item() - want_loss) <= LOSS_RTOL * abs(want_loss)

    names = flax_name_map(tmodel)
    grads = {name: p.grad.numpy() for name, p in tmodel.named_parameters()}
    assert {n for n, (c, _) in names.items() if c == "params"} == set(grads)
    scale = max(np.abs(g).max() for g in grads.values())
    for name, grad in grads.items():
        want = _to_torch_layout(_leaf(want_grads, names[name][1]))
        err = np.abs(grad - want).max()
        assert err <= GRAD_TOL * scale, f"{name}: max|err| {err:.3e} > {GRAD_TOL * scale:.3e}"

    stats = [(n, t) for n, t in tmodel.named_buffers() if n.endswith(("running_mean", "running_var"))]
    assert stats and all(names[n][0] == "batch_stats" for n, _ in stats)
    for name, tensor in stats:
        np.testing.assert_allclose(tensor.numpy(), _leaf(want_stats, names[name][1]), rtol=STATS_TOL, atol=STATS_TOL,
                                   err_msg=name)


# model, learning rate: the UNet takes the example's 1e-3; see the test's docstring for the SENet's 1e-4
_ADAMW_CASES = [("unet", 1e-3), ("seresnext_fpn", 1e-4)]


@pytest.mark.parametrize("model_kind,lr", _ADAMW_CASES, ids=[c[0] for c in _ADAMW_CASES])
def test_three_adamw_steps_match_jax(model_kind, lr):
    """Three steps of the example's AdamW (weight decay 1e-4, betas (0.9,
    0.999), eps 1e-8) on three batches, on both sides.  The UNet takes the
    example's groups (no decay on biases and norms); the SENet decays every
    parameter, because the JAX package does not see its hand-named
    BatchNorms as norms (see test_torch_optimization.py).

    Adam's first update is about lr * sign(g) for every weight.  In the
    16-BatchNorm-deep SENet in train mode at batch 2, a few thousand of its
    8.2M gradient elements sit at the level of the rounding differences, so
    the two packages move them by +lr and -lr.  The next batch's gradient at
    those weights is an ordinary one, and at lr 1e-3 the second and third
    losses then differ by 1.2e-4 to 9e-4 relative (measured on the CPU), while
    the first loss and every gradient agree (test_training_step_matches_jax).
    At lr 1e-4 the same steps stay within 1e-4."""
    jmodel, variables, tmodel, size, classes = _pair(model_kind, seed=21)
    exempt = model_kind == "unet"
    kwargs = dict(apply_weight_decay_on_bias=not exempt, apply_weight_decay_on_norm=not exempt)
    jloss, tloss = _losses("dice_ce")
    params, stats = variables["params"], variables["batch_stats"]
    tx = jmake_optimizer(params, lr, 1e-4, optax.adamw, **kwargs)
    opt_state = tx.init(params)

    @jax.jit
    def jstep(params, stats, opt_state, x, y):
        def compute(p):
            out, updates = jmodel.apply({"params": p, "batch_stats": stats}, x, training=True, mutable=["batch_stats"])
            return jloss(out, y), updates["batch_stats"]

        (loss, new_stats), grads = jax.value_and_grad(compute, has_aux=True)(params)
        updates, new_opt = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), new_stats, new_opt, loss

    optimizer = make_optimizer(tmodel, lr, 1e-4, torch.optim.AdamW, betas=(0.9, 0.999), eps=1e-8, **kwargs)
    tmodel.train()
    for step in range(3):
        x, y, xt, yt = _batch(size, classes, seed=30 + step)
        params, stats, opt_state, want = jstep(params, stats, opt_state, jnp.asarray(x), jnp.asarray(y))
        loss = tloss(tmodel(xt), yt)
        optimizer.zero_grad()
        loss.backward()
        optimizer.step()
        assert abs(loss.item() - float(want)) <= ADAMW_LOSS_RTOL * abs(float(want)), f"step {step}"


def test_example_synthetic_batch_is_the_jax_examples():
    from examples import train_segmentation as jexample

    jx, jy = jexample.synthetic_batch(np.random.RandomState(3), 4, 32)
    x, y = train_segmentation.synthetic_batch(np.random.RandomState(3), 4, 32)
    np.testing.assert_array_equal(x, np.asarray(jx).transpose(0, 3, 1, 2))
    np.testing.assert_array_equal(y, np.asarray(jy))
    assert x.dtype == np.float32 and y.dtype == np.int32


def test_example_main_prints_loss_and_tiled_lines(capsys):
    result = train_segmentation.main(steps=3, batch=8, size=32, device="cpu")
    out = capsys.readouterr().out
    assert "loss" in out and "tiled d4-TTA prediction" in out
    assert [line.split()[1] for line in out.splitlines() if line.startswith("step")] == ["0", "2"]
    assert "finite: True" in out
    assert len(result["losses"]) == 2 and all(np.isfinite(result["losses"]))
    assert tuple(result["prediction"].shape) == (2, 128, 128)


def test_example_parameter_count_is_the_jax_models():
    jmodel, variables, tmodel, _, _ = _pair("unet", seed=1)
    count = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(variables["params"]))
    assert count == sum(p.numel() for p in tmodel.parameters())


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the behaviour without a card")
def test_example_raises_without_a_card():
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_segmentation.main(steps=1, batch=2, size=32)


def test_training_step_is_reproducible_from_a_deep_copy():
    """A deep copy of a bridged model takes the same step bit for bit (the
    check on the card holds the port against a plain step on a copy)."""
    _, _, tmodel, size, classes = _pair("unet", seed=5)
    other = copy.deepcopy(tmodel)
    x, y, xt, yt = _batch(size, classes, seed=6)
    _, tloss = _losses("dice_ce")
    for model in (tmodel, other):
        tloss(model.train()(xt), yt).backward()
    for (name, a), (_, b) in zip(tmodel.named_parameters(), other.named_parameters()):
        assert torch.equal(a.grad, b.grad), name
    for (name, a), (_, b) in zip(tmodel.named_buffers(), other.named_buffers()):
        assert torch.equal(a, b), name
