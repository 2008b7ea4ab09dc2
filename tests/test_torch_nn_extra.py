"""Parity of the rest of the port's ``nn`` (CoordConv, SRM, DropBlock and
OCNet's blocks) with the JAX package, on the CPU.

The flax variables are seeded numpy values in the shapes of the flax init
(``jax.eval_shape``), and they reach the torch modules through
``load_flax_variables``.  Tensors are NHWC in JAX and NCHW in the port.
Modules with BatchNorm run in eval mode, and in train mode (dropout 0),
where the running statistics the forward leaves behind are held to flax's
within 1e-5 (absolute + relative).

DropBlock draws its seeds from the ``dropout`` rng stream in JAX and from a
``torch.Generator`` here, so the packages drop different blocks.  Its parity
tests give both the same uniform draws (``jax.random.uniform`` and
``torch.rand`` patched to return one seeded numpy array) and compare the
whole forward, the 3D one and the schedule's ramp; the port's own draws are
then checked by their statistics.

Tolerances: 1e-5 * max|ref| (``TOL``) for one block, 1e-4 * max|ref|
(``MODEL_TOL``) for OCNet's composite blocks (several conv-ABNs in series:
in train mode flax's fp32 ASP-OC output is 2.0e-5 * max off a float64 run
of the port, the port's 1.2e-6); DropBlock's masks are exact, and the
coordinate channels within 2.5e-7 (``jnp.linspace`` and ``torch.linspace``
round differently in the last bit).
"""

import functools
import importlib
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_toolbelt_tpu.nn import coord_conv as jcoord
from pytorch_toolbelt_tpu.nn import dropblock as jdropblock
from pytorch_toolbelt_tpu.nn import ocnet as jocnet
from pytorch_toolbelt_tpu.nn import srm as jsrm
from pytorch_toolbelt_tpu_torch.nn import (
    AddCoords,
    ASPObjectContextBlock,
    CoordConv,
    DropBlock2D,
    DropBlock3D,
    DropBlockScheduled,
    ObjectContextBlock,
    PyramidObjectContextBlock,
    PyramidSelfAttentionBlock2D,
    SelfAttentionBlock2D,
    SRMLayer,
    append_coords,
)
from pytorch_toolbelt_tpu_torch.nn import dropblock as tdropblock
from pytorch_toolbelt_tpu_torch.nn import ocnet as tocnet
from pytorch_toolbelt_tpu_torch.zoo import load_flax_variables
from pytorch_toolbelt_tpu_torch.zoo.porting import _leaves

TOL = 1e-5
MODEL_TOL = 1e-4
STATS_TOL = 1e-5


def _init(jmodule, *args, seed, **kwargs):
    """Seeded numpy values in the shapes of the flax module's variables:
    LeCun-normal kernels (and SRM's ``cfc``), BatchNorm statistics and
    affine parameters near their identity values."""
    shapes = jax.eval_shape(lambda: jmodule.init(jax.random.PRNGKey(seed), *args, **kwargs))
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name in ("kernel", "cfc"):
            return (rng.randn(*shape) * np.sqrt(1.0 / np.prod(shape[:-1]))).astype(np.float32)
        if name == "mean":
            return (0.2 * rng.randn(*shape)).astype(np.float32)
        if name == "var":
            return (0.5 + rng.rand(*shape)).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.2 * rng.randn(*shape)).astype(np.float32)
        if name == "bias":
            return (0.1 * rng.randn(*shape)).astype(np.float32)
        if name == "step":
            return np.zeros(shape, np.int32)
        raise KeyError(f"no seeded value for the flax leaf {name!r}")

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _input(shape_nhwc, seed):
    x = np.random.RandomState(seed).randn(*shape_nhwc).astype(np.float32)
    return x, torch.from_numpy(np.moveaxis(x, -1, 1).copy())


def _close(got, want, tol):
    want = np.asarray(want)
    got = np.moveaxis(got.detach().numpy(), 1, -1)
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


def _run(jmodule, tmodule, x, tx, training, seed):
    """(torch output, flax output) of the pair on the same variables; in
    train mode the running statistics are checked too."""
    variables = _init(jmodule, x, seed=seed)
    load_flax_variables(tmodule, variables)
    if training:
        want, new = jax.jit(functools.partial(jmodule.apply, training=True, mutable=["batch_stats"]))(variables, x)
        got = tmodule.train()(tx)
        assert _check_running_stats(tmodule, new["batch_stats"]) == len(
            jax.tree_util.tree_leaves(variables["batch_stats"]))
    else:
        want = jax.jit(jmodule.apply)(variables, x)
        with torch.no_grad():
            got = tmodule.eval()(tx)
    return got, want


MODES = pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])


# ---------------------------------------------------------------------------
# CoordConv
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_r", [False, True])
def test_append_coords_equals_jax(with_r):
    x, tx = _input((2, 5, 7, 3), seed=1)
    want = np.asarray(jcoord.append_coords(jnp.asarray(x), with_r))
    np.testing.assert_allclose(np.moveaxis(append_coords(tx, with_r).numpy(), 1, -1), want, rtol=0, atol=2.5e-7)
    np.testing.assert_array_equal(AddCoords(with_r)(tx).numpy(), append_coords(tx, with_r).numpy())


@pytest.mark.parametrize("with_r,kernel", [(False, (3, 3)), (True, (3, 3)), (True, (5, 4))])
def test_coord_conv_matches_flax(with_r, kernel):
    x, tx = _input((2, 9, 8, 4), seed=2)
    jmod = jcoord.CoordConv(6, with_r=with_r, kernel_size=kernel)
    tmod = CoordConv(4, 6, with_r=with_r, kernel_size=kernel)
    variables = _init(jmod, x, seed=3)
    load_flax_variables(tmod, variables)
    with torch.no_grad():
        _close(tmod(tx), jmod.apply(variables, x), TOL)


# ---------------------------------------------------------------------------
# SRM
# ---------------------------------------------------------------------------


@MODES
def test_srm_layer_matches_flax(training):
    """Unbiased std over space, the raw ``cfc`` [C, 2], a BatchNorm1d on
    [B, C] at flax's momentum with its biased running variance."""
    x, tx = _input((4, 6, 5, 8), seed=4)
    got, want = _run(jsrm.SRMLayer(), SRMLayer(8), x, tx, training, seed=5)
    _close(got, want, TOL)


# ---------------------------------------------------------------------------
# DropBlock
# ---------------------------------------------------------------------------


@pytest.fixture
def same_draws(monkeypatch):
    """Make ``jax.random.uniform`` and ``torch.rand`` return the next of a
    list of seeded numpy arrays (the same list for both)."""
    draws = {"jax": [], "torch": []}

    def use(arrays):
        draws["jax"], draws["torch"] = list(arrays), list(arrays)

    monkeypatch.setattr(jax.random, "uniform", lambda key, shape, *a, **k: jnp.asarray(draws["jax"].pop(0)))
    monkeypatch.setattr(torch, "rand", lambda shape, *a, **k: torch.from_numpy(draws["torch"].pop(0)))
    return use


@pytest.mark.parametrize("block_size", [3, 4, 5])
def test_block_mask_equals_jax(block_size):
    """The block mask of one seed mask (odd blocks centred, even ones cut
    at the low end) and the kept count."""
    seeds = (np.random.RandomState(block_size).rand(2, 11, 13) < 0.05).astype(np.float32)
    jmask, jkept = jdropblock._block_mask_2d(jnp.asarray(seeds), block_size)
    mask = tdropblock._block_mask(torch.from_numpy(seeds), block_size)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert float(mask.numel() - (1 - mask).sum()) == float(jkept)


@pytest.mark.parametrize("block_size", [3, 4])
def test_dropblock_2d_matches_flax_on_the_same_draws(same_draws, block_size):
    x, tx = _input((2, 12, 10, 3), seed=6)
    same_draws([np.random.RandomState(7).rand(2, 12, 10).astype(np.float32)])
    want = jdropblock.DropBlock2D(0.3, block_size).apply({}, x, training=True, rngs={"dropout": jax.random.PRNGKey(0)})
    got = DropBlock2D(0.3, block_size).train()(tx)
    _close(got, want, TOL)


@pytest.mark.parametrize("block_size", [3, 2])
def test_dropblock_3d_matches_flax_on_the_same_draws(same_draws, block_size):
    """The 3D rescale: mask size over the mask's sum."""
    x, tx = _input((2, 6, 7, 8, 3), seed=8)
    same_draws([np.random.RandomState(9).rand(2, 6, 7, 8).astype(np.float32)])
    want = jdropblock.DropBlock3D(0.4, block_size).apply({}, x, training=True, rngs={"dropout": jax.random.PRNGKey(0)})
    got = DropBlock3D(0.4, block_size).train()(tx)
    _close(got, want, TOL)


def test_dropblock_scheduled_ramps_as_flax(same_draws):
    """Five training calls from step 0 (start_step 1, nr_steps 3): the same
    outputs and the same step counter, then eval is the identity."""
    x, tx = _input((2, 10, 10, 4), seed=10)
    draws = [np.random.RandomState(11 + i).rand(2, 10, 10).astype(np.float32) for i in range(5)]
    same_draws(draws)
    jmod = jdropblock.DropBlockScheduled(block_size=3, start_value=0.0, stop_value=0.5, nr_steps=3, start_step=1)
    variables = _init(jmod, x, seed=12)
    tmod = DropBlockScheduled(block_size=3, start_value=0.0, stop_value=0.5, nr_steps=3, start_step=1)
    load_flax_variables(tmod, variables)
    tmod.train()
    for step in range(5):
        expected_prob = 0.5 * min(max((step - 1) / 3, 0.0), 1.0)
        assert float(tmod.drop_prob()) == pytest.approx(expected_prob)
        want, variables = jmod.apply(variables, x, training=True, rngs={"dropout": jax.random.PRNGKey(step)},
                                     mutable=["state"])
        got = tmod(tx)
        _close(got, want, TOL)
        assert int(tmod.step) == int(variables["state"]["step"]) == step + 1
    assert tmod.eval()(tx) is tx


@pytest.mark.parametrize("block_size", [3, 4])
def test_dropblock_draws_drop_about_the_rate_and_keep_the_mean(block_size):
    """The port's own draws (a fixed ``torch.Generator``): on ones, the
    dropped share is near ``drop_prob``, every block is block_size wide, the
    kept values are (mask size) / (kept count), so the mean stays 1."""
    x = torch.ones(16, 3, 64, 64)
    drop = DropBlock2D(0.2, block_size, generator=torch.Generator().manual_seed(13)).train()
    out = drop(x)
    dropped = float((out == 0).float().mean())
    assert 0.14 < dropped < 0.22
    assert torch.equal(out[:, 0], out[:, 1]) and torch.equal(out[:, 0], out[:, 2])
    kept = out[out != 0]
    assert torch.all(kept == kept[0])
    assert float(out.mean()) == pytest.approx(1.0, abs=1e-5)
    assert drop.eval()(x) is x and DropBlock2D(0.0, block_size).train()(x) is x


def test_dropblock_with_one_generator_seed_repeats():
    x = torch.randn(2, 3, 16, 16)
    a = DropBlock2D(0.3, 3, generator=torch.Generator().manual_seed(5)).train()(x)
    b = DropBlock2D(0.3, 3, generator=torch.Generator().manual_seed(5)).train()(x)
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# OCNet
# ---------------------------------------------------------------------------

# name: (JAX block, port block, NHWC input shape, tolerance)
_OCNET = {
    "self_attention": (lambda: jocnet.SelfAttentionBlock2D(6, 10, 12), lambda: SelfAttentionBlock2D(8, 6, 10, 12),
                       (2, 8, 9, 8), TOL),
    "self_attention_scale2": (lambda: jocnet.SelfAttentionBlock2D(6, 10, scale=2),
                              lambda: SelfAttentionBlock2D(8, 6, 10, scale=2), (2, 8, 10, 8), TOL),
    "object_context": (lambda: jocnet.ObjectContextBlock(12, 6, 10, sizes=(1, 2)),
                       lambda: ObjectContextBlock(8, 12, 6, 10, sizes=(1, 2)), (2, 8, 8, 8), MODEL_TOL),
    "asp_object_context": (lambda: jocnet.ASPObjectContextBlock(16, dilations=(1, 2, 3), dropout=0.0),
                           lambda: ASPObjectContextBlock(8, 16, dilations=(1, 2, 3), dropout=0.0), (2, 8, 8, 8),
                           MODEL_TOL),
    "pyramid_self_attention": (lambda: jocnet.PyramidSelfAttentionBlock2D(4, 8, 10, scale=3),
                               lambda: PyramidSelfAttentionBlock2D(8, 4, 8, 10, scale=3), (2, 9, 6, 8), TOL),
    "pyramid_object_context": (lambda: jocnet.PyramidObjectContextBlock(12, dropout=0.0, sizes=(1, 2, 3, 6)),
                               lambda: PyramidObjectContextBlock(8, 12, dropout=0.0, sizes=(1, 2, 3, 6)),
                               (2, 12, 12, 8), MODEL_TOL),
}


@MODES
@pytest.mark.parametrize("name", list(_OCNET))
def test_ocnet_blocks_match_flax(name, training):
    jfactory, tfactory, shape, tol = _OCNET[name]
    x, tx = _input(shape, seed=14)
    got, want = _run(jfactory(), tfactory(), x, tx, training, seed=15)
    _close(got, want, tol)


def test_pyramid_block_rejects_a_map_the_scale_does_not_divide():
    with pytest.raises(ValueError, match="divisible"):
        PyramidSelfAttentionBlock2D(8, 4, 8, scale=3)(torch.randn(1, 8, 9, 10))


def test_attention_sums_in_float32_and_returns_the_values_dtype():
    """bf16 tokens: the similarities and the weighted sum in float32, as
    JAX's ``preferred_element_type``; the context in bf16."""
    gen = torch.Generator().manual_seed(16)
    q, v = torch.randn(2, 30, 8, generator=gen).bfloat16(), torch.randn(2, 30, 5, generator=gen).bfloat16()
    got = tocnet._attend(q, q, v, 8)
    want = jocnet._attend(jnp.asarray(q.float().numpy(), jnp.bfloat16), jnp.asarray(q.float().numpy(), jnp.bfloat16),
                          jnp.asarray(v.float().numpy(), jnp.bfloat16), 8)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    plain = torch.matmul(torch.softmax(q.float() @ q.float().transpose(1, 2) * 8**-0.5, dim=-1), v.float())
    assert torch.equal(got, plain.bfloat16())
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=1e-2, atol=1e-2)


# ---------------------------------------------------------------------------
# The slice's names, and its modules without JAX
# ---------------------------------------------------------------------------

_SLICE_MODULES = ["zoo.encoders.mix_transformer", "zoo.encoders.swin", "zoo.encoders.efficientnet",
                  "zoo.encoders.efficientnet_v2", "zoo.encoders.mixnet", "zoo.encoders.mobilenet", "nn.coord_conv",
                  "nn.srm", "nn.dropblock", "nn.ocnet"]


@pytest.mark.parametrize("module", _SLICE_MODULES)
def test_port_exports_every_public_name_of_the_jax_module(module):
    """Every name of the JAX module's ``__all__`` and every public class it
    defines exists in the port's module of the same name and is exported
    from the port's ``nn`` or ``zoo``."""
    jmod = importlib.import_module(f"pytorch_toolbelt_tpu.{module}")
    tmod = importlib.import_module(f"pytorch_toolbelt_tpu_torch.{module}")
    package = importlib.import_module(f"pytorch_toolbelt_tpu_torch.{module.split('.')[0]}")
    classes = {name for name, value in vars(jmod).items()
               if isinstance(value, type) and value.__module__ == jmod.__name__ and not name.startswith("_")}
    names = set(jmod.__all__) | classes
    assert names <= set(tmod.__all__)
    assert all(hasattr(package, name) for name in names), sorted(n for n in names if not hasattr(package, n))


def test_the_slice_imports_without_jax():
    """The port's slice modules and ``chip_smoke`` import in a process where
    importing jax or flax fails."""
    modules = [f"pytorch_toolbelt_tpu_torch.{m}" for m in _SLICE_MODULES] + ["pytorch_toolbelt_tpu_torch", "chip_smoke"]
    code = ("import sys; sys.modules['jax'] = None; sys.modules['flax'] = None; import importlib; "
            f"[importlib.import_module(m) for m in {modules!r}]; "
            "assert not any(m.startswith('pytorch_toolbelt_tpu.') or m == 'pytorch_toolbelt_tpu' for m in sys.modules)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True, timeout=120)
