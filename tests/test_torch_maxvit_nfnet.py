"""Parity of the port's MaxViT and NFNet encoders with the JAX package, on
the CPU.

The flax variables are seeded numpy values in the shapes of the flax init
(``jax.eval_shape``) and reach the torch modules through
``load_flax_variables``.  Maps are NHWC in JAX and NCHW in the port.

MaxViT runs at reduced width and depth: its blocks on maps that need no
padding and on maps that do (the JAX package zero-pads to a multiple of
``partition`` with no mask, so the padded tokens move the LayerNorms and the
attention), the encoder at 160^2 with partition 8 (stage maps 20, 10 and 5
pad to 24, 16 and 8), in eval and train mode (running statistics against
flax's, biased, within 1e-5), and ``use_remat``'s gradients against flax's
``nn.remat``.  A narrow MaxViT + FPN + ResizeHead goes through both
packages' tiled d4.

NFNet's ``skip_gain`` is zero at flax's init, which would leave every
block's residual branch out of the comparison, and ``gain`` is one: both are
seeded away from those values before either package runs.  NFNet runs on
even inputs and on odd ones (flax ``SAME`` pads the stride-2 convs
asymmetrically on even sides only; a stride-2 block's 2x2 average pool
floors, so past the stem an odd map runs only in a one-stage encoder, in
both packages).

Tolerances: 1e-5 * max|ref| for one block (``TOL``), 1e-4 * max|ref|
(``MODEL_TOL``) for encoders and models.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_toolbelt_tpu.inference import tiled_apply_d4_tta as j_tiled_apply_d4_tta
from pytorch_toolbelt_tpu.zoo import EncoderDecoderModel as JEncoderDecoderModel
from pytorch_toolbelt_tpu.zoo import FPNDecoder as JFPNDecoder
from pytorch_toolbelt_tpu.zoo import ResizeHead as JResizeHead
from pytorch_toolbelt_tpu.zoo.encoders import maxvit as jmaxvit
from pytorch_toolbelt_tpu.zoo.encoders import nfnet as jnfnet
from pytorch_toolbelt_tpu_torch.inference import tiled_apply_d4_tta
from pytorch_toolbelt_tpu_torch.zoo import (
    EncoderDecoderModel,
    FPNDecoder,
    MaxViTBlock,
    MaxViTEncoder,
    NFBlock,
    NFNetEncoder,
    ResizeHead,
    WSConv,
    load_flax_variables,
)
from test_torch_mobile_encoders import _check_running_stats

TOL = 1e-5
MODEL_TOL = 1e-4


def _init(jmodule, *args, seed, **kwargs):
    """Seeded numpy values in the shapes of the flax module's variables:
    LeCun-normal kernels, LayerNorm and BatchNorm scales near 1, small
    biases, BatchNorm statistics near their identity values, NFNet's
    ``gain`` near 1 and ``skip_gain`` in [0.5, 1.5)."""
    shapes = jax.eval_shape(lambda: jmodule.init(jax.random.PRNGKey(seed), *args, **kwargs))
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            return (rng.randn(*shape) * np.sqrt(1.0 / np.prod(shape[:-1]))).astype(np.float32)
        if name in ("scale", "gain"):
            return (1.0 + 0.2 * rng.randn(*shape)).astype(np.float32)
        if name == "bias":
            return (0.1 * rng.randn(*shape)).astype(np.float32)
        if name == "mean":
            return (0.2 * rng.randn(*shape)).astype(np.float32)
        if name == "var":
            return (0.5 + rng.rand(*shape)).astype(np.float32)
        if name == "skip_gain":
            return np.asarray(0.5 + rng.rand(), np.float32)
        raise KeyError(f"no seeded value for the flax leaf {name!r}")

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _nhwc(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(x.transpose(0, 3, 1, 2).copy())


def _close(got, want, tol):
    """An NCHW tensor against an NHWC array, within tol * max|want|."""
    want = np.asarray(want)
    got = got.detach().numpy().transpose(0, 2, 3, 1)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def _spec(encoder):
    spec = encoder.get_output_spec()
    return tuple(spec.channels), tuple(spec.strides)


def _run(jmodule, tmodule, x, training, seed, **apply_kw):
    """(torch output, flax output) on the same seeded variables; in train
    mode flax's updated running statistics are held against the port's."""
    variables = _init(jmodule, x, seed=seed, **apply_kw)
    load_flax_variables(tmodule, variables)
    if "batch_stats" in variables and training:
        apply = jax.jit(functools.partial(jmodule.apply, mutable=["batch_stats"], training=True, **apply_kw))
        want, new = apply(variables, x)
        got = tmodule.train()(_nchw(x))
        assert _check_running_stats(tmodule, new["batch_stats"]) == len(
            jax.tree_util.tree_leaves(variables["batch_stats"]))
        return got, want
    want = jax.jit(functools.partial(jmodule.apply, **apply_kw))(variables, x)
    with torch.no_grad():
        got = tmodule.train(training)(_nchw(x))
    return got, want


MODES = pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])

# ---------------------------------------------------------------------------
# MaxViT
# ---------------------------------------------------------------------------

# name: (in channels, out, heads, stride, partition, map size)
_BLOCKS = {
    "stride2-8x8": (8, 16, 2, 2, 4, (16, 16)),
    "stride1-same-channels": (16, 16, 2, 1, 4, (8, 8)),
    "stride1-new-channels-padded": (8, 12, 3, 1, 4, (6, 10)),
    "stride2-padded-odd": (8, 16, 4, 2, 4, (14, 10)),
}


@MODES
@pytest.mark.parametrize("name", list(_BLOCKS))
def test_maxvit_block_matches_flax(name, training):
    cin, cout, heads, stride, p, size = _BLOCKS[name]
    x = _nhwc((2, *size, cin), seed=1)
    jblock = jmaxvit.MaxViTBlock(cout, num_heads=heads, stride=stride, partition=p)
    got, want = _run(jblock, MaxViTBlock(cin, cout, heads, stride=stride, partition=p), x, training, seed=2)
    _close(got, want, TOL if not training else MODEL_TOL)


_NARROW = dict(stem_channels=8, stage_channels=(16, 16, 24, 32), stage_blocks=(1, 2, 1, 1), num_heads=(2, 2, 3, 4))


@MODES
@pytest.mark.parametrize("layers", [None, (1, 2, 3, 4)])
def test_maxvit_encoder_with_padding_matches_flax(layers, training):
    """160^2, partition 8: stage maps 80, 40 (no padding), 20, 10, 5 (padded
    to 24, 16, 8)."""
    jenc, tenc = jmaxvit.MaxViTEncoder(**_NARROW, layers=layers), MaxViTEncoder(**_NARROW, layers=layers)
    assert _spec(tenc) == _spec(jenc)
    x = _nhwc((2, 160, 160, 3), seed=3)
    got, want = _run(jenc, tenc, x, training, seed=4)
    assert len(got) == len(want) == len(tenc.get_output_spec())
    for g, w in zip(got, want):
        _close(g, w, MODEL_TOL)


def test_maxvit_use_remat_gradients_match_flax():
    """Train mode: the gradients of a seeded weighted sum of the maps through
    the rematerialized encoder against ``jax.grad`` through flax's
    ``nn.remat``, within 1e-4 * max|g| over the encoder; the running
    statistics are updated once (the recomputation leaves them as the
    forward did), as flax's are."""
    config = dict(_NARROW, stage_blocks=(1, 1, 1, 1))
    x = _nhwc((2, 64, 64, 3), seed=5)
    jenc, tenc = jmaxvit.MaxViTEncoder(**config, use_remat=True), MaxViTEncoder(**config, use_remat=True)
    variables = _init(jenc, x, seed=6)
    load_flax_variables(tenc, variables)
    shapes = [o.shape for o in jax.eval_shape(lambda: jenc.apply(variables, x, training=True,
                                                                 mutable=["batch_stats"])[0])]
    weights = [_nhwc(s, seed=7 + i) for i, s in enumerate(shapes)]

    def loss(params):
        maps, new = jenc.apply({"params": params, "batch_stats": variables["batch_stats"]}, x, training=True,
                               mutable=["batch_stats"])
        return sum(jnp.sum(m * w) for m, w in zip(maps, weights)), new["batch_stats"]

    jgrads, new_stats = jax.jit(jax.grad(loss, has_aux=True))(variables["params"])
    maps = tenc.train()(_nchw(x))
    sum((m * _nchw(w)).sum() for m, w in zip(maps, weights)).backward()
    assert _check_running_stats(tenc, new_stats) == len(jax.tree_util.tree_leaves(variables["batch_stats"]))
    want = load_flax_variables(MaxViTEncoder(**config),
                               {"params": jax.tree_util.tree_map(np.asarray, jgrads),
                                "batch_stats": variables["batch_stats"]})
    scale = max(float(g.detach().abs().max()) for g in want.parameters())
    for (name, p), (_, g) in zip(tenc.named_parameters(), want.named_parameters()):
        assert p.grad is not None, name
        assert float((p.grad - g.detach()).abs().max()) <= MODEL_TOL * scale, name


@pytest.fixture(scope="module")
def narrow_maxvit_fpn():
    """MaxViT (8; 16, 16, 24, 32) on its four stages + FPNDecoder(16) +
    ResizeHead(3), bridged: the chip run's model, narrow."""
    config = dict(_NARROW, stage_blocks=(1, 1, 1, 1), layers=(1, 2, 3, 4))
    jenc = jmaxvit.MaxViTEncoder(**config)
    jdec = JFPNDecoder(input_spec=jenc.get_output_spec(), out_channels=16)
    jmodel = JEncoderDecoderModel(jenc, jdec, JResizeHead(input_spec=jdec.get_output_spec(), num_classes=3))
    tenc = MaxViTEncoder(**config)
    tdec = FPNDecoder(tenc.get_output_spec(), 16)
    tmodel = EncoderDecoderModel(tenc, tdec, ResizeHead(tdec.get_output_spec(), 3))
    variables = _init(jmodel, jnp.zeros((1, 128, 128, 3)), seed=8)
    load_flax_variables(tmodel, variables)
    return jmodel, variables, tmodel.eval()


def test_narrow_maxvit_fpn_matches_flax(narrow_maxvit_fpn):
    jmodel, variables, tmodel = narrow_maxvit_fpn
    x = _nhwc((2, 128, 128, 3), seed=9)
    want = jax.jit(jmodel.apply)(variables, x)
    with torch.no_grad():
        got = tmodel(_nchw(x))
    assert tuple(got.shape) == (2, 3, 128, 128)
    _close(got, want, MODEL_TOL)


@pytest.mark.parametrize("mode", ["distributed", "full"])
def test_narrow_maxvit_fpn_through_tiled_d4_matches_jax(narrow_maxvit_fpn, mode):
    """The slice as a whole: both packages' ``tiled_apply_d4_tta`` on a
    256^2 image in 128 / 64 tiles."""
    jmodel, variables, tmodel = narrow_maxvit_fpn
    image = np.random.RandomState(10).rand(256, 256, 3).astype(np.float32)
    want = np.asarray(j_tiled_apply_d4_tta(lambda x: jmodel.apply(variables, x), jnp.asarray(image), tile_size=128,
                                           tile_step=64, batch_size=32, mode=mode))
    with torch.no_grad():
        got = tiled_apply_d4_tta(tmodel, torch.from_numpy(image.transpose(2, 0, 1).copy()), tile_size=128,
                                 tile_step=64, batch_size=32, mode=mode)
    assert got.shape == (3, 256, 256) and got.dtype == torch.float32
    got = got.numpy().transpose(1, 2, 0)
    assert np.abs(got - want).max() <= MODEL_TOL * np.abs(want).max()


# ---------------------------------------------------------------------------
# NFNet
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kernel,stride,groups,size", [((3, 3), 1, 1, (9, 8)), ((3, 3), 2, 1, (10, 12)),
                                                       ((3, 3), 2, 2, (11, 9)), ((1, 1), 1, 1, (5, 6))])
def test_wsconv_matches_flax(kernel, stride, groups, size):
    """Standardization at every call (population variance), flax SAME at
    stride 2 on even and odd sides, grouped."""
    x = _nhwc((2, *size, 8), seed=11)
    got, want = _run(jnfnet.WSConv(12, kernel, stride=stride, groups=groups),
                     WSConv(8, 12, kernel, stride=stride, groups=groups), x, False, seed=12)
    _close(got, want, TOL)


def test_wsconv_floor_of_the_variance():
    """A kernel of variance 1e-6 at fan_in 36: var * fan_in = 3.6e-5 is
    clamped at 1e-4 in both packages (the scale is 100 * gain, not 167)."""
    x = _nhwc((1, 6, 6, 4), seed=13)
    jconv, tconv = jnfnet.WSConv(3, (3, 3)), WSConv(4, 3, (3, 3))
    variables = _init(jconv, x, seed=14)
    kernel = variables["params"]["kernel"]
    variables["params"]["kernel"] = (1e-3 * np.random.RandomState(15).randn(*kernel.shape)).astype(np.float32)
    load_flax_variables(tconv, variables)
    want = jconv.apply(variables, x)
    with torch.no_grad():
        got = tconv(_nchw(x))
    _close(got, want, TOL)


# name: (in channels, out, stride, size)
_NF_BLOCKS = {
    "transition-stride2": (16, 32, 2, (8, 10)),
    "stride2-same-channels": (16, 16, 2, (8, 8)),
    "stride1-new-channels": (16, 24, 1, (7, 9)),
    "identity": (16, 16, 1, (7, 9)),
    "grouped-width": (256, 512, 2, (4, 4)),
}


@pytest.mark.parametrize("name", list(_NF_BLOCKS))
def test_nf_block_matches_flax(name):
    """``skip_gain`` seeded non-zero, so the residual branch is compared."""
    cin, cout, stride, size = _NF_BLOCKS[name]
    x = _nhwc((2, *size, cin), seed=15)
    jblock = jnfnet.NFBlock(cout, stride=stride, alpha=0.2, beta=0.9)
    tblock = NFBlock(cin, cout, stride=stride, alpha=0.2, beta=0.9)
    variables = _init(jblock, x, seed=16)
    assert float(variables["params"]["skip_gain"]) != 0.0
    load_flax_variables(tblock, variables)
    want = jax.jit(jblock.apply)(variables, x)
    with torch.no_grad():
        got = tblock(_nchw(x))
        tblock.skip_gain.zero_()
        shortcut_only = tblock(_nchw(x))
    assert float((got - shortcut_only).abs().max()) > 1e-2 * float(got.abs().max())  # the branch counts
    _close(got, want, TOL)


_NF_NARROW = dict(stage_blocks=(1, 2, 1, 1), stage_channels=(16, 32, 32, 48))


@pytest.mark.parametrize("layers", [None, (1, 2, 4)])
def test_nfnet_encoder_matches_flax(layers):
    jenc = jnfnet.NFNetEncoder(**_NF_NARROW, layers=layers)
    tenc = NFNetEncoder(**_NF_NARROW, layers=layers)
    assert _spec(tenc) == _spec(jenc)
    x = _nhwc((2, 64, 64, 3), seed=17)
    got, want = _run(jenc, tenc, x, False, seed=18)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w, MODEL_TOL)


def test_nfnet_encoder_on_an_odd_map_matches_flax():
    """66^2 -> 33 -> 17 at the stem's two stride-2 convs (SAME pads (0, 1),
    then (1, 1)), one stage of two blocks at stride 1."""
    config = dict(stage_blocks=(2,), stage_channels=(24,))
    x = _nhwc((2, 66, 66, 3), seed=19)
    got, want = _run(jnfnet.NFNetEncoder(**config), NFNetEncoder(**config), x, False, seed=20)
    assert got[0].shape[-1] == 17
    for g, w in zip(got, want):
        _close(g, w, MODEL_TOL)


def test_nfnet_beta_schedule_equals_the_jax_package():
    """beta = 1 / sqrt(expected variance), reset after each stage's first
    block, read off the flax module tree."""
    config = dict(stage_blocks=(2, 3, 1, 2), stage_channels=(8, 8, 8, 8))
    tenc = NFNetEncoder(**config)
    expected_var, want = 1.0, []
    for stage, n in enumerate(config["stage_blocks"]):
        for i in range(n):
            want.append(1.0 / expected_var**0.5)
            if i == 0:
                expected_var = 1.0
            expected_var += 0.2**2
    assert [b.beta for blocks in tenc.stages for b in blocks] == pytest.approx(want, rel=0, abs=0)
    _, want_state = jax.eval_shape(lambda: jnfnet.NFNetEncoder(**config).init_with_output(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))
    assert len([k for k in want_state["params"] if k.startswith("NFBlock_")]) == len(want)
