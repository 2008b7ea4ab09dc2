"""Parity of the port's transformer encoders (MiT and Swin) and of
SegFormer-B2 with the JAX package, on the CPU.

The flax variables are seeded numpy values in the shapes of the flax init
(``jax.eval_shape``), and they reach the torch modules through
``load_flax_variables``.  Maps are NHWC in JAX and NCHW in the port; inside
MiT the port's tokens are [B, h * w, C] (row-major, as an NHWC map
flattens), inside Swin [B, H, W, C] as in JAX.

Tolerances: 1e-5 * max|ref| for one block (``TOL``), 1e-4 * max|ref|
(``MODEL_TOL``) for encoders and models, where the rounding differences of
XLA's and torch's matmuls and convolutions add up through the layers.  Train
mode at drop-path 0 is the eval forward (there is no BatchNorm in MiT or
Swin), so the blocks are compared in eval mode.

The stride-2 and -4 convs are flax ``SAME`` convs: the encoders run on even
inputs, where ``SAME`` pads asymmetrically, and on odd ones.  Swin runs at
200^2 (patch 4: a 50^2 map, padded to 56^2 by the 7x7 windows and shifted).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_toolbelt_tpu.inference import tiled_apply_d4_tta as j_tiled_apply_d4_tta
from pytorch_toolbelt_tpu.nn import Identity as JIdentity
from pytorch_toolbelt_tpu.zoo import EncoderDecoderModel as JEncoderDecoderModel
from pytorch_toolbelt_tpu.zoo.encoders import mix_transformer as jmit
from pytorch_toolbelt_tpu.zoo.encoders import swin as jswin
from pytorch_toolbelt_tpu.zoo.heads import segformer as jsegformer
from pytorch_toolbelt_tpu_torch import zoo as tzoo
from pytorch_toolbelt_tpu_torch.inference import tiled_apply_d4_tta
from pytorch_toolbelt_tpu_torch.nn import Identity
from pytorch_toolbelt_tpu_torch.zoo import (
    EfficientSelfAttention,
    EncoderDecoderModel,
    MiTBlock,
    MixFFN,
    MixVisionTransformerEncoder,
    OverlapPatchEmbed,
    PatchMerging,
    SegFormerHead,
    SwinBlock,
    SwinTransformerEncoder,
    WindowAttention,
    load_flax_variables,
    mit_b2_encoder,
)
from pytorch_toolbelt_tpu_torch.zoo.encoders import swin as tswin
from pytorch_toolbelt_tpu_torch.zoo.porting import _leaves

TOL = 1e-5
MODEL_TOL = 1e-4


def _init(jmodule, *args, seed, **kwargs):
    """Seeded numpy values in the shapes of the flax module's variables:
    LeCun-normal kernels, LayerNorm scales near 1, small biases, Swin's
    relative-position bias table at the init's scale (0.02) times 10 so that
    it moves the softmax."""
    shapes = jax.eval_shape(lambda: jmodule.init(jax.random.PRNGKey(seed), *args, **kwargs))
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            return (rng.randn(*shape) * np.sqrt(1.0 / np.prod(shape[:-1]))).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.2 * rng.randn(*shape)).astype(np.float32)
        if name == "bias":
            return (0.1 * rng.randn(*shape)).astype(np.float32)
        if name == "relative_position_bias":
            return (0.2 * rng.randn(*shape)).astype(np.float32)
        if name == "mean":
            return (0.2 * rng.randn(*shape)).astype(np.float32)
        if name == "var":
            return (0.5 + rng.rand(*shape)).astype(np.float32)
        raise KeyError(f"no seeded value for the flax leaf {name!r}")

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _nhwc(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(x.transpose(0, 3, 1, 2).copy())


def _close(got, want, tol):
    """``got`` (numpy, already in JAX's layout) against ``want``."""
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def _spec(encoder):
    spec = encoder.get_output_spec()
    return tuple(spec.channels), tuple(spec.strides)


def _close_maps(got, want, tol):
    """Lists of NCHW maps against lists of NHWC maps."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g.detach().numpy().transpose(0, 2, 3, 1), w, tol)


# ---------------------------------------------------------------------------
# MiT blocks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size,patch,stride", [((64, 66), 7, 4), ((65, 63), 7, 4), ((16, 16), 3, 2), ((15, 17), 3, 2)])
def test_overlap_patch_embed_matches_flax(size, patch, stride):
    """flax SAME at stride 4 and 2, even and odd inputs."""
    x = _nhwc((2, *size, 5), seed=1)
    jmod = jmit.OverlapPatchEmbed(12, patch, stride)
    tmod = OverlapPatchEmbed(5, 12, patch, stride)
    variables = _init(jmod, x, seed=2)
    load_flax_variables(tmod, variables)
    want = np.asarray(jmod.apply(variables, x))
    with torch.no_grad():
        tokens, hw = tmod(_nchw(x))
    assert hw == want.shape[1:3]
    _close(tokens.numpy().reshape(want.shape), want, TOL)


@pytest.mark.parametrize("heads,sr,size", [(1, 1, (6, 7)), (2, 2, (8, 8)), (2, 4, (10, 12)), (5, 8, (16, 16))],
                         ids=["sr1", "sr2", "sr4-padded", "sr8-heads5"])
def test_efficient_self_attention_matches_flax(heads, sr, size):
    """The spatial-reduction conv is flax SAME: a 10 x 12 map at sr 4 pads."""
    dim = 10 * heads
    x = _nhwc((2, *size, dim), seed=3)
    jmod = jmit.EfficientSelfAttention(heads, sr)
    tmod = EfficientSelfAttention(dim, heads, sr)
    variables = _init(jmod, x, seed=4)
    load_flax_variables(tmod, variables)
    want = np.asarray(jmod.apply(variables, x))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x.reshape(2, -1, dim)), size)
    _close(got.numpy().reshape(want.shape), want, TOL)


def test_mix_ffn_matches_flax():
    x = _nhwc((2, 6, 9, 8), seed=5)
    jmod = jmit.MixFFN(32)
    tmod = MixFFN(8, 32)
    variables = _init(jmod, x, seed=6)
    load_flax_variables(tmod, variables)
    want = np.asarray(jmod.apply(variables, x))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x.reshape(2, -1, 8)), (6, 9))
    _close(got.numpy().reshape(want.shape), want, TOL)


@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
def test_mit_block_matches_flax(training):
    x = _nhwc((2, 8, 8, 20), seed=7)
    jmod = jmit.MiTBlock(num_heads=2, sr_ratio=2)
    tmod = MiTBlock(20, num_heads=2, sr_ratio=2)
    variables = _init(jmod, x, seed=8)
    load_flax_variables(tmod, variables)
    want = np.asarray(jmod.apply(variables, x, training=training))
    with torch.no_grad():
        got = tmod.train(training)(torch.from_numpy(x.reshape(2, -1, 20)), (8, 8))
    _close(got.numpy().reshape(want.shape), want, TOL)


# ---------------------------------------------------------------------------
# MiT encoders
# ---------------------------------------------------------------------------

_NARROW_MIT = dict(embed_dims=(16, 32, 40, 64), depths=(1, 1, 1, 1))


@pytest.mark.parametrize("size", [(64, 64), (70, 58), (67, 61)])
def test_mit_encoder_at_depth_one_matches_flax(size):
    x = _nhwc((2, *size, 3), seed=9)
    jenc = jmit.MixVisionTransformerEncoder(**_NARROW_MIT)
    tenc = MixVisionTransformerEncoder(**_NARROW_MIT)
    assert _spec(tenc) == _spec(jenc)
    variables = _init(jenc, x, seed=10)
    load_flax_variables(tenc, variables)
    with torch.no_grad():
        got = tenc.eval()(_nchw(x))
    _close_maps(got, jax.jit(jenc.apply)(variables, x), MODEL_TOL)


def test_mit_encoder_layers_and_drop_path_rates():
    """``layers`` picks maps; the drop-path rate grows linearly over all blocks."""
    x = _nhwc((1, 32, 32, 3), seed=11)
    jenc = jmit.MixVisionTransformerEncoder(**_NARROW_MIT, layers=(1, 3))
    tenc = MixVisionTransformerEncoder(**_NARROW_MIT, layers=(1, 3), drop_path_rate=0.3)
    assert _spec(tenc) == _spec(jenc)
    assert [b.drop_path.drop_prob for stage in tenc.blocks for b in stage] == pytest.approx([0.0, 0.1, 0.2, 0.3])
    variables = _init(jenc, x, seed=12)
    load_flax_variables(tenc, variables)
    with torch.no_grad():
        got = tenc.eval()(_nchw(x))
    _close_maps(got, jax.jit(jenc.apply)(variables, x), MODEL_TOL)


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


@pytest.mark.parametrize("name", ["mit_b0_encoder", "mit_b1_encoder", "mit_b2_encoder", "mit_b3_encoder",
                                  "mit_b4_encoder", "mit_b5_encoder"])
def test_mit_factories_fit_the_jax_parameter_tree(name):
    jenc = getattr(jmit, name)()
    with torch.device("meta"):
        tenc = getattr(tzoo, name)()
    _assert_fits_the_flax_tree(tenc, jenc, jnp.zeros((1, 32, 32, 3)))
    assert _spec(tenc) == _spec(jenc)


@pytest.fixture(scope="module")
def segformer_b2():
    """SegFormer-B2 at its published width (MiT-B2 + SegFormerHead(768), 19
    classes) in both packages, bridged."""
    jenc = jmit.mit_b2_encoder()
    jmodel = JEncoderDecoderModel(encoder=jenc, decoder=JIdentity(),
                                  head=jsegformer.SegFormerHead(jenc.get_output_spec(), 19, embedding_dim=768))
    tenc = mit_b2_encoder()
    tmodel = EncoderDecoderModel(tenc, Identity(), SegFormerHead(tenc.get_output_spec(), 19, embedding_dim=768))
    variables = _init(jmodel, jnp.zeros((1, 64, 64, 3)), seed=14)
    load_flax_variables(tmodel, variables)
    return jmodel, variables, tmodel.eval()


def test_mit_b2_encoder_at_full_width_matches_flax(segformer_b2):
    jmodel, variables, tmodel = segformer_b2
    x = _nhwc((2, 64, 64, 3), seed=15)
    want = jax.jit(jmodel.encoder.apply)({"params": variables["params"]["encoder"]}, x)
    with torch.no_grad():
        got = tmodel.encoder(_nchw(x))
    _close_maps(got, want, MODEL_TOL)


def test_segformer_b2_matches_flax(segformer_b2):
    """The chip run's model on a small input: [2, 3, 64, 64] -> [2, 19, 64, 64]."""
    jmodel, variables, tmodel = segformer_b2
    x = _nhwc((2, 64, 64, 3), seed=16)
    want = np.asarray(jax.jit(jmodel.apply)(variables, x))
    with torch.no_grad():
        got = tmodel(_nchw(x))
    assert tuple(got.shape) == (2, 19, 64, 64)
    _close(got.numpy().transpose(0, 2, 3, 1), want, MODEL_TOL)


_NARROW_SEGFORMER_MIT = dict(embed_dims=(16, 32, 40, 64))  # the default heads (1, 2, 5, 8) divide these


@pytest.fixture(scope="module")
def narrow_segformer():
    """MiT (16, 32, 40, 64) at the default depths (2, 2, 2, 2) + SegFormerHead(32), 3 classes, bridged."""
    jenc = jmit.MixVisionTransformerEncoder(**_NARROW_SEGFORMER_MIT)
    jmodel = JEncoderDecoderModel(encoder=jenc, decoder=JIdentity(),
                                  head=jsegformer.SegFormerHead(jenc.get_output_spec(), 3, embedding_dim=32))
    tenc = MixVisionTransformerEncoder(**_NARROW_SEGFORMER_MIT)
    tmodel = EncoderDecoderModel(tenc, Identity(), SegFormerHead(tenc.get_output_spec(), 3, embedding_dim=32))
    variables = _init(jmodel, jnp.zeros((1, 128, 128, 3)), seed=17)
    load_flax_variables(tmodel, variables)
    return jmodel, variables, tmodel.eval()


@pytest.mark.parametrize("mode", ["distributed", "full"])
def test_narrow_segformer_through_tiled_d4_matches_jax(narrow_segformer, mode):
    """The slice as a whole: both packages' ``tiled_apply_d4_tta`` on a
    768^2 image in 256 / 128 tiles."""
    jmodel, variables, tmodel = narrow_segformer
    image = np.random.RandomState(18).rand(768, 768, 3).astype(np.float32)
    want = np.asarray(j_tiled_apply_d4_tta(lambda x: jmodel.apply(variables, x), jnp.asarray(image), tile_size=256,
                                           tile_step=128, batch_size=16, mode=mode))
    with torch.no_grad():
        got = tiled_apply_d4_tta(tmodel, torch.from_numpy(image.transpose(2, 0, 1).copy()), tile_size=256,
                                 tile_step=128, batch_size=16, mode=mode)
    assert got.shape == (3, 768, 768) and got.dtype == torch.float32
    _close(got.numpy().transpose(1, 2, 0), want, MODEL_TOL)


# ---------------------------------------------------------------------------
# Swin
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ws", [3, 7])
def test_swin_helpers_equal_the_jax_package(ws):
    np.testing.assert_array_equal(tswin._relative_position_index(ws), jswin._relative_position_index(ws))
    np.testing.assert_array_equal(tswin._shift_attn_mask(4 * ws, 3 * ws, ws, ws // 2),
                                  jswin._shift_attn_mask(4 * ws, 3 * ws, ws, ws // 2))


@pytest.mark.parametrize("masked", [False, True])
def test_window_attention_matches_flax(masked):
    ws, heads, dim = 3, 2, 12
    nw = 4  # windows per image
    x = _nhwc((2 * nw, ws * ws, dim), seed=19)
    mask = jswin._shift_attn_mask(2 * ws, 2 * ws, ws, 1) if masked else None
    jmod = jswin.WindowAttention(heads, ws)
    tmod = WindowAttention(dim, heads, ws)
    variables = _init(jmod, x, mask, seed=20)
    load_flax_variables(tmod, variables)
    np.testing.assert_array_equal(tmod.relative_position_bias.detach().numpy(),
                                  variables["params"]["relative_position_bias"])
    want = np.asarray(jmod.apply(variables, x, mask))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x), None if mask is None else torch.from_numpy(mask))
    _close(got.numpy(), want, TOL)


@pytest.mark.parametrize("shift,size", [(False, (9, 9)), (True, (9, 11)), (True, (14, 14)), (True, (7, 9))],
                         ids=["plain-padded", "shifted-padded", "shifted", "no-shift-at-window-size"])
def test_swin_block_matches_flax(shift, size):
    """Padding to the window multiple, the shift and its mask; a map whose
    short side equals the window does not shift."""
    x = _nhwc((2, *size, 12), seed=21)
    jmod = jswin.SwinBlock(num_heads=3, window_size=7, shift=shift)
    tmod = SwinBlock(12, num_heads=3, window_size=7, shift=shift)
    variables = _init(jmod, x, seed=22)
    load_flax_variables(tmod, variables)
    want = np.asarray(jmod.apply(variables, x))
    with torch.no_grad():
        got = tmod.eval()(torch.from_numpy(x))
    _close(got.numpy(), want, TOL)


@pytest.mark.parametrize("size", [(6, 8), (7, 5)])
def test_patch_merging_matches_flax(size):
    """(p1 p2 c) concatenation order; odd sizes pad."""
    x = _nhwc((2, *size, 6), seed=23)
    jmod = jswin.PatchMerging()
    tmod = PatchMerging(6)
    variables = _init(jmod, x, seed=24)
    load_flax_variables(tmod, variables)
    want = np.asarray(jmod.apply(variables, x))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    _close(got.numpy(), want, TOL)


_NARROW_SWIN = dict(embed_dim=16, depths=(2, 2, 2, 2), num_heads=(2, 2, 4, 4))


@pytest.mark.parametrize("size", [(200, 200), (130, 114)])
def test_swin_encoder_matches_flax(size):
    """200^2: a 50^2 stage-1 map, padded to 56^2 and shifted; then 25^2,
    13^2 (odd: PatchMerging pads) and 7^2 (no shift)."""
    x = _nhwc((1, *size, 3), seed=25)
    jenc = jswin.SwinTransformerEncoder(**_NARROW_SWIN)
    tenc = SwinTransformerEncoder(**_NARROW_SWIN)
    assert _spec(tenc) == _spec(jenc)
    variables = _init(jenc, x, seed=26)
    load_flax_variables(tenc, variables)
    with torch.no_grad():
        got = tenc.eval()(_nchw(x))
    _close_maps(got, jax.jit(jenc.apply)(variables, x), MODEL_TOL)


@pytest.mark.parametrize("name", ["swin_tiny_encoder", "swin_small_encoder", "swin_base_encoder",
                                  "swin_large_encoder"])
def test_swin_factories_fit_the_jax_parameter_tree(name):
    jenc = getattr(jswin, name)(layers=(0, 2))
    with torch.device("meta"):
        tenc = getattr(tzoo, name)(layers=(0, 2))
    _assert_fits_the_flax_tree(tenc, jenc, jnp.zeros((1, 32, 32, 3)))
    assert _spec(tenc) == _spec(jenc)


# ---------------------------------------------------------------------------
# use_remat: per-block recomputation on the backward pass
# ---------------------------------------------------------------------------

_REMAT = {
    "mit": (jmit.MixVisionTransformerEncoder, MixVisionTransformerEncoder, _NARROW_MIT, (1, 64, 58, 3)),
    "swin": (jswin.SwinTransformerEncoder, SwinTransformerEncoder, _NARROW_SWIN, (1, 64, 64, 3)),
}


@pytest.mark.parametrize("family", sorted(_REMAT))
def test_use_remat_gradients_match_flax(family):
    """The gradients of a seeded weighted sum of the maps through the
    rematerialized encoder in train mode, against ``jax.grad`` through flax's
    ``nn.remat`` (the flax gradient tree loads into a copy of the encoder,
    whose parameters are then held against the port's ``.grad``), within
    1e-4 * max|g| over the encoder: the key projections' biases have a zero
    gradient (softmax does not see them), so only rounding noise, which a
    limit per tensor would hold to its own scale."""
    jcls, tcls, config, shape = _REMAT[family]
    x = _nhwc(shape, seed=41)
    jenc, tenc = jcls(**config, use_remat=True), tcls(**config, use_remat=True)
    variables = _init(jenc, x, seed=42)
    load_flax_variables(tenc, variables)
    shapes = [o.shape for o in jax.eval_shape(lambda: jenc.apply(variables, x, training=True))]
    weights = [_nhwc(s, seed=43 + i) for i, s in enumerate(shapes)]

    def loss(params):
        maps = jenc.apply({"params": params}, x, training=True)
        return sum(jnp.sum(m * w) for m, w in zip(maps, weights))

    jgrads = jax.jit(jax.grad(loss))(variables["params"])
    maps = tenc.train()(_nchw(x))
    sum((m * _nchw(w)).sum() for m, w in zip(maps, weights)).backward()
    want = load_flax_variables(tcls(**config), {"params": jax.tree_util.tree_map(np.asarray, jgrads)})
    scale = max(float(g.detach().abs().max()) for g in want.parameters())
    for (name, p), (_, g) in zip(tenc.named_parameters(), want.named_parameters()):
        assert p.grad is not None, name
        assert float((p.grad - g.detach()).abs().max()) <= MODEL_TOL * scale, name


@pytest.mark.parametrize("family", sorted(_REMAT))
def test_use_remat_replays_the_drop_path_masks(family):
    """At drop-path 0.5 from a seeded generator, the rematerialized encoder's
    outputs and gradients equal the plain one's, and the generator ends
    where the plain run leaves it (the recomputation replays the masks)."""
    _, tcls, config, shape = _REMAT[family]
    x = _nchw(_nhwc((4, *shape[1:]), seed=44))
    results = []
    for use_remat in (False, True):
        torch.manual_seed(45)
        gen = torch.Generator().manual_seed(46)
        enc = tcls(**config, drop_path_rate=0.5, use_remat=use_remat, generator=gen).train()
        maps = enc(x)
        sum((m * m).sum() for m in maps).backward()
        results.append(([m.detach() for m in maps], [p.grad for p in enc.parameters()], gen.get_state()))
    (maps, grads, state), (remat_maps, remat_grads, remat_state) = results
    for got, want in zip(remat_maps + remat_grads, maps + grads):
        assert torch.equal(got, want)
    assert torch.equal(remat_state, state)
