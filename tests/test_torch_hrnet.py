"""Parity of the port's HRNet V2 (its fuse layer, module and encoder) with
the JAX package on the CPU, and of HRNetV2 + HypercolumnHead through both
packages' ``tiled_apply_d4_tta``.

The flax variables are seeded numpy values in the shapes of the flax init
(``jax.eval_shape``) and reach the torch modules through
``load_flax_variables``, as in ``test_torch_mobile_encoders.py``, whose
helpers these tests share.  Every module runs in eval mode, and in train
mode, where the running statistics are held to flax's within 1e-5.  The
encoders run at reduced width and depth (every factory is checked against
the flax tree in ``test_torch_cnn_factories.py``).

The strided 3x3 convs are flax ``SAME``; the maps run at even sizes, where
that differs from symmetric padding, and at odd ones, where the fuse
layers' nearest resizes have ratios that are not whole numbers.

Tolerances: 1e-5 * max|ref| for one block (``TOL``), 1e-4 * max|ref| for
an encoder and the tiled model (``MODEL_TOL``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_toolbelt_tpu.inference import tiled_apply_d4_tta as j_tiled_apply_d4_tta
from pytorch_toolbelt_tpu.nn import Identity as JIdentity
from pytorch_toolbelt_tpu.zoo import EncoderDecoderModel as JEncoderDecoderModel
from pytorch_toolbelt_tpu.zoo.encoders import hrnet as jhrnet
from pytorch_toolbelt_tpu.zoo.heads import hypercolumn as jhypercolumn
from pytorch_toolbelt_tpu_torch.inference import tiled_apply_d4_tta
from pytorch_toolbelt_tpu_torch.nn import Identity
from pytorch_toolbelt_tpu_torch.zoo import EncoderDecoderModel, HRNetEncoder, HypercolumnHead, load_flax_variables
from pytorch_toolbelt_tpu_torch.zoo.encoders.hrnet import _FuseLayer, _HRModule
from test_torch_mobile_encoders import MODEL_TOL, MODES, TOL, _close, _init, _run, _spec


def _maps(channels, sizes, seed):
    rng = np.random.RandomState(seed)
    xs = [rng.randn(2, s, s, c).astype(np.float32) for c, s in zip(channels, sizes)]
    return xs, [torch.from_numpy(x.transpose(0, 3, 1, 2).copy()) for x in xs]


_BRANCHES = {"2-branches-even": ((4, 8), (8, 4)), "3-branches-odd": ((4, 8, 16), (9, 5, 3)),
             "4-branches-even": ((3, 6, 12, 24), (16, 8, 4, 2))}


@MODES
@pytest.mark.parametrize("name", list(_BRANCHES))
def test_fuse_layer_matches_flax(name, training):
    """Every (i, j) path: 1x1 + nearest resize up, chains of strided SAME 3x3 down."""
    channels, sizes = _BRANCHES[name]
    xs, txs = _maps(channels, sizes, seed=1)
    got, want = _run(jhrnet._FuseLayer(channels), _FuseLayer(channels), xs, txs, training, seed=2)
    assert len(got) == len(want) == len(channels)
    for g, w in zip(got, want):
        _close(g, w, TOL)


@MODES
@pytest.mark.parametrize("num_blocks", [1, 2])
def test_hr_module_matches_flax(num_blocks, training):
    channels, sizes = (4, 8, 16), (10, 5, 3)
    xs, txs = _maps(channels, sizes, seed=3)
    got, want = _run(jhrnet._HRModule(channels, num_blocks=num_blocks), _HRModule(channels, num_blocks), xs, txs,
                     training, seed=4)
    for g, w in zip(got, want):
        _close(g, w, TOL)


# two stage-1 Bottlenecks, two modules in stage 3, one BasicBlock per branch
_ENCODER = dict(width=8, stage_modules=(1, 2, 1), blocks_per_module=1, stage1_blocks=2)


@MODES
@pytest.mark.parametrize("layers", [None, (0, 3)], ids=["all-maps", "layers"])
def test_hrnet_encoder_matches_flax(layers, training):
    """At 66^2 in eval mode (odd maps from stride 2 on: 33, 17, 9, 5, 3) and
    at 128^2 in train mode (even maps), so that the stride-32 BatchNorms see
    more than 2 x 2 x 2 values (see test_torch_mobile_encoders.py)."""
    jenc, tenc = jhrnet.HRNetEncoder(**_ENCODER, layers=layers), HRNetEncoder(**_ENCODER, layers=layers)
    assert _spec(tenc) == _spec(jenc)
    size = 128 if training else 66
    x = np.random.RandomState(5).randn(2, size, size, 3).astype(np.float32)
    got, want = _run(jenc, tenc, x, torch.from_numpy(x.transpose(0, 3, 1, 2).copy()), training, seed=6)
    assert len(got) == len(want) == len(tenc.get_output_spec())
    for g, w, c in zip(got, want, tenc.get_output_spec().channels):
        assert g.shape[1] == c
        _close(g, w, MODEL_TOL)


_NARROW = dict(width=8, stage_modules=(1, 1, 1), blocks_per_module=2, stage1_blocks=1)


@pytest.fixture(scope="module")
def narrow_hrnet():
    """HRNetV2 at width 8 with one module per stage + HypercolumnHead(16), 3 classes, bridged."""
    jenc = jhrnet.HRNetEncoder(**_NARROW)
    jmodel = JEncoderDecoderModel(encoder=jenc, decoder=JIdentity(),
                                  head=jhypercolumn.HypercolumnHead(jenc.get_output_spec(), 3, mid_channels=16))
    tenc = HRNetEncoder(**_NARROW)
    tmodel = EncoderDecoderModel(tenc, Identity(), HypercolumnHead(tenc.get_output_spec(), 3, mid_channels=16))
    variables = _init(jmodel, jnp.zeros((1, 64, 64, 3)), seed=7)
    load_flax_variables(tmodel, variables)
    return jmodel, variables, tmodel.eval()


@pytest.mark.parametrize("mode", ["distributed", "full"])
def test_narrow_hrnet_through_tiled_d4_matches_jax(narrow_hrnet, mode):
    """The slice as a whole: both packages' ``tiled_apply_d4_tta`` on a
    256^2 image in 128 / 64 tiles (K1's plain version here)."""
    jmodel, variables, tmodel = narrow_hrnet
    image = np.random.RandomState(8).rand(256, 256, 3).astype(np.float32)
    want = np.asarray(j_tiled_apply_d4_tta(jax.jit(lambda x: jmodel.apply(variables, x)), jnp.asarray(image),
                                           tile_size=128, tile_step=64, batch_size=16, mode=mode))
    with torch.no_grad():
        got = tiled_apply_d4_tta(tmodel, torch.from_numpy(image.transpose(2, 0, 1).copy()), tile_size=128,
                                 tile_step=64, batch_size=16, mode=mode)
    assert got.shape == (3, 256, 256) and got.dtype == torch.float32
    want = want.transpose(2, 0, 1)
    assert np.abs(got.numpy() - want).max() <= MODEL_TOL * np.abs(want).max()
