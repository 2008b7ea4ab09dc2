"""Parity of the port's CNN encoders (XResNet, Res2Net, SKResNet, DenseNet,
DPN) with the JAX package on the CPU, at reduced depth (one or two blocks a
stage) and, where the module has a width option, reduced width.

The flax variables are seeded numpy values in the shapes of the flax init
and reach the torch modules through ``load_flax_variables``; the helpers
are ``test_torch_mobile_encoders.py``'s.  Each encoder runs in eval mode
and in train mode, where the running statistics are held to flax's within
1e-5; in train mode at 128^2, so that the stride-32 BatchNorms normalise
over more than a few values.  In eval mode the input is odd (66^2) where
the JAX package takes that (not XResNet's and Res2Net's stride-2 blocks,
whose pooled paths floor).

Tolerance: 1e-4 * max|ref| (``MODEL_TOL``).
"""

import pytest

from pytorch_toolbelt_tpu.zoo.encoders import densenet as jdensenet
from pytorch_toolbelt_tpu.zoo.encoders import dpn as jdpn
from pytorch_toolbelt_tpu.zoo.encoders import res2net as jres2net
from pytorch_toolbelt_tpu.zoo.encoders import skresnet as jskresnet
from pytorch_toolbelt_tpu.zoo.encoders import xresnet as jxresnet
from pytorch_toolbelt_tpu_torch import zoo
from test_torch_mobile_encoders import MODEL_TOL, MODES, _close, _input, _run, _spec

_DPN_SMALL = dict(stage_blocks=(1, 2, 1, 1), base_width=(16, 16, 32, 32), res_width=(16, 32, 32, 64),
                  inc=(4, 4, 8, 8), groups=4, stem_channels=8, small_stem=True)

# name: (JAX class, port class name, kwargs, size in eval mode; train mode runs at 128^2)
_ENCODERS = {
    "xresnet-basic": (jxresnet.XResNetEncoder, "XResNetEncoder", dict(expansion=1, blocks=(1, 1, 1, 1)), 64),
    "se-xresnet-bottleneck-layers": (jxresnet.XResNetEncoder, "XResNetEncoder",
                                     dict(expansion=4, blocks=(1, 1, 1, 1), use_se=True, layers=(1, 4)), 64),
    "res2net": (jres2net.Res2NetEncoder, "Res2NetEncoder", dict(stage_blocks=(1, 1, 1, 1)), 64),
    "res2next": (jres2net.Res2NetEncoder, "Res2NetEncoder",
                 dict(stage_blocks=(1, 2, 1, 1), base_width=4, groups=8), 64),
    "skresnet-basic": (jskresnet.SKResNetEncoder, "SKResNetEncoder", dict(stage_blocks=(1, 1, 1, 1)), 66),
    "skresnext": (jskresnet.SKResNetEncoder, "SKResNetEncoder",
                  dict(stage_blocks=(1, 1, 1, 1), bottleneck=True, groups=32, base_width=4), 64),
    "densenet": (jdensenet.DenseNetEncoder, "DenseNetEncoder",
                 dict(block_config=(2, 2, 2, 2), growth_rate=8, num_init_features=16), 66),
    "dpn": (jdpn.DPNEncoder, "DPNEncoder", _DPN_SMALL, 66),
    "dpn-b-style-7x7-stem": (jdpn.DPNEncoder, "DPNEncoder", {**_DPN_SMALL, "b_style": True, "small_stem": False},
                             64),
}


@MODES
@pytest.mark.parametrize("name", list(_ENCODERS))
def test_encoder_matches_flax(name, training):
    jcls, tname, kwargs, size = _ENCODERS[name]
    jenc, tenc = jcls(**kwargs), getattr(zoo, tname)(**kwargs)
    assert _spec(tenc) == _spec(jenc)
    if training:
        size = 128
    x, tx = _input((2, size, size, 3), seed=21)
    got, want = _run(jenc, tenc, x, tx, training, seed=22)
    assert len(got) == len(want) == len(tenc.get_output_spec())
    for g, w, c in zip(got, want, tenc.get_output_spec().channels):
        assert g.shape[1] == c
        _close(g, w, MODEL_TOL)
