"""Parity of the port's InceptionV4 (flax ``SAME`` and ``torch_compat``
padding) and WiderResNet (base, A2, dilated A2) encoders with the JAX
package on the CPU, at reduced depth (one Inception-A/B/C block each; one
block per WiderResNet module, at the published widths).

The flax variables are seeded numpy values in the shapes of the flax init
and reach the torch modules through ``load_flax_variables``; the helpers
are ``test_torch_mobile_encoders.py``'s.  Each encoder runs in eval mode on
an odd input and in train mode on an even one of about twice the size,
where the running statistics are held to flax's within 1e-5.  A2's modules
6 and 7 drop out in training, each package with a mask of its own: there
the maps and statistics before module 6's dropout are compared.

Tolerance: 1e-4 * max|ref| (``MODEL_TOL``).
"""

import jax
import numpy as np
import pytest

from pytorch_toolbelt_tpu.zoo.encoders import inception as jinception
from pytorch_toolbelt_tpu.zoo.encoders import wide_resnet as jwide
from pytorch_toolbelt_tpu_torch import zoo
from pytorch_toolbelt_tpu_torch.zoo import load_flax_variables
from pytorch_toolbelt_tpu_torch.zoo.porting import _leaves
from test_torch_mobile_encoders import MODEL_TOL, MODES, STATS_TOL, _close, _init, _input, _run, _spec

# name: (JAX factory, port factory, kwargs, size in eval mode: odd; train mode runs at an even 128^2 or 192^2)
_ENCODERS = {
    "inception-same": (jinception.InceptionV4Encoder, zoo.InceptionV4Encoder, dict(stage_repeats=(1, 1, 1)), 66),
    "inception-torch-compat": (jinception.InceptionV4Encoder, zoo.InceptionV4Encoder,
                               dict(stage_repeats=(1, 1, 1), torch_compat=True), 99),
    "wider-resnet": (jwide.WiderResNetEncoder, zoo.WiderResNetEncoder, dict(), 66),
}


@MODES
@pytest.mark.parametrize("name", list(_ENCODERS))
def test_encoder_matches_flax(name, training):
    jfactory, tfactory, kwargs, size = _ENCODERS[name]
    jenc, tenc = jfactory(**kwargs), tfactory(**kwargs)
    assert _spec(tenc) == _spec(jenc)
    if training:
        size = 192 if kwargs.get("torch_compat") else 128
    x, tx = _input((2, size, size, 3), seed=21)
    got, want = _run(jenc, tenc, x, tx, training, seed=22)
    assert len(got) == len(want) == len(tenc.get_output_spec())
    for g, w, c in zip(got, want, tenc.get_output_spec().channels):
        assert g.shape[1] == c
        _close(g, w, MODEL_TOL)


def test_wider_resnet_a2_dilated_matches_flax():
    """Eval mode, every map taken (no dropout); A2 without dilation runs in
    eval mode in ``test_torch_torch_loader.py``."""
    jenc = jwide.WiderResNetA2Encoder(dilation=True, layers=(2, 3, 4))
    tenc = zoo.WiderResNetA2Encoder(dilation=True, layers=(2, 3, 4))
    assert _spec(tenc) == _spec(jenc)
    x, tx = _input((2, 64, 64, 3), seed=23)
    got, want = _run(jenc, tenc, x, tx, False, seed=24)
    assert len(got) == len(want) == len(tenc.get_output_spec())
    for g, w in zip(got, want):
        _close(g, w, MODEL_TOL)


def test_wider_resnet_a2_matches_flax_in_training():
    """The maps up to module 5 and the running statistics of every BatchNorm
    before module 6's dropout (the dilated A2 differs only in its convs'
    dilation and strides, which the eval-mode test covers)."""
    jenc, tenc = jwide.WiderResNetA2Encoder(), zoo.WiderResNetA2Encoder()
    x, tx = _input((2, 128, 128, 3), seed=25)
    variables = _init(jenc, x, seed=26)
    load_flax_variables(tenc, variables)
    want, new = jax.jit(lambda v, a: jenc.apply(v, a, training=True, mutable=["batch_stats"],
                                                rngs={"dropout": jax.random.PRNGKey(0)}))(variables, x)
    got = tenc.train()(tx)
    for g, w in zip(got[:5], want[:5]):
        _close(g, w, MODEL_TOL)
    checked = 0
    for collection, path, tensor, _ in _leaves(tenc, ()):
        if collection == "batch_stats" and path[0] != "mod7_block1":
            block, bn, stat = path
            np.testing.assert_allclose(tensor.detach().numpy(), np.asarray(new["batch_stats"][block][bn][stat]),
                                       rtol=STATS_TOL, atol=STATS_TOL)
            checked += 1
    assert checked == 2 * (4 * 2 + 3)  # mean and var of bn1-bn2 in modules 2-5 and bn1-bn3 in module 6
