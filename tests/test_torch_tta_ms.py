"""Parity of the port's multiscale test-time augmentation with the JAX
package, on the CPU: ``ms_image_augment`` / ``ms_image_deaugment`` and the
label pair, ``MultiscaleTTA`` over ``d4_image2mask``, and the whole config-3
pipeline (SEResNeXt50-FPN(128), 19 classes, d4 + multiscale) at 64^2.

The JAX resize is two interpolation-matrix products at HIGHEST precision and
torch's is a two-point lerp: both are fp32, and they agree to ~1e-7
relative, so the transforms are held to 1e-5 * max|ref|.  The models add
their convolutions' rounding differences on top (1e-5 for a small UNet,
1e-4 * max|ref| for the 50-layer config-3 model, as in
``test_torch_senet_fpn.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_toolbelt_tpu.inference import tta as jtta
from pytorch_toolbelt_tpu.zoo import EncoderDecoderModel as JEncoderDecoderModel
from pytorch_toolbelt_tpu.zoo import FPNDecoder as JFPNDecoder
from pytorch_toolbelt_tpu.zoo import ResizeHead as JResizeHead
from pytorch_toolbelt_tpu.zoo import UNetSegmentationModel as JUNet
from pytorch_toolbelt_tpu.zoo.encoders.senet import se_resnext50_encoder as j_se_resnext50_encoder
from pytorch_toolbelt_tpu_torch.inference import (
    MultiscaleTTA,
    d4_image2mask,
    ms_image_augment,
    ms_image_deaugment,
    ms_labels_augment,
    ms_labels_deaugment,
)
from pytorch_toolbelt_tpu_torch.zoo import EncoderDecoderModel, FPNDecoder, ResizeHead, UNetSegmentationModel
from pytorch_toolbelt_tpu_torch.zoo import load_flax_variables, se_resnext50_encoder

TOL = 1e-5
MODEL_TOL = 1e-4


def _nchw(x_nhwc: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x_nhwc.transpose(0, 3, 1, 2)))


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def _close(got: torch.Tensor, want, tol=TOL):
    want = np.asarray(want)
    got = _nhwc(got)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


_OFFSETS = [[0, 16], [0, -8], [(8, -4), 0, -16], [(-6, 10)]]


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("offsets", _OFFSETS, ids=str)
def test_ms_image_augment_matches_jax(offsets, align_corners):
    x = np.random.RandomState(1).rand(2, 32, 40, 3).astype(np.float32)
    want = jtta.ms_image_augment(jnp.asarray(x), offsets, align_corners=align_corners)
    got = ms_image_augment(_nchw(x), offsets, align_corners=align_corners)
    assert len(got) == len(want) == len(offsets)
    for g, w, offset in zip(got, want, offsets):
        _close(g, w)
        if offset == 0:
            assert g is not None and torch.equal(g, _nchw(x))


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("offsets", _OFFSETS, ids=str)
def test_ms_image_deaugment_matches_jax(offsets, stride):
    """Outputs of each scale at ``stride``, resized back to 32/stride x
    40/stride and averaged; the default align_corners=True differs from
    augment's False, as in JAX."""
    rng = np.random.RandomState(2)
    maps = []
    for offset in offsets:
        r_off, c_off = offset if isinstance(offset, tuple) else (offset, offset)
        maps.append(rng.randn(2, 32 // stride + r_off // stride, 40 // stride + c_off // stride, 5).astype(np.float32))
    want = jtta.ms_image_deaugment([jnp.asarray(m) for m in maps], offsets, stride=stride)
    got = ms_image_deaugment([_nchw(m) for m in maps], offsets, stride=stride)
    assert tuple(got.shape) == (2, 5, 32 // stride, 40 // stride)
    _close(got, want)


@pytest.mark.parametrize("reduction", ["mean", "sum", "gmean"])
def test_ms_labels_roundtrip_matches_jax(reduction):
    logits = np.random.RandomState(3).rand(4, 7).astype(np.float32) + 0.1
    offsets = [0, -8, 16]
    assert len(ms_labels_augment(torch.from_numpy(logits), offsets)) == 3
    want = jtta.ms_labels_deaugment([jnp.asarray(logits * (i + 1)) for i in range(3)], offsets, reduction)
    got = ms_labels_deaugment([torch.from_numpy(logits * (i + 1)) for i in range(3)], offsets, reduction)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL)
    with pytest.raises(ValueError):
        ms_labels_deaugment([torch.from_numpy(logits)], offsets)
    with pytest.raises(ValueError):
        ms_image_deaugment([torch.zeros(1, 1, 4, 4)], offsets)


def _bridged_unet():
    jmodel = JUNet(num_classes=2, encoder_channels=8, num_layers=3)
    variables = jax.tree_util.tree_map(
        lambda a: np.asarray(a, dtype=np.float32), jmodel.init(jax.random.PRNGKey(4), jnp.zeros((1, 32, 32, 3))))
    tmodel = load_flax_variables(UNetSegmentationModel(num_classes=2, encoder_channels=8, num_layers=3), variables)
    return lambda x: jmodel.apply(variables, x), tmodel.eval()


def test_multiscale_tta_over_d4_matches_jax():
    j_model, t_model = _bridged_unet()
    x = np.random.RandomState(5).rand(2, 32, 32, 3).astype(np.float32)
    want = jtta.MultiscaleTTA(lambda xi: jtta.d4_image2mask(j_model, xi), size_offsets=[0, -8, 16])(jnp.asarray(x))
    with torch.no_grad():
        got = MultiscaleTTA(lambda xi: d4_image2mask(t_model, xi), size_offsets=[0, -8, 16])(_nchw(x))
    assert tuple(got.shape) == (2, 2, 32, 32)
    _close(got, want)


def test_multiscale_tta_dict_outputs():
    _, t_model = _bridged_unet()
    x = torch.rand(1, 3, 32, 32)
    tta = MultiscaleTTA(lambda xi: {"mask": t_model(xi)}, size_offsets=[0, -8],
                        deaugment_fn={"mask": ms_image_deaugment})
    with torch.no_grad():
        got = tta(x)
        want = MultiscaleTTA(t_model, size_offsets=[0, -8])(x)
    assert set(got) == {"mask"} and torch.equal(got["mask"], want)


def test_config3_pipeline_matches_jax():
    """BASELINE config 3 at 64^2: d4 inside a two-scale MultiscaleTTA over
    SEResNeXt50-FPN(128) with 19 classes, fp32."""
    jencoder = j_se_resnext50_encoder()
    jdecoder = JFPNDecoder(input_spec=jencoder.get_output_spec(), out_channels=128)
    jmodel = JEncoderDecoderModel(encoder=jencoder, decoder=jdecoder,
                                  head=JResizeHead(input_spec=jdecoder.get_output_spec(), num_classes=19))
    variables = jax.tree_util.tree_map(
        lambda a: np.asarray(a, dtype=np.float32), jmodel.init(jax.random.PRNGKey(6), jnp.zeros((1, 64, 64, 3))))
    encoder = se_resnext50_encoder()
    decoder = FPNDecoder(encoder.get_output_spec(), out_channels=128)
    tmodel = EncoderDecoderModel(encoder, decoder, ResizeHead(decoder.get_output_spec(), num_classes=19))
    load_flax_variables(tmodel, variables).eval()

    x = np.random.RandomState(7).rand(1, 64, 64, 3).astype(np.float32)
    want = jtta.MultiscaleTTA(lambda xi: jtta.d4_image2mask(lambda v: jmodel.apply(variables, v), xi),
                              size_offsets=[0, -32])(jnp.asarray(x))
    with torch.no_grad():
        got = MultiscaleTTA(lambda xi: d4_image2mask(tmodel, xi), size_offsets=[0, -32])(_nchw(x))
    assert tuple(got.shape) == (1, 19, 64, 64) and got.dtype == torch.float32
    _close(got, want, MODEL_TOL)
