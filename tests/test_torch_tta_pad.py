"""Parity of the port's TTA transforms and wrappers (the crop, flip, d2, d4
label families, ``GeneralizedTTA``, ``TTAWrapper``) and the pad helpers with
the JAX package, on the CPU.

The same seeded numpy inputs go through both packages; tensors are NHWC in
JAX and NCHW in the port.  Transforms and pads only move values, so they
are held bit for bit.  A reduction over three or more views adds them in
another order in XLA (1 ulp apart), so reductions and the pipelines through
a model are held to 1e-5 * max|ref|, and to 1e-4 * max|ref| through the
residual UNet, whose convolutions' rounding differences grow through the
layers, as ``test_torch_senet_fpn.py`` argues.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_toolbelt_tpu.inference import functional as JF
from pytorch_toolbelt_tpu.inference import tta as JT
from pytorch_toolbelt_tpu.zoo import EncoderDecoderModel as JEncoderDecoderModel
from pytorch_toolbelt_tpu.zoo import ResizeHead as JResizeHead
from pytorch_toolbelt_tpu.zoo import UNetDecoder as JUNetDecoder
from pytorch_toolbelt_tpu.zoo import UnetEncoder as JUnetEncoder
from pytorch_toolbelt_tpu_torch.inference import functional as TF
from pytorch_toolbelt_tpu_torch.inference import tta as TT
from pytorch_toolbelt_tpu_torch.zoo import EncoderDecoderModel, ResizeHead, UNetDecoder, UnetEncoder
from pytorch_toolbelt_tpu_torch.zoo import load_flax_variables

TOL = 1e-5
MODEL_TOL = 1e-4


def _nchw(x_nhwc) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x_nhwc).transpose(0, 3, 1, 2)))


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def _image(shape_nhwc, seed):
    return np.random.RandomState(seed).uniform(0.05, 0.95, shape_nhwc).astype(np.float32)


def _equal(got: torch.Tensor, want):
    np.testing.assert_array_equal(_nhwc(got), np.asarray(want))


def _close(got: torch.Tensor, want, tol=TOL):
    want = np.asarray(want)
    got = _nhwc(got)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


# ---------------------------------------------------------------------------
# Image transforms and their inverses: bit for bit
# ---------------------------------------------------------------------------

_AUGMENTS = ["fliplr_image_augment", "flipud_image_augment", "flips_image_augment", "d2_image_augment",
             "d4_image_augment", "fliplr_labels_augment", "flips_labels_augment", "d2_labels_augment",
             "d4_labels_augment"]


@pytest.mark.parametrize("name", _AUGMENTS)
def test_augment_is_bit_equal(name):
    x = _image((2, 6, 6, 3), seed=1)
    _equal(getattr(TT, name)(_nchw(x)), getattr(JT, name)(jnp.asarray(x)))


# (deaugment, number of views)
_DEAUGMENTS = [("fliplr_image_deaugment", 2), ("flipud_image_deaugment", 2), ("flips_image_deaugment", 3),
               ("d2_image_deaugment", 4), ("d4_image_deaugment", 8), ("fliplr_labels_deaugment", 2),
               ("flipud_labels_deaugment", 2), ("flips_labels_deaugment", 3), ("d2_labels_deaugment", 4),
               ("d4_labels_deaugment", 8), ("fivecrop_label_deaugment", 5)]


@pytest.mark.parametrize("name,views", _DEAUGMENTS, ids=[d[0] for d in _DEAUGMENTS])
def test_deaugment_is_bit_equal(name, views):
    """The views brought back, unreduced: [views, B, ...]."""
    y = _image((2 * views, 6, 6, 3), seed=2)
    got = getattr(TT, name)(_nchw(y), reduction=None).flatten(0, 1)
    _equal(got, np.asarray(getattr(JT, name)(jnp.asarray(y), reduction=None)).reshape(-1, 6, 6, 3))


@pytest.mark.parametrize("reduction", ["mean", "sum"])
@pytest.mark.parametrize("name,views", _DEAUGMENTS, ids=[d[0] for d in _DEAUGMENTS])
def test_deaugment_reduction_matches_jax(name, views, reduction):
    y = _image((2 * views, 6, 6, 3), seed=2)
    _close(getattr(TT, name)(_nchw(y), reduction=reduction), getattr(JT, name)(jnp.asarray(y), reduction=reduction))


@pytest.mark.parametrize("reduction", ["gmean", "hmean", "harmonic1p", "logodd", "log1p"])
def test_deaugment_means_match(reduction):
    y = _image((8, 6, 6, 2), seed=3)
    _close(TT.d2_image_deaugment(_nchw(y), reduction=reduction),
           JT.d2_image_deaugment(jnp.asarray(y), reduction=reduction))


@pytest.mark.parametrize("crop", [(4, 4), (3, 5), (6, 7)])
def test_fivecrop_augment_is_bit_equal(crop):
    x = _image((2, 6, 7, 3), seed=4)
    _equal(TT.fivecrop_image_augment(_nchw(x), crop), JT.fivecrop_image_augment(jnp.asarray(x), crop))


def test_fivecrop_refuses_a_crop_larger_than_the_image():
    for crop in ((7, 4), (4, 8)):
        with pytest.raises(ValueError):
            TT.fivecrop_image_augment(torch.zeros(1, 3, 6, 7), crop)
    with pytest.raises(RuntimeError):
        TT.split_into_chunks(torch.zeros(5, 1), 2)


# ---------------------------------------------------------------------------
# The model-wrapping functions and wrappers
# ---------------------------------------------------------------------------


def _pixel_models():
    """An elementwise, position-dependent model in both layouts."""
    ramp = _image((1, 6, 6, 1), seed=5)
    return (lambda x: x * jnp.asarray(ramp) + 1.0), (lambda x: x * _nchw(ramp) + 1.0)


def _label_models():
    """A classifier: per-channel means, [B, H, W, C] -> [B, C]."""
    return (lambda x: x.mean(axis=(1, 2))), (lambda x: x.mean(dim=(2, 3)))


@pytest.mark.parametrize("name", ["fliplr_image2mask", "d4_image2mask"])
def test_image2mask_matches_jax(name):
    x = _image((2, 6, 6, 3), seed=6)
    jmodel, tmodel = _pixel_models()
    _close(getattr(TT, name)(tmodel, _nchw(x)), getattr(JT, name)(jmodel, jnp.asarray(x)))


@pytest.mark.parametrize("name,args", [("fliplr_image2label", ()), ("d4_image2label", ()),
                                       ("fivecrop_image2label", ((4, 3),)), ("tencrop_image2label", ((4, 3),))])
def test_image2label_matches_jax(name, args):
    x = _image((2, 6, 6, 3), seed=7)
    jmodel, tmodel = _label_models()
    want = np.asarray(getattr(JT, name)(jmodel, jnp.asarray(x), *args))
    got = getattr(TT, name)(tmodel, _nchw(x), *args).numpy()
    assert got.shape == want.shape == (2, 3)
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


def test_generalized_tta_callable_form_matches_jax():
    x = _image((2, 6, 6, 3), seed=8)
    jmodel, tmodel = _pixel_models()
    want = JT.GeneralizedTTA(jmodel, JT.d2_image_augment, JT.d2_image_deaugment)(jnp.asarray(x))
    _close(TT.GeneralizedTTA(tmodel, TT.d2_image_augment, TT.d2_image_deaugment)(_nchw(x)), want)
    with pytest.raises(ValueError):
        TT.GeneralizedTTA(tmodel, TT.d2_image_augment, TT.d2_image_deaugment)(_nchw(x), _nchw(x))


def test_generalized_tta_dict_form_matches_jax():
    x, y = _image((2, 6, 6, 3), seed=9), _image((2, 6, 6, 1), seed=10)
    jtta = JT.GeneralizedTTA(
        lambda image, mask: {"mask": image * mask, "label": image.mean(axis=(1, 2))},
        {"image": JT.fliplr_image_augment, "mask": JT.fliplr_image_augment},
        {"mask": JT.fliplr_image_deaugment, "label": JT.fliplr_labels_deaugment},
    )
    ttta = TT.GeneralizedTTA(
        lambda image, mask: {"mask": image * mask, "label": image.mean(dim=(2, 3))},
        {"image": TT.fliplr_image_augment, "mask": TT.fliplr_image_augment},
        {"mask": TT.fliplr_image_deaugment, "label": TT.fliplr_labels_deaugment},
    )
    want = jtta(image=jnp.asarray(x), mask=jnp.asarray(y))
    got = ttta(image=_nchw(x), mask=_nchw(y))
    assert set(got) == {"mask", "label"}
    _close(got["mask"], want["mask"])
    np.testing.assert_allclose(got["label"].numpy(), np.asarray(want["label"]), rtol=TOL)
    with pytest.raises(ValueError):
        ttta(_nchw(x))


def test_generalized_tta_list_form_matches_jax():
    x, y = _image((2, 6, 6, 3), seed=11), _image((2, 6, 6, 3), seed=12)
    want = JT.GeneralizedTTA(lambda a, b: (a + b, a * b), [JT.flips_image_augment] * 2,
                             [JT.flips_image_deaugment] * 2)(jnp.asarray(x), jnp.asarray(y))
    got = TT.GeneralizedTTA(lambda a, b: (a + b, a * b), [TT.flips_image_augment] * 2,
                            [TT.flips_image_deaugment] * 2)(_nchw(x), _nchw(y))
    assert len(got) == 2
    for g, w in zip(got, want):
        _close(g, w)
    with pytest.raises(ValueError):
        TT.GeneralizedTTA(lambda a: a, [TT.flips_image_augment], TT.flips_image_deaugment)(_nchw(x), k=1)


def test_tta_wrapper_is_deprecated_and_matches_jax():
    x = _image((2, 6, 6, 3), seed=13)
    jmodel, tmodel = _pixel_models()
    with pytest.warns(DeprecationWarning):
        wrapper = TT.TTAWrapper(tmodel, TT.d4_image2mask)
    with pytest.warns(DeprecationWarning):
        want = JT.TTAWrapper(jmodel, JT.d4_image2mask)(jnp.asarray(x))
    _close(wrapper(_nchw(x)), want)


def test_multiscale_tta_in_bicubic_mode_matches_jax():
    x = _image((1, 24, 24, 3), seed=14)
    jms = JT.MultiscaleTTA(lambda v: v * 2.0 - 1.0, [0, 8, -6], mode="bicubic")
    tms = TT.MultiscaleTTA(lambda v: v * 2.0 - 1.0, [0, 8, -6], mode="bicubic")
    _close(tms(_nchw(x)), jms(jnp.asarray(x)))


# ---------------------------------------------------------------------------
# Pad helpers: bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode,value", [("constant", 0.0), ("constant", -1.5), ("reflect", 0), ("replicate", 0)])
@pytest.mark.parametrize("size", [(9, 8), (6, 11), (7, 7)])
def test_pad_tensor_to_size_is_bit_equal(mode, value, size):
    x = _image((2, 5, 6, 3), seed=15)
    want, want_crop = JF.pad_tensor_to_size(jnp.asarray(x), size, mode=mode, value=value)
    got, crop = TF.pad_tensor_to_size(_nchw(x), size, mode=mode, value=value)
    _equal(got, want)
    assert crop[2:] == want_crop[1:-1]
    assert torch.equal(got[crop], _nchw(x))


@pytest.mark.parametrize("spatial", [(7,), (5, 6, 4)])
def test_pad_tensor_to_size_in_1d_and_3d_is_bit_equal(spatial):
    x = np.random.RandomState(16).rand(2, *spatial, 3).astype(np.float32)
    size = tuple(s + 3 for s in spatial)
    want, _ = JF.pad_tensor_to_size(jnp.asarray(x), size, mode="replicate")
    got, crop = TF.pad_tensor_to_size(torch.from_numpy(np.moveaxis(x, -1, 1).copy()), size, mode="replicate")
    np.testing.assert_array_equal(np.moveaxis(got.numpy(), 1, -1), np.asarray(want))
    with pytest.raises(ValueError):
        TF.pad_tensor_to_size(got, size + (9,))
    with pytest.raises(KeyError):
        TF.pad_tensor_to_size(got, size, mode="circular")


@pytest.mark.parametrize("shape,pad_size", [((13, 17), 32), ((64, 96), 32), ((100, 70), 32), ((33, 50), (8, 16)),
                                            ((31, 65), 16)])
def test_pad_image_tensor_and_unpad_are_bit_equal(shape, pad_size):
    x = _image((2,) + shape + (3,), seed=17)
    want, want_pad = JF.pad_image_tensor(jnp.asarray(x), pad_size)
    got, pad = TF.pad_image_tensor(_nchw(x), pad_size)
    assert pad == tuple(want_pad)
    _equal(got, want)
    _equal(TF.unpad_image_tensor(got, pad), JF.unpad_image_tensor(want, want_pad))
    assert torch.equal(TF.unpad_image_tensor(got, pad), _nchw(x))


def test_pad_image_tensor_needs_rank_4():
    with pytest.raises(ValueError):
        TF.pad_image_tensor(torch.zeros(3, 8, 8))
    with pytest.raises(ValueError):
        TF.unpad_image_tensor(torch.zeros(3, 8, 8), (0, 0, 0, 0))


@pytest.mark.parametrize("dim", [-1, 0])
def test_unpad_xyxy_bboxes_is_bit_equal(dim):
    boxes = np.random.RandomState(18).uniform(0, 100, (4, 5) if dim == 0 else (5, 4)).astype(np.float32)
    pad = (3, 4, 7, 1)
    want = JF.unpad_xyxy_bboxes(jnp.asarray(boxes), pad, dim=dim)
    np.testing.assert_array_equal(TF.unpad_xyxy_bboxes(torch.from_numpy(boxes), pad, dim=dim).numpy(),
                                  np.asarray(want))


# ---------------------------------------------------------------------------
# The recipe: pad -> d2 TTA -> unpad through a residual UNet
# ---------------------------------------------------------------------------


def test_pad_d2_tta_unpad_through_a_residual_unet_matches_jax():
    jencoder = JUnetEncoder(out_channels=8, num_layers=3, residual=True)
    jdecoder = JUNetDecoder(input_spec=jencoder.get_output_spec(), out_channels=(8, 16), block_type="unet_residual",
                            upsample_block="deconv")
    jmodel = JEncoderDecoderModel(encoder=jencoder, decoder=jdecoder,
                                  head=JResizeHead(input_spec=jdecoder.get_output_spec(), num_classes=3))
    encoder = UnetEncoder(out_channels=8, num_layers=3, residual=True)
    decoder = UNetDecoder(encoder.get_output_spec(), (8, 16), block_type="unet_residual", upsample_block="deconv")
    tmodel = EncoderDecoderModel(encoder, decoder, ResizeHead(decoder.get_output_spec(), num_classes=3)).eval()
    variables = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(19), jnp.zeros((1, 16, 16, 3))))
    load_flax_variables(tmodel, variables)

    x = _image((1, 21, 26, 3), seed=19)
    jpadded, jpad = JF.pad_image_tensor(jnp.asarray(x), 16)
    want = JF.unpad_image_tensor(
        JT.GeneralizedTTA(lambda v: jmodel.apply(variables, v), JT.d2_image_augment, JT.d2_image_deaugment)(jpadded),
        jpad)
    padded, pad = TF.pad_image_tensor(_nchw(x), 16)
    with torch.no_grad():
        got = TF.unpad_image_tensor(TT.GeneralizedTTA(tmodel, TT.d2_image_augment, TT.d2_image_deaugment)(padded), pad)
    assert tuple(padded.shape[2:]) == (32, 32) and tuple(got.shape) == (1, 3, 21, 26)
    _close(got, want, MODEL_TOL)
