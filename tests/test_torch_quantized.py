"""Parity of the port's int8 inference (``ops/quantized.py`` Q1 and Q2 through
their plain versions, ``zoo/quantized_unet.py`` and tiled d4 of the integer
UNet) with the JAX package, on the CPU; ``test_torch_quantized_encdec.py``
holds ``zoo/quantized_encdec.py``.

Tensors are NHWC in JAX and NCHW in the port; weights come from seeded numpy
values in the shapes of the flax init (``jax.eval_shape``), bridged to the
port's modules with ``load_flax_variables``.

Tolerances:
* the integer ops, and the whole integer forwards given the JAX package's
  calibration (its folded weights and ranges), are bit for bit: the
  constants are built by the same numpy float64 arithmetic and every integer
  op is exact; the float parts (input quantize, SE gates, the head's dequant
  and resize) happen to round alike here, and the tests demand it;
* a calibration of the port's own runs float32 convolutions of another
  library (oneDNN against XLA), so its ranges agree to 1e-5 of each layer's
  largest range; a range a rounding away moves a requant constant or a
  bias-correction step by one, and the two networks' quantization noise then
  parts: the two int8 outputs are held within 2e-2 relative RMS, and the
  port's int8 output within 0.06 relative RMS of the float32 model (the
  bound of the JAX package's own tests) and within 10% of the JAX int8
  output's own distance from it;
* tiled d4 of the integer UNet averages the views and merges the tiles in
  float32 in another order than XLA: within 1e-6 * max of JAX's, where the
  tiles' logits are bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_toolbelt_tpu.inference import tiled_apply_d4_tta as j_tiled_apply_d4_tta
from pytorch_toolbelt_tpu.zoo import UNetSegmentationModel as JUNet
from pytorch_toolbelt_tpu.zoo import quantized_unet as JQU
from pytorch_toolbelt_tpu_torch.inference import tiled_apply_d4_tta
from pytorch_toolbelt_tpu_torch.nn.simple import _same_padding
from pytorch_toolbelt_tpu_torch.ops import pack_qconv2d_weights, q_upsample, q_upsample_cat, q_upsample_cat_reference
from pytorch_toolbelt_tpu_torch.ops import q_upsample_reference, qconv2d, qconv2d_reference
from pytorch_toolbelt_tpu_torch.ops import quantized as QOPS
from pytorch_toolbelt_tpu_torch.ops.quantized import _requant, upsample_taps
from pytorch_toolbelt_tpu_torch.zoo import UNetSegmentationModel, load_flax_variables, quantize_unet_inference
from pytorch_toolbelt_tpu_torch.zoo import quantized_unet as TQU

CPU = torch.device("cpu")
SELF_CAL_RMS = 2e-2  # the port's own calibration: its int8 output against the JAX int8 output
PTQ_RMS = 0.06  # int8 against float32, as the JAX package's tests bound it


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return np.moveaxis(t.detach().numpy(), 1, -1)


def _rel_rms(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.sqrt(((got - want) ** 2).mean()) / (np.sqrt((want**2).mean()) + 1e-12))


def _seeded_variables(jmodel, x_nhwc, seed):
    """Seeded numpy values in the shapes of the flax init: LeCun-normal
    kernels, BatchNorm statistics and affine parameters near identity,
    small biases."""
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(seed), jnp.asarray(x_nhwc)))
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            return (rng.randn(*shape) * np.sqrt(1.0 / np.prod(shape[:-1]))).astype(np.float32)
        if name == "mean":
            return (0.2 * rng.randn(*shape)).astype(np.float32)
        if name == "var":
            return (0.5 + rng.rand(*shape)).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.2 * rng.randn(*shape)).astype(np.float32)
        if name == "bias":
            return (0.1 * rng.randn(*shape)).astype(np.float32)
        raise KeyError(f"no seeded value for the flax leaf {name!r}")

    return jax.tree_util.tree_map_with_path(fill, shapes)


# ---------------------------------------------------------------------------
# Q1: qconv2d against lax.conv_general_dilated(..., preferred_element_type=int32)
# ---------------------------------------------------------------------------

# (C_in, C_out, groups, kernel, stride, H, W, padding): "SAME" is flax/XLA SAME, else (top, bottom, left, right)
_QCONV_SHAPES = {
    "1x1": (16, 24, 1, 1, 1, 9, 10, "SAME"),
    "1x1_s2_even": (8, 16, 1, 1, 2, 10, 12, "SAME"),
    "3x3": (32, 32, 1, 3, 1, 12, 11, "SAME"),
    "3x3_s2_even": (16, 16, 1, 3, 2, 12, 12, "SAME"),
    "3x3_s2_odd": (16, 16, 1, 3, 2, 13, 11, "SAME"),
    "7x7_s2_stem": (3, 16, 1, 7, 2, 16, 16, (3, 3, 3, 3)),
    "c_in_3": (3, 8, 1, 3, 1, 9, 9, "SAME"),
    "c_in_4": (4, 8, 1, 3, 1, 9, 9, "SAME"),
    "groups_2": (8, 8, 2, 3, 1, 8, 8, "SAME"),
    "groups_4_s2": (16, 32, 4, 3, 2, 10, 10, "SAME"),
    "groups_4_c4": (16, 16, 4, 3, 1, 7, 7, "SAME"),
}


def _jax_epilogue(acc, epilogue, ops, relu):
    """The JAX package's integer epilogues (``_qconv_apply``, ``conv_epilogue``)."""
    if epilogue == "acc":
        return acc
    acc = acc + jnp.asarray(ops["bias"])[None, None, None, :]
    if relu:
        acc = jnp.maximum(acc, 0)
    if epilogue == "mul":
        qc = JQU._QConvMul(None, None, jnp.asarray(ops["mult"]), jnp.asarray(ops["clamp"]), None)
        return JQU._requant_mul(acc, qc)
    acc = jax.lax.shift_right_arithmetic(acc + jnp.asarray(ops["rnd"])[None, None, None, :],
                                         jnp.asarray(ops["shift"])[None, None, None, :])
    return jnp.clip(acc, -127, 127).astype(jnp.int8)


def _operands(c_out, epilogue, rng, wide=False):
    """int32 epilogue operands as numpy: biases of up to 2^20 (2^31 - 2^20 with
    ``wide``, so that acc + bias wraps), shifts 0-40, multipliers with their
    overflow clamps as ``_quantize_conv_mul`` makes them."""
    bias = rng.randint(-(1 << 20), 1 << 20, c_out).astype(np.int32)
    if wide:
        bias = np.where(np.arange(c_out) % 2, 2**31 - (1 << 20), -(2**31) + (1 << 20)).astype(np.int32)
    if epilogue == "shift":
        shift = rng.randint(0, 41, c_out).astype(np.int32)
        rnd = np.where(shift > 0, 1 << np.clip(shift - 1, 0, 30), 0).astype(np.int32)
        return dict(bias=bias, rnd=rnd, shift=shift)
    if epilogue == "mul":
        mult = rng.randint(1, 1 << 24, c_out).astype(np.int32)
        clamp = np.floor((2.0**31 - 1 - (1 << 22)) / mult).astype(np.int32)
        return dict(bias=bias, mult=mult, clamp=clamp)
    return {}


@pytest.mark.parametrize("epilogue", ["acc", "shift", "mul"])
@pytest.mark.parametrize("case", list(_QCONV_SHAPES))
def test_qconv2d_matches_jax(case, epilogue):
    c_in, c_out, groups, k, stride, h, w, padding = _QCONV_SHAPES[case]
    rng = np.random.RandomState(sum(map(ord, case)))
    x = rng.randint(-127, 128, (2, h, w, c_in)).astype(np.int8)
    w_hwio = rng.randint(-127, 128, (k, k, c_in // groups, c_out)).astype(np.int8)
    ops = _operands(c_out, epilogue, rng)
    relu = epilogue != "acc" and c_out % 2 == 0
    if padding == "SAME":
        pads = (*_same_padding(h, k, stride), *_same_padding(w, k, stride))
        j_pad = "SAME"
    else:
        pads = padding
        j_pad = ((padding[0], padding[1]), (padding[2], padding[3]))
    acc = jax.lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(w_hwio), (stride, stride), j_pad,
                                       dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=groups,
                                       preferred_element_type=jnp.int32)
    want = np.asarray(_jax_epilogue(acc, epilogue, ops, relu))
    weight = pack_qconv2d_weights(torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1))), groups)
    got = qconv2d(_nchw(x).contiguous(memory_format=torch.channels_last), weight, stride, pads, epilogue,
                  relu=relu, **{name: torch.from_numpy(v) for name, v in ops.items()})
    assert got.dtype == (torch.int32 if epilogue == "acc" else torch.int8)
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(_nhwc(got), want)


def test_packed_weights_pad_k_per_group():
    """K is (dy * kw + dx) * ci_pg + c, zero padded to 32 per group; N to the kernel's tile."""
    w = torch.arange(8 * 2 * 3 * 3, dtype=torch.int32).remainder(127).to(torch.int8).reshape(8, 2, 3, 3)
    packed = pack_qconv2d_weights(w, groups=4)
    assert packed.packed.shape == (4, 8, 32) and packed.tile_n == 8 and packed.groups == 4
    for g in range(4):
        for n in range(2):
            o = g * 2 + n
            want = w[o].permute(1, 2, 0).reshape(-1)  # (dy, dx, c)
            assert torch.equal(packed.packed[g, n, :18], want)
            assert not packed.packed[g, n, 18:].any() and not packed.packed[g, 2:].any()


@pytest.mark.parametrize("epilogue", ["shift", "mul"])
def test_epilogues_at_edge_accumulators_match_jax(epilogue):
    """Accumulators at 0, +-1, +-clamp and one step past it, and sums with
    the bias that wrap past int32; shifts of 0, 31, 32 and 40."""
    rng = np.random.RandomState(7)
    c_out = 8
    ops = _operands(c_out, epilogue, rng, wide=True)
    if epilogue == "shift":
        ops["shift"] = np.array([0, 1, 7, 23, 31, 32, 33, 40], np.int32)
        ops["rnd"] = np.where(ops["shift"] > 0, 1 << np.clip(ops["shift"] - 1, 0, 30), 0).astype(np.int32)
    edges = [0, 1, -1, 2**31 - 1, -(2**31), 2**30, -(2**30), 127, -128, 2**20 + 7]
    if epilogue == "mul":
        for c in ops["clamp"][:2]:
            edges += [int(c), -int(c), int(c) + 1, -int(c) - 1]
    acc = np.array(edges, np.int64).astype(np.int32)[None, :, None, None] * np.ones((1, 1, 1, c_out), np.int32)
    for relu in (False, True):
        want = np.asarray(_jax_epilogue(jnp.asarray(acc), epilogue, ops, relu))
        # no int8 input reaches these accumulators through a conv: hold Q1's plain epilogue itself
        t_ops = {k: torch.from_numpy(v) for k, v in ops.items()}
        got = _requant(torch.from_numpy(np.ascontiguousarray(acc.transpose(0, 3, 1, 2))), epilogue,
                       t_ops["bias"], relu, t_ops.get("rnd"), t_ops.get("shift"), t_ops.get("mult"),
                       t_ops.get("clamp"))
        np.testing.assert_array_equal(_nhwc(got), want)
    if epilogue == "mul":  # and the UNet module's _requant_mul, as the JAX package's
        dq = TQU._DeviceQConv(np.zeros((1, 1, 1, c_out), np.int8), CPU, epilogue="mul",
                              qc=TQU._QConvMul(None, ops["bias"], ops["mult"], ops["clamp"], None))
        got = TQU._requant_mul(torch.from_numpy(np.ascontiguousarray(acc.transpose(0, 3, 1, 2))), dq)
        want = JQU._requant_mul(jnp.asarray(acc), JQU._QConvMul(None, None, jnp.asarray(ops["mult"]),
                                                                 jnp.asarray(ops["clamp"]), None))
        np.testing.assert_array_equal(_nhwc(got), np.asarray(want))


def test_qconv2d_plain_version_is_exact_past_2_24():
    """A 3x3 conv over 512 channels of 127 * 127 sums to 74 million, past
    float32's 2^24: the float64 plain version still gives the exact integer."""
    x = torch.full((1, 512, 3, 3), 127, dtype=torch.int8).contiguous(memory_format=torch.channels_last)
    w = torch.full((2, 512, 3, 3), 127, dtype=torch.int8)
    w[1, 0, 0, 0] = 126
    got = qconv2d_reference(x, w)
    assert got.dtype == torch.int32 and got.flatten().tolist() == [127 * 127 * 4608, 127 * 127 * 4608 - 127]


# ---------------------------------------------------------------------------
# Q2: q_upsample against _q_upsample's two int8 einsums, q_upsample_cat against
# them and the decoder's concatenate
# ---------------------------------------------------------------------------

_Q2_CASES = [  # (C, Cs of the skip, H, W, OH, OW); the first six keep their ids from before the skip
    pytest.param(8, 16, 8, 8, 16, 16, id="8-8-8-16-16"),
    pytest.param(16, 32, 32, 32, 64, 64, id="16-32-32-64-64"),
    pytest.param(6, 2, 5, 7, 10, 13, id="6-5-7-10-13"),
    pytest.param(3, 5, 7, 7, 13, 14, id="3-7-7-13-14"),
    pytest.param(4, 4, 1, 3, 2, 6, id="4-1-3-2-6"),
    pytest.param(5, 3, 4, 4, 4, 4, id="5-4-4-4-4"),
    (256, 128, 4, 4, 8, 8),  # the int8 UNet-32's three decoder inputs at small maps
    (128, 64, 5, 6, 10, 12),
    (64, 32, 8, 8, 16, 16),
    (4, 4, 6, 5, 11, 9),  # the per-pixel routes' channel counts at odd, non-x2 sizes
    (3, 5, 3, 5, 8, 7),
]


@pytest.mark.parametrize("c,cs,h,w,oh,ow", _Q2_CASES)
def test_q_upsample_matches_jax(c, cs, h, w, oh, ow):
    mh, mw, mult = TQU._q_upsample_matrices(h, w, oh, ow)
    jmh, jmw, jmult = JQU._q_upsample_matrices(h, w, oh, ow)
    np.testing.assert_array_equal(mh, np.asarray(jmh))
    np.testing.assert_array_equal(mw, np.asarray(jmw))
    assert mult == jmult
    assert max((m != 0).sum(axis=1).max() for m in (mh, mw)) <= 2  # what Q2 relies on
    rng = np.random.RandomState(c * h * w)
    x = rng.randint(-127, 128, (2, h, w, c)).astype(np.int8)
    skip = rng.randint(-127, 128, (2, oh, ow, cs)).astype(np.int8)
    up = JQU._q_upsample(jnp.asarray(x), jmh, jmw)
    want, want_cat = np.asarray(up), np.asarray(jnp.concatenate([up, jnp.asarray(skip)], axis=-1))
    xt = _nchw(x).contiguous(memory_format=torch.channels_last)
    st = _nchw(skip).contiguous(memory_format=torch.channels_last)
    for got, ref in ((q_upsample(xt, mh, mw), want), (q_upsample_reference(xt, mh, mw), want),
                     (q_upsample_cat(xt, st, mh, mw), want_cat), (q_upsample_cat_reference(xt, st, mh, mw), want_cat)):
        assert got.dtype == torch.int8 and got.is_contiguous(memory_format=torch.channels_last)
        np.testing.assert_array_equal(_nhwc(got), ref)


_BAD_SKIPS = {  # what is wrong with a skip for x [2, 8, 4, 4] upsampled to 8 x 8
    "batch": lambda: torch.zeros(1, 4, 8, 8, dtype=torch.int8),
    "size": lambda: torch.zeros(2, 4, 8, 7, dtype=torch.int8),
    "dtype": lambda: torch.zeros(2, 4, 8, 8, dtype=torch.int16),
    "device": lambda: torch.zeros(2, 4, 8, 8, dtype=torch.int8, device="meta"),
    "memory_format": lambda: torch.zeros(2, 4, 8, 8, dtype=torch.int8).contiguous(),
}


@pytest.mark.parametrize("case", list(_BAD_SKIPS))
def test_q_upsample_cat_refuses_a_skip_that_does_not_fit(case):
    mh, mw, _ = TQU._q_upsample_matrices(4, 4, 8, 8)
    x = torch.zeros(2, 8, 4, 4, dtype=torch.int8).contiguous(memory_format=torch.channels_last)
    skip = _BAD_SKIPS[case]()
    if case != "memory_format":
        skip = skip.contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="skip must be"):
        q_upsample_cat(x, skip, mh, mw)


@pytest.mark.parametrize("c,cs,size,route,tile", [
    (256, 128, 64, "banded", (8, 16, 6, 10)),  # the int8 UNet-32's decoder inputs at config 2's 512^2 tiles
    (128, 64, 128, "banded", (8, 32, 6, 18)),
    (64, 32, 256, "banded", (8, 64, 6, 34)),
    (128, 0, 32, "banded", (8, 32, 6, 17)),  # the SEResNeXt50-FPN's x2 upsamples at 1024^2
    (48, 16, 20, "banded", (8, 40, 6, 20)),
    (3, 5, 64, "v1", None),
    (4, 4, 64, "v4", None),
    (16, 4, 64, "v4", None),
])
def test_upsample_route_rule(c, cs, size, route, tile):
    """The route rule and the banded tile, on the CPU: every main-path call on
    ``banded``; a tile is the smem-sized band x strip of ``_band_tile``."""
    mh, mw, _ = TQU._q_upsample_matrices(size, size, 2 * size, 2 * size)
    assert QOPS._upsample_route(c, cs, (0, 16 * 7, 32), mh, mw) == (route, tile)
    if route == "banded":  # 8 bytes off a 16-byte boundary: the per-pixel kernel, 4 channels a thread
        assert QOPS._upsample_route(c, cs, (0, 8), mh, mw) == ("v4", None)


def test_band_tile_shrinks_to_fit_and_hands_over_what_never_fits():
    mh, mw, _ = TQU._q_upsample_matrices(64, 64, 128, 128)
    rows, cols, rw, ww = QOPS._band_tile(4096, mh, mw)
    assert 16 + 16 * (rows + cols) + (rw + rows) * ww * 4096 <= QOPS._BAND_SMEM and cols < 8
    wide = np.zeros((8, 4096), np.int8)  # every output row reaches both ends of a 4096-wide input
    wide[:, 0] = wide[:, -1] = 1
    assert QOPS._tap_span(wide, 1) == 4096 and QOPS._band_tile(64, wide, wide) is None
    assert QOPS._upsample_route(64, 0, (0,), wide, wide) == ("v4", None)


def test_q_upsample_refuses_a_row_of_three_taps():
    m = np.zeros((4, 4), np.int8)
    m[:, 0] = 127
    m[1, 1:3] = 1
    x = torch.zeros(1, 4, 4, 4, dtype=torch.int8).contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="3 nonzero taps"):
        upsample_taps(m, CPU)
    with pytest.raises(ValueError, match="do not fit"):
        q_upsample(x, m[:, :3], m)


def test_upsample_matrices_and_taps_are_made_once_per_shape():
    mh, mw, _ = TQU._q_upsample_matrices(5, 7, 10, 13)
    assert TQU._q_upsample_matrices(5, 7, 10, 13)[0] is mh and not mh.flags.writeable
    assert TQU._q_upsample_taps(5, 7, 10, 13, CPU) is TQU._q_upsample_taps(5, 7, 10, 13, CPU)
    for m, taps in zip((mh, mw), TQU._q_upsample_taps(5, 7, 10, 13, CPU)):
        assert taps.dtype == torch.int32 and taps.shape == (m.shape[0], 4)
        dense = np.zeros(m.shape, np.int32)
        for o, (i0, i1, m0, m1) in enumerate(taps.tolist()):
            dense[o, i0] += m0
            dense[o, i1] += m1
        np.testing.assert_array_equal(dense, m)


def test_linear_weights_match_jax():
    from pytorch_toolbelt_tpu.nn.functional import _linear_weights as j_linear_weights
    from pytorch_toolbelt_tpu_torch.nn.functional import _linear_weights

    for args in [(5, 10, True), (7, 13, False), (1, 4, True), (8, 8, True), (64, 128, True), (9, 4, False)]:
        np.testing.assert_array_equal(_linear_weights(*args, np.float64), j_linear_weights(*args, np.float64))


# ---------------------------------------------------------------------------
# The integer UNet
# ---------------------------------------------------------------------------

_UNETS = {  # (encoder_channels, num_layers, num_classes, output_name, size)
    "unet32_l3": (32, 3, 1, None, 64),
    "unet16_l3_named": (16, 3, 3, "mask", 64),
}


@pytest.fixture(scope="module", params=list(_UNETS))
def unet_case(request):
    channels, layers, classes, name, size = _UNETS[request.param]
    jmodel = JUNet(num_classes=classes, encoder_channels=channels, num_layers=layers, output_name=name)
    rng = np.random.RandomState(3)
    cal = rng.rand(2, size, size, 3).astype(np.float32)
    x = rng.rand(2, size, size, 3).astype(np.float32)
    variables = _seeded_variables(jmodel, cal, seed=4)
    tmodel = load_flax_variables(UNetSegmentationModel(num_classes=classes, encoder_channels=channels,
                                                       num_layers=layers, output_name=name), variables).eval()
    j_cal = JQU._calibrate_unet(jmodel, variables, jnp.asarray(cal), 1.0)
    j_forward = JQU.quantize_unet_inference(jmodel, variables, jnp.asarray(cal))
    return dict(jmodel=jmodel, variables=variables, tmodel=tmodel, cal=cal, x=x, j_cal=j_cal,
                j_forward=j_forward, want=j_forward(jnp.asarray(x)), name=name, classes=classes)


def _out(y, name):
    return y[name] if name is not None else y


def test_int8_unet_given_the_jax_calibration_is_bit_exact(unet_case):
    c = unet_case
    forward = TQU._build_int8_unet(TQU._UNetCalibration(*c["j_cal"]), 3, c["name"], CPU)
    got = _out(forward(_nchw(c["x"])), c["name"])
    assert got.dtype == torch.float32 and got.shape == (2, c["classes"], *c["x"].shape[1:3])
    np.testing.assert_array_equal(_nhwc(got), np.asarray(_out(c["want"], c["name"])))


def test_int8_unet_calibration_matches_jax(unet_case):
    c = unet_case
    t_cal = TQU._calibrate_unet(c["tmodel"], _nchw(c["cal"]), 1.0)
    j_cal = TQU._UNetCalibration(*c["j_cal"])
    assert set(t_cal.amax) == set(j_cal.amax)
    for key, want in j_cal.amax.items():
        np.testing.assert_allclose(t_cal.amax[key], want, rtol=1e-5, atol=1e-5 * want.max())
    assert t_cal.input_amax == pytest.approx(j_cal.input_amax, rel=1e-7)
    for got_level, want_level in zip(t_cal.enc + t_cal.dec, j_cal.enc + j_cal.dec):
        for (w, b), (jw, jb) in zip(got_level, want_level):  # the BN fold: float32 in both packages
            np.testing.assert_allclose(w, jw, rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(b, jb, rtol=1e-6, atol=1e-7)


def test_int8_unet_own_calibration_matches_jax_and_the_float_model(unet_case):
    c = unet_case
    forward = quantize_unet_inference(c["tmodel"], _nchw(c["cal"]))
    got = _out(forward(_nchw(c["x"])), c["name"])
    assert _rel_rms(_nhwc(got), _out(c["want"], c["name"])) <= SELF_CAL_RMS
    with torch.no_grad():
        ref = _out(c["tmodel"](_nchw(c["x"])), c["name"])
    assert _rel_rms(got, ref) < PTQ_RMS
    assert torch.equal(_out(forward(_nchw(c["x"])), c["name"]), got)  # integer math: deterministic


def test_int8_unet_inference_size_decoupled_from_calibration(unet_case):
    c = unet_case
    forward = TQU._build_int8_unet(TQU._UNetCalibration(*c["j_cal"]), 3, c["name"], CPU)
    x = np.random.RandomState(5).rand(1, 32, 96, 3).astype(np.float32)
    got = _out(forward(_nchw(x)), c["name"])
    np.testing.assert_array_equal(_nhwc(got), np.asarray(_out(c["j_forward"](jnp.asarray(x)), c["name"])))


def test_int8_unet_rejects_unsupported():
    with pytest.raises(NotImplementedError):
        quantize_unet_inference(UNetSegmentationModel(num_classes=1, encoder_channels=8, num_layers=2,
                                                      activation="silu"), torch.zeros(1, 3, 16, 16))


def test_tiled_d4_of_the_int8_unet_matches_jax():
    """The slice as a whole: tiled d4 (distributed) of the integer UNet-32 (2
    levels) on a 256^2 image at tile 128, step 64, with the JAX package's
    calibration."""
    jmodel = JUNet(num_classes=1, encoder_channels=32, num_layers=2)
    rng = np.random.RandomState(8)
    image = rng.rand(256, 256, 3).astype(np.float32)
    cal = np.stack([image[:128, :128], image[:128, 128:], image[128:, :128], image[128:, 128:]])
    variables = _seeded_variables(jmodel, cal, seed=9)
    j_forward = JQU.quantize_unet_inference(jmodel, variables, jnp.asarray(cal))
    forward = TQU._build_int8_unet(TQU._UNetCalibration(*JQU._calibrate_unet(jmodel, variables, jnp.asarray(cal), 1.0)),
                                   3, None, CPU)
    want = np.asarray(j_tiled_apply_d4_tta(j_forward, jnp.asarray(image), tile_size=128, tile_step=64,
                                           weight="pyramid", batch_size=8, mode="distributed"))
    got = tiled_apply_d4_tta(forward, _nchw(image[None])[0], 128, 64, weight="pyramid", batch_size=8,
                             mode="distributed")
    assert got.shape == (1, 256, 256) and got.dtype == torch.float32
    np.testing.assert_allclose(np.moveaxis(got.numpy(), 0, -1), want, rtol=0, atol=1e-6 * np.abs(want).max())
